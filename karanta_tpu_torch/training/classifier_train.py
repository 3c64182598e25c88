"""Image-classification trainer, document type / article segmentation (port
of ``karanta_tpu/training/classifier_train.py``).

The JAX trainer's flow (reference karanta/training/
run_image_classification.py:50-327): imagefolder or mixed dataset loading,
a seeded train/eval split, label maps, augmentation (random rotation +
affine jitter), a cosine schedule with linear warmup, AdamW (optax.adamw's
arithmetic: every leaf decays), integer-label softmax cross entropy,
checkpoints with ``resume_from_checkpoint: auto``, and the held-out
accuracy. Archs: vit, segformer (mit-b0), convnextv2, resnet, and their
``-tiny`` presets; float32 throughout, on the card unless ``--device cpu``.

Usage: python -m karanta_tpu_torch.training.classifier_train <cfg.yaml>
[--key value ...]
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from karanta_tpu_torch.inference.image_classifier import norm_stats

logger = logging.getLogger("karanta_tpu_torch.classifier_train")


@dataclasses.dataclass
class ClassifierArguments:
    dataset_dir: str = ""                # imagefolder: <dir>/<label>/*.png
    dataset_mix: Optional[List[str]] = None  # "dir:fraction" entries
    output_dir: str = "runs/classifier"
    # architecture: vit | segformer (mit-b0, the reference's production
    # arch) | convnextv2 | resnet, or one of the last three with "-tiny"
    # (small presets for dummy/integration configs)
    arch: str = "vit"
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    batch_size: int = 32
    num_epochs: int = 3
    max_steps: int = -1
    eval_fraction: float = 0.1
    warmup_steps: int = 20
    logging_steps: int = 10
    checkpointing_steps: int = 200
    seed: int = 42
    augment: bool = True
    resume_from_checkpoint: Optional[str] = None
    device: Optional[str] = None         # the card unless "cpu"


IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def load_imagefolder(root: str) -> tuple[list[str], list[int], list[str]]:
    """(paths, label_ids, label_names) from <root>/<label>/*.ext."""
    root_path = Path(root)
    labels = sorted(d.name for d in root_path.iterdir() if d.is_dir())
    paths, ids = [], []
    for label_id, label in enumerate(labels):
        for p in sorted((root_path / label).iterdir()):
            if p.suffix.lower() in IMG_EXTS:
                paths.append(str(p))
                ids.append(label_id)
    return paths, ids, labels


def prepare_mixed_datasets(mix_specs: list[str]
                           ) -> tuple[list[str], list[int], list[str]]:
    """Combine imagefolders with per-source fractions/counts:
    "dir:0.5" (fraction) or "dir:100" (count) or "dir"
    (reference karanta/data/utils.py:28-111)."""
    all_paths: list[str] = []
    all_ids: list[int] = []
    label_names: list[str] = []
    label_map: dict[str, int] = {}
    rng = np.random.default_rng(0)
    for spec in mix_specs:
        if ":" in spec:
            directory, amount = spec.rsplit(":", 1)
            amount = float(amount)
        else:
            directory, amount = spec, 1.0
        paths, ids, labels = load_imagefolder(directory)
        for label in labels:
            if label not in label_map:
                label_map[label] = len(label_names)
                label_names.append(label)
        remap = {i: label_map[label] for i, label in enumerate(labels)}
        n = len(paths)
        take = int(n * amount) if amount <= 1.0 else min(int(amount), n)
        sel = rng.permutation(n)[:take]
        all_paths.extend(paths[i] for i in sel)
        all_ids.extend(remap[ids[i]] for i in sel)
    return all_paths, all_ids, label_names


def _augment(pil, rng: np.random.Generator):
    """Random rotation (±15°) + translate/scale jitter
    (reference run_image_classification.py:235-250)."""
    from PIL import Image

    angle = float(rng.uniform(-15, 15))
    pil = pil.rotate(angle, resample=Image.Resampling.BILINEAR,
                     fillcolor=(255, 255, 255))
    scale = float(rng.uniform(0.9, 1.1))
    w, h = pil.size
    pil = pil.resize((max(1, int(w * scale)), max(1, int(h * scale))),
                     Image.Resampling.BILINEAR)
    dx, dy = rng.integers(-int(0.1 * w), int(0.1 * w) + 1, 2)
    canvas = Image.new("RGB", (w, h), (255, 255, 255))
    canvas.paste(pil, (int(dx), int(dy)))
    return canvas


def _load_batch(paths: list[str], size: int, rng=None,
                arch: str = "vit") -> np.ndarray:
    from PIL import Image

    # the normalisation inference uses for the arch (LayoutClassifier)
    mean, std = norm_stats(arch)
    out = np.zeros((len(paths), size, size, 3), np.float32)
    for i, path in enumerate(paths):
        pil = Image.open(path).convert("RGB")
        if rng is not None:
            pil = _augment(pil, rng)
        pil = pil.resize((size, size), Image.Resampling.BILINEAR)
        out[i] = (np.asarray(pil, np.float32) / 255.0 - mean) / std
    return out


def build_model(args: ClassifierArguments, labels: list[str]):
    """(cfg, init_fn, forward_fn) for args.arch, sized by args."""
    from karanta_tpu_torch.models.classifier.convert import get_arch
    from karanta_tpu_torch.models.classifier.vit import ViTConfig

    if args.arch == "vit":
        cfg = ViTConfig(image_size=args.image_size, patch_size=args.patch_size,
                        hidden_size=args.hidden_size,
                        num_layers=args.num_layers, num_heads=args.num_heads,
                        intermediate_size=args.intermediate_size,
                        num_classes=len(labels), labels=tuple(labels))
        spec = get_arch("vit")
        return cfg, spec.init, spec.forward
    name, tiny = (args.arch[:-len("-tiny")], True) \
        if args.arch.endswith("-tiny") else (args.arch, False)
    if name not in ("segformer", "convnextv2", "resnet"):
        raise ValueError(f"unknown arch {args.arch!r}")
    spec = get_arch(name)
    base = (spec.tiny(len(labels)) if tiny
            else spec.config(num_classes=len(labels)))
    cfg = dataclasses.replace(base, image_size=args.image_size,
                              labels=tuple(labels))
    return cfg, spec.init, spec.forward


def classifier_loss(forward: Callable, cfg: Any):
    """(params, images, label_ids) -> (mean integer-label softmax cross
    entropy, logits)."""

    def loss_fn(params, images, label_ids):
        logits = forward(params, cfg, images)
        return F.cross_entropy(logits.float(), label_ids), logits

    return loss_fn


def make_train_step(forward: Callable, cfg: Any, optimizer):
    """(params, opt_state, images, label_ids) -> (params, opt_state, loss,
    accuracy). The parameters and the optimizer state are updated in place
    and returned (the JAX step returns new trees)."""
    from karanta_tpu_torch.training.train_step import value_and_grad

    loss_fn = classifier_loss(forward, cfg)

    def train_step(params, opt_state, images, label_ids):
        loss, logits, grads = value_and_grad(loss_fn, params, images,
                                             label_ids)
        params, opt_state = optimizer.step(grads, opt_state, params)
        acc = (logits.detach().argmax(-1) == label_ids).float().mean()
        return params, opt_state, loss, acc

    return train_step


def main(argv: Optional[list[str]] = None) -> dict:
    from karanta_tpu_torch.config import ConfigParser
    from karanta_tpu_torch.device import no_tf32, resolve_device
    from karanta_tpu_torch.training import checkpoint as ckpt
    from karanta_tpu_torch.training.optimizer import (make_adamw,
                                                      make_lr_schedule)

    logging.basicConfig(level=logging.INFO)
    args = ConfigParser(ClassifierArguments).parse(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        no_tf32()

    if args.dataset_mix:
        paths, ids, labels = prepare_mixed_datasets(args.dataset_mix)
    else:
        paths, ids, labels = load_imagefolder(args.dataset_dir)
    if not paths:
        raise RuntimeError("no training images found")
    logger.info("%d images, labels=%s", len(paths), labels)
    cfg, init_params_fn, forward_fn = build_model(args, labels)

    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(paths))
    n_eval = max(1, int(len(paths) * args.eval_fraction)) if len(paths) > 2 else 0
    eval_idx, train_idx = order[:n_eval], order[n_eval:]

    params = init_params_fn(cfg, args.seed, device=device)
    steps_per_epoch = max(1, len(train_idx) // args.batch_size)
    total_steps = (args.max_steps if args.max_steps > 0
                   else steps_per_epoch * args.num_epochs)
    schedule = make_lr_schedule("cosine", args.learning_rate,
                                args.warmup_steps, total_steps)
    optimizer = make_adamw(schedule, args.weight_decay, decay_all_leaves=True)
    opt_state = optimizer.init(params)
    train_step = make_train_step(forward_fn, cfg, optimizer)

    start_step = 0
    resume = args.resume_from_checkpoint
    if resume == "auto":
        resume = ckpt.get_last_checkpoint(args.output_dir)
    if resume:
        state, meta = ckpt.restore_checkpoint(
            resume, {"params": params, "opt_state": opt_state})
        params, opt_state = state["params"], state["opt_state"]
        start_step = int(meta.get("step", 0))
        logger.info("resumed from %s at step %d", resume, start_step)

    metrics: dict = {}
    for step in range(start_step, total_steps):
        sel = [int(train_idx[(step * args.batch_size + k) % len(train_idx)])
               for k in range(args.batch_size)]
        images = _load_batch([paths[i] for i in sel], args.image_size,
                             rng if args.augment else None, arch=args.arch)
        label_ids = torch.tensor([ids[i] for i in sel], device=device)
        params, opt_state, loss, acc = train_step(
            params, opt_state, torch.from_numpy(images).to(device), label_ids)
        if (step + 1) % args.logging_steps == 0 or step + 1 == total_steps:
            metrics = {"step": step + 1, "loss": float(loss),
                       "accuracy": float(acc)}
            logger.info("%s", metrics)
        if args.checkpointing_steps and (step + 1) % args.checkpointing_steps == 0:
            ckpt.save_checkpoint(args.output_dir, step + 1,
                                 {"params": params, "opt_state": opt_state})

    ckpt.save_checkpoint(args.output_dir, total_steps,
                         {"params": params, "opt_state": opt_state},
                         metadata={"labels": labels})

    if len(eval_idx):
        correct = total = 0
        for start in range(0, len(eval_idx), args.batch_size):
            sel = [int(i) for i in eval_idx[start:start + args.batch_size]]
            images = _load_batch([paths[i] for i in sel], args.image_size,
                                 arch=args.arch)
            with torch.no_grad():
                logits = forward_fn(params, cfg,
                                    torch.from_numpy(images).to(device))
            correct += int((logits.argmax(-1).cpu().numpy() == np.asarray(
                [ids[i] for i in sel])).sum())
            total += len(sel)
        metrics["eval_accuracy"] = correct / max(total, 1)
        logger.info("eval accuracy: %.4f", metrics["eval_accuracy"])
    return metrics


if __name__ == "__main__":
    main()
