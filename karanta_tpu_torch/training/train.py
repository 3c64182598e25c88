"""OCR VLM fine-tuning CLI: the train loop with resume (port of
``karanta_tpu/training/train.py``).

YAML config plus CLI overrides (the JAX trainer's flags), datasets through
the pipeline-step registry, bf16 or float32 compute, gradient accumulation,
AdamW or Muon, cosine/linear/constant schedules with warmup, full-parameter
or LoRA/QLoRA training, periodic eval and checkpoints with keep-last-N and
resume, loss and tokens/s logging.

Parallel training: one process a rank. ``--num_processes N --process_id p
--coordinator_address host:port`` (or a ``file://`` URL) joins the ranks
(NCCL when each rank has a card, gloo otherwise), and ``--mesh_data``,
``--mesh_fsdp``, ``--mesh_model`` and ``--mesh_seq`` lay them out
(``train_step.py`` says what each axis does). The global batch is
``per_device_train_batch_size`` x the "data" size x
``gradient_accumulation_steps`` rows; every process collates it and each
feeds only its own rows to its device. Checkpoints hold the unsharded state
(rank 0 writes them), so a run resumes at any mesh. LoRA and QLoRA run at
any mesh too: the frozen base as this rank's slices, the factors (the
state) whole on every rank (``training/lora.py``).

Usage: python -m karanta_tpu_torch.training.train <cfg.yaml> [--key value ...]
(``--device cpu`` runs on the CPU, with the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

logger = logging.getLogger("karanta_tpu_torch.train")


@dataclasses.dataclass
class ExperimentArguments:
    output_dir: str = "runs/ocr"
    learning_rate: float = 1e-5
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 50
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"            # adamw | muon
    num_train_epochs: int = 1
    max_steps: int = -1
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 4
    eval_steps: int = 500
    logging_steps: int = 10
    checkpointing_steps: int = 500
    keep_last_n_checkpoints: int = 2
    resume_from_checkpoint: Optional[str] = None
    seed: int = 42
    gradient_checkpointing: bool = False
    report_to: str = "none"             # none | wandb
    use_lora: bool = False
    use_qlora: bool = False             # nf4-quantized frozen base + LoRA
    is_profile: bool = False            # periodic torch.profiler step traces
    profile_steps: int = 100
    lora_rank: int = 16
    lora_alpha: float = 16.0


@dataclasses.dataclass
class ModelArguments:
    model_name_or_path: str = "tiny"
    checkpoint_path: Optional[str] = None   # HF safetensors dir
    dtype: str = "bfloat16"
    device: Optional[str] = None            # the card unless "cpu"
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_model: int = 1
    mesh_seq: int = 1
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclasses.dataclass
class DatasetArguments:
    dataset_root: str = ""
    pdf_dir_name: str = "pdfs"
    json_dir_name: str = "json"
    pipeline: Optional[List[dict]] = None
    max_length: int = 8192
    eval_fraction: float = 0.01
    cache_dir: Optional[str] = None


DEFAULT_PIPELINE = [
    {"name": "PDF2ImageStep", "target_longest_image_dim": 1288},
    {"name": "FetchPageData"},
    {"name": "StaticLengthDocumentAnchoring", "target_anchor_text_len": 4000},
    {"name": "FinetuningPrompt"},
    {"name": "JSONOutputFormat"},
    {"name": "InstructUserMessages"},
    {"name": "Tokenizer"},
]


def _state_param_path(key: str) -> Optional[str]:
    """The parameter path of a checkpoint key ("params/<p>",
    "opt_state/{mu,nu,momentum}/<p>"), None for the replicated scalars."""
    parts = key.split("/")
    if parts[0] == "params":
        return "/".join(parts[1:])
    if parts[0] == "opt_state" and parts[1] in ("mu", "nu", "momentum"):
        return "/".join(parts[2:])
    return None


def main(argv: Optional[list[str]] = None) -> dict:
    import torch.distributed as dist

    from karanta_tpu_torch.config import ConfigParser
    from karanta_tpu_torch.device import (float32_reductions, no_tf32,
                                          resolve_device)
    from karanta_tpu_torch.models.qwen25_vl.config import get_config
    from karanta_tpu_torch.models.qwen25_vl.model import init_params
    from karanta_tpu_torch.parallel.mesh import (DATA_AXIS, MeshConfig,
                                                 create_mesh,
                                                 initialize_distributed)
    from karanta_tpu_torch.parallel.sharding import Placement, barrier
    from karanta_tpu_torch.training import checkpoint as ckpt
    from karanta_tpu_torch.training.data import DataCollator, LocalDataset
    from karanta_tpu_torch.training.optimizer import (make_lr_schedule,
                                                      make_optimizer)
    from karanta_tpu_torch.training.train_step import (create_train_state,
                                                       eval_step,
                                                       make_train_step,
                                                       train_param_axes)

    logging.basicConfig(level=logging.INFO)
    exp, model_args, data_args = ConfigParser(
        [ExperimentArguments, ModelArguments, DatasetArguments]).parse(argv)
    device = resolve_device(model_args.device)
    if device.type == "cuda":
        # float32 products keep float32 and bf16 products reduce in float32
        # (the JAX package's semantics; the engine sets the same switches)
        no_tf32()
        float32_reductions()

    # --- ranks & mesh ---
    joined = False
    if model_args.num_processes and model_args.num_processes > 1:
        initialize_distributed(model_args.coordinator_address,
                               model_args.num_processes,
                               model_args.process_id, device=device)
        joined = True
    mesh = create_mesh(MeshConfig(model_args.mesh_data, model_args.mesh_fsdp,
                                  model_args.mesh_model,
                                  seq=model_args.mesh_seq), device=device)
    device = mesh.device
    sp_mesh = mesh if model_args.mesh_seq > 1 else None

    # --- model ---
    if model_args.model_name_or_path in ("tiny", "small"):
        from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
        from karanta_tpu_torch.models.qwen25_vl.config import (small_config,
                                                               tiny_config)

        tokenizer = ByteTokenizer()
        factory = (tiny_config if model_args.model_name_or_path == "tiny"
                   else small_config)
        cfg = factory(vocab_size=tokenizer.vocab_size)
    else:
        from karanta_tpu_torch.inference.tokenizer import HFTokenizer

        cfg = get_config(model_args.model_name_or_path)
        tokenizer = HFTokenizer(model_args.checkpoint_path
                                or model_args.model_name_or_path)

    dtype = torch.bfloat16 if model_args.dtype == "bfloat16" else torch.float32
    if model_args.checkpoint_path:
        from karanta_tpu_torch.models.qwen25_vl.loading import \
            load_hf_checkpoint

        params = load_hf_checkpoint(model_args.checkpoint_path, cfg, dtype,
                                    device=device)
    else:
        params = init_params(cfg, exp.seed, dtype, device=device)

    # --- data ---
    pipeline = data_args.pipeline or DEFAULT_PIPELINE
    dataset = LocalDataset(
        data_args.dataset_root, data_args.pdf_dir_name,
        data_args.json_dir_name, pipeline, cache_dir=data_args.cache_dir,
        tokenizer=tokenizer, vision_cfg=cfg.vision,
        max_length=data_args.max_length)
    samples = dataset.build()
    if not samples:
        raise RuntimeError(f"no usable samples in {data_args.dataset_root}")
    rng = np.random.default_rng(exp.seed)
    order = rng.permutation(len(samples))
    n_eval = max(1, int(len(samples) * data_args.eval_fraction)) \
        if len(samples) > 1 and data_args.eval_fraction > 0 else 0
    eval_samples = [samples[i] for i in order[:n_eval]]
    train_samples = [samples[i] for i in order[n_eval:]] or samples
    fixed_grid, fixed_seq = DataCollator.fit_buckets(samples)
    collator = DataCollator(
        cfg.vision, fixed_seq=fixed_seq,
        fixed_grid=fixed_grid if fixed_grid != (0, 0) else None)

    # --- optimizer & state ---
    batch_size = (exp.per_device_train_batch_size * mesh.size(DATA_AXIS)
                  * exp.gradient_accumulation_steps)
    steps_per_epoch = max(1, len(train_samples) // max(batch_size, 1))
    total_steps = (exp.max_steps if exp.max_steps > 0
                   else steps_per_epoch * exp.num_train_epochs)
    schedule = make_lr_schedule(exp.lr_scheduler_type, exp.learning_rate,
                                exp.warmup_steps, total_steps)
    optimizer = make_optimizer(exp.optimizer, schedule,
                               weight_decay=exp.weight_decay,
                               max_grad_norm=exp.max_grad_norm)
    remat = exp.gradient_checkpointing
    lora_template = None
    if exp.use_lora or exp.use_qlora:
        from karanta_tpu_torch.training.lora import (init_lora_params,
                                                     lora_base_placement,
                                                     make_lora_train_step,
                                                     merge_lora,
                                                     quantize_base_nf4,
                                                     trainable_lora,
                                                     with_factors)

        lora_step = make_lora_train_step(
            cfg, optimizer, remat=remat,
            grad_accum=exp.gradient_accumulation_steps, sp_mesh=sp_mesh,
            mesh=mesh)
        lora_template = init_lora_params(
            params, exp.lora_rank,
            torch.Generator(device=device).manual_seed(exp.seed + 1),
            alpha=exp.lora_alpha)
        if exp.use_qlora:
            params = quantize_base_nf4(params)
        # the frozen base as this rank's slices; the factors (the state,
        # and so the checkpoints) whole on every rank
        params = lora_base_placement(cfg, mesh, exp.use_qlora).shard(params)
        merged_placement = Placement(train_param_axes(cfg), mesh)
        state = create_train_state(trainable_lora(lora_template), optimizer)

        def train_fn(state, batch):
            return lora_step(state, params, lora_template, batch)
        placement = None
    else:
        train_fn = make_train_step(
            cfg, optimizer, remat=remat,
            grad_accum=exp.gradient_accumulation_steps, sp_mesh=sp_mesh,
            mesh=mesh)
        placement = Placement(train_param_axes(cfg), mesh)
        params = placement.shard(params)
        state = create_train_state(params, optimizer)
    eval_fn = eval_step(cfg, sp_mesh=sp_mesh, mesh=mesh)

    def eval_params(current_state):
        if lora_template is not None:
            return merge_lora(params, with_factors(lora_template,
                                                   current_state.params),
                              merged_placement)
        return current_state.params

    def whole_leaf(key, t):
        path = _state_param_path(key)
        return t if placement is None or path is None else \
            placement.whole(path, t)

    def own_leaf(key, t):
        path = _state_param_path(key)
        return t if placement is None or path is None else \
            placement.own(path, t)

    def save(step_: int) -> None:
        # every rank gathers its slices; rank 0 writes after a barrier and
        # the others wait until the checkpoint is complete
        barrier(mesh.cpu_group)
        ckpt.save_checkpoint(exp.output_dir, step_, state,
                             keep_last=exp.keep_last_n_checkpoints,
                             leaf_fn=whole_leaf, write=mesh.rank == 0)
        barrier(mesh.cpu_group)

    start_step = 0
    resume = exp.resume_from_checkpoint
    if resume == "auto":
        resume = ckpt.get_last_checkpoint(exp.output_dir)
    if resume:
        state, meta = ckpt.restore_checkpoint(resume, state,
                                              leaf_fn=own_leaf)
        start_step = int(meta.get("step", 0))
        logger.info("resumed from %s at step %d", resume, start_step)

    # --- loop ---
    tracker = None
    if exp.report_to == "wandb" and mesh.rank == 0:
        try:
            import wandb

            tracker = wandb.init(project="karanta-tpu", config=vars(exp))
        except ImportError:
            logger.warning("wandb not installed; logging to stdout only")

    step = start_step
    last_metrics: dict = {}
    t_start = time.time()
    tokens_seen = 0
    sampler = EpochSampler(exp.seed, len(train_samples))
    while step < total_steps:
        idx = [sampler.index(step * batch_size + k)
               for k in range(max(batch_size, 1))]
        # the global batch, on the host: the step feeds this rank's rows
        batch = to_device_batch(collator([train_samples[i] for i in idx]),
                                "cpu")
        if exp.is_profile and (step + 1) % exp.profile_steps == 0:
            from karanta_tpu_torch.utils.profiling import profile_step

            profiles = os.path.join(exp.output_dir, "profiles")
            if mesh.world > 1:
                profiles = os.path.join(profiles, f"rank{mesh.rank}")
            state, metrics = profile_step(train_fn, (state, batch), step + 1,
                                          profiles)
        else:
            state, metrics = train_fn(state, batch)
        step += 1
        tokens_seen += int(metrics["tokens"])

        if step % exp.logging_steps == 0 or step == total_steps:
            elapsed = time.time() - t_start
            last_metrics = {
                "step": step,
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(schedule(step)),
                "tokens_per_sec": tokens_seen / max(elapsed, 1e-6),
            }
            logger.info("%s", last_metrics)
            if tracker:
                tracker.log(last_metrics, step=step)

        if exp.eval_steps and step % exp.eval_steps == 0 and eval_samples:
            eval_loss = _run_eval(eval_fn, eval_params(state), collator,
                                  eval_samples)
            logger.info("eval at %d: loss=%.4f", step, eval_loss)
            if tracker:
                tracker.log({"eval_loss": eval_loss}, step=step)

        if exp.checkpointing_steps and step % exp.checkpointing_steps == 0:
            save(step)

    save(step)
    if eval_samples:
        final_eval = _run_eval(eval_fn, eval_params(state), collator,
                               eval_samples)
        last_metrics["final_eval_loss"] = final_eval
        logger.info("final eval loss: %.4f", final_eval)
    if tracker:
        tracker.finish()
    if joined:
        dist.destroy_process_group()
    return last_metrics


class EpochSampler:
    """Seedable per-epoch reshuffle, resume-stable: the sample at global
    position p depends only on (seed, p)."""

    def __init__(self, seed: int, n: int):
        self.seed = seed
        self.n = max(1, n)
        self._epoch = -1
        self._order: Optional[np.ndarray] = None

    def index(self, position: int) -> int:
        epoch, offset = divmod(position, self.n)
        if epoch != self._epoch:
            self._order = np.random.default_rng(
                [self.seed, epoch]).permutation(self.n)
            self._epoch = epoch
        return int(self._order[offset])


def _run_eval(eval_fn, params, collator, eval_samples,
              batch_size: int = 2) -> float:
    """Mean eval loss; every rank evaluates every row (a replicated batch:
    eval chunks are small and need not divide the "data" axis)."""
    losses = []
    for start in range(0, len(eval_samples), batch_size):
        chunk = eval_samples[start:start + batch_size]
        metrics = eval_fn(params, to_device_batch(collator(chunk), "cpu"))
        losses.append(float(metrics["loss"]))
    return float(np.mean(losses)) if losses else float("nan")


def to_device_batch(batch: dict, device) -> dict:
    """A collated batch (numpy) as tensors on `device`."""
    return {key: torch.from_numpy(np.ascontiguousarray(value)).to(device)
            for key, value in batch.items() if key != "n_windows"}


if __name__ == "__main__":
    main()
