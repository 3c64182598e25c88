"""Document-layout classifier inference (port of
``karanta_tpu/inference/image_classifier.py``).

Parity surface with reference karanta/inference/image_classifier.py:8-54:
`load_image` accepts a path/URL-string, PIL image, numpy array, or
torch-style tensor and normalizes to RGB; `predict_layout` returns the best
{"label", "score"} over the segment/no_segment classes. The backing model is
architecture-dispatched: SegFormer (the reference's production checkpoint
`taresco/newspaper_classifier_segformer`), ViT, ConvNeXt V2 or ResNet
(``models/classifier``); a lazily-created singleton per device mirrors the
reference's module-level pipeline.

Everything runs on the card unless the caller passes ``device="cpu"``. The
host ships uint8 pixels and the card normalizes them, as the JAX package
does; float32 products and convolutions do not round to TF32 (both switches
are turned off when a classifier is built on the card).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, no_tf32, resolve_device
from karanta_tpu_torch.models.classifier.convert import get_arch
from karanta_tpu_torch.utils.tree import tree_map

# HF ViT-style processors normalize with 0.5s; SegFormer's processor uses
# the ImageNet statistics
HALF_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
HALF_STD = np.array([0.5, 0.5, 0.5], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def norm_stats(arch: str) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) of an arch's image processor: 0.5s for the ViT, the
    ImageNet statistics for SegFormer, ConvNeXt and ResNet."""
    if arch.startswith(("segformer", "convnextv2", "resnet")):
        return IMAGENET_MEAN, IMAGENET_STD
    return HALF_MEAN, HALF_STD


class LayoutClassifier:
    def __init__(self, params: Any, cfg: Any, arch: str = "vit",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.forward = get_arch(arch).forward
        self.mean, self.std = norm_stats(arch)
        if self.device.type == "cuda":
            no_tf32()
        self.arch = arch
        self.cfg = cfg
        self.params = tree_map(lambda t, _: t.to(self.device), params)
        self._mean = torch.from_numpy(self.mean).to(self.device)
        self._std = torch.from_numpy(self.std).to(self.device)

    def logits(self, images: np.ndarray) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> float32 logits (B, num_classes) on the
        device: /255, mean and std on the device, then the forward."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        with torch.no_grad():
            x = x.float() / 255.0
            x = (x - self._mean.reshape(1, 1, 1, 3)) / self._std.reshape(
                1, 1, 1, 3)
            return self.forward(self.params, self.cfg, x)

    @classmethod
    def from_checkpoint(cls, path: str,
                        device: DeviceLike = None) -> "LayoutClassifier":
        """Load an HF image-classification directory (safetensors, read
        through safetensors' torch reader).

        Dispatches on config.json model_type: segformer (the reference's
        production classifier), convnextv2, resnet, else vit."""
        import glob as globmod
        import json

        from safetensors import safe_open

        device = resolve_device(device)
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        state = {}
        for file in globmod.glob(os.path.join(path, "*.safetensors")):
            with safe_open(file, framework="pt", device="cpu") as f:
                for key in f.keys():
                    state[key] = f.get_tensor(key)

        model_type = hf_cfg.get("model_type", "vit")
        arch = {"segformer": "segformer", "convnextv2": "convnextv2",
                "convnext": "convnextv2",
                "resnet": "resnet"}.get(model_type, "vit")
        spec = get_arch(arch)
        cfg = spec.config_from_hf(hf_cfg)
        return cls(spec.convert_hf(state, cfg, device=device), cfg,
                   arch=arch, device=device)

    @classmethod
    def random(cls, seed: int = 0, arch: str = "vit",
               device: DeviceLike = None) -> "LayoutClassifier":
        """The arch's default (full-size) config with seeded random
        weights."""
        device = resolve_device(device)
        spec = get_arch(arch)
        cfg = spec.config()
        return cls(spec.init(cfg, seed, device=device), cfg, arch=arch,
                   device=device)

    def preprocess(self, image) -> np.ndarray:
        from PIL import Image

        pil = load_image(image)
        pil = pil.resize((self.cfg.image_size, self.cfg.image_size),
                         Image.Resampling.BILINEAR)
        return np.asarray(pil, np.uint8)  # normalization happens on device

    def predict(self, image) -> dict:
        return self.predict_batch([image])[0]

    def predict_batch(self, images: list) -> list[dict]:
        batch = np.stack([self.preprocess(im) for im in images])
        probs = torch.softmax(self.logits(batch).cpu(), dim=-1).numpy()
        best = probs.argmax(-1)
        return [{"label": self.cfg.labels[int(b)], "score": float(p[int(b)])}
                for b, p in zip(best, probs)]


def load_image(image) -> "Any":
    """path / PIL / ndarray / torch-tensor -> RGB PIL image
    (reference image_classifier.py:15-39)."""
    from PIL import Image

    if isinstance(image, str):
        if image.startswith("http://") or image.startswith("https://"):
            raise ValueError("URL inputs need network access; download first")
        pil = Image.open(image)
    elif isinstance(image, Image.Image):
        pil = image
    elif isinstance(image, np.ndarray):
        arr = image
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = np.moveaxis(arr, 0, -1)  # CHW -> HWC
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, -1)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        pil = Image.fromarray(arr)
    elif isinstance(image, torch.Tensor):
        return load_image(image.detach().cpu().numpy())
    elif hasattr(image, "__array__"):  # other array-likes
        return load_image(np.asarray(image))
    else:
        raise TypeError(f"Unsupported image type {type(image)}")
    return pil.convert("RGB")


_classifiers: dict[str, LayoutClassifier] = {}


def _get_classifier(device: DeviceLike = None) -> LayoutClassifier:
    """The process's classifier on `device`: the HF checkpoint at
    KARANTA_CLASSIFIER_PATH when that is a directory, else the random ViT."""
    device = resolve_device(device)
    key = str(device)
    if key not in _classifiers:
        path = os.environ.get("KARANTA_CLASSIFIER_PATH")
        if path and os.path.isdir(path):
            _classifiers[key] = LayoutClassifier.from_checkpoint(
                path, device=device)
        else:
            _classifiers[key] = LayoutClassifier.random(device=device)
    return _classifiers[key]


def predict_layout(image, device: DeviceLike = None) -> dict:
    """{"label": "segment"|"no_segment", "score": float}
    (reference image_classifier.py:42-54)."""
    return _get_classifier(device).predict(image)
