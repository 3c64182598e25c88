"""ViT image classifier (port of ``karanta_tpu/models/classifier/vit.py``).

The JAX package's tree: dense kernels (in, out), the encoder's weights
stacked on a leading layer axis, walked with one ``torch.unbind``. Every
layer's attention goes through ``ops/attention.attention`` (kernel #2, the
flash kernel, on the card: its float32 instance for the classifiers' float32
activations; the plain version on the CPU), so a forward launches it
``num_layers`` times.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.classifier.layers import (layer_norm,
                                                       normal_init,
                                                       state_reader)
from karanta_tpu_torch.ops.attention import attention
from karanta_tpu_torch.utils.tree import unbind_layers

Params = Any


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    num_classes: int = 2
    layer_norm_eps: float = 1e-12
    labels: tuple[str, ...] = ("no_segment", "segment")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_vit(num_classes: int = 2) -> ViTConfig:
    return ViTConfig(image_size=32, patch_size=8, hidden_size=32,
                     num_layers=2, num_heads=2, intermediate_size=64,
                     num_classes=num_classes)


def init_vit_params(cfg: ViTConfig, seed: int = 0, dtype=torch.float32,
                    device: DeviceLike = None) -> Params:
    """Random parameters with the JAX initialisers' scales, from a seeded
    ``torch.Generator`` on the device (the card unless the caller passes
    ``device="cpu"``)."""
    device = resolve_device(device)
    normal = normal_init(torch.Generator(device=device).manual_seed(seed),
                         device, dtype)
    h, L, inter = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    patch_dim = 3 * cfg.patch_size ** 2

    def dense(shape):
        return normal(shape, (shape[-2] if len(shape) > 1 else shape[0]) ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "patch_embed": {"kernel": dense((patch_dim, h)), "bias": zeros(h)},
        "cls_token": zeros(1, h),
        "pos_embed": normal((cfg.num_patches + 1, h), 0.02),
        "layers": {
            "ln1_scale": ones(L, h), "ln1_bias": zeros(L, h),
            "ln2_scale": ones(L, h), "ln2_bias": zeros(L, h),
            "wq": dense((L, h, h)), "bq": zeros(L, h),
            "wk": dense((L, h, h)), "bk": zeros(L, h),
            "wv": dense((L, h, h)), "bv": zeros(L, h),
            "wo": dense((L, h, h)), "bo": zeros(L, h),
            "w_up": dense((L, h, inter)), "b_up": zeros(L, inter),
            "w_down": dense((L, inter, h)), "b_down": zeros(L, h),
        },
        "final_ln_scale": ones(h),
        "final_ln_bias": zeros(h),
        "head": {"kernel": dense((h, cfg.num_classes)),
                 "bias": zeros(cfg.num_classes)},
    }


def patchify_image(image: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) float -> (B, N, 3*patch*patch) in HF Conv2d order (C,ph,pw)."""
    b, hgt, wid, c = image.shape
    gh, gw = hgt // patch, wid // patch
    x = image.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, ph, pw)
    return x.reshape(b, gh * gw, c * patch * patch)


def vit_forward(params: Params, cfg: ViTConfig,
                images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized floats -> logits (B, num_classes)."""
    b = images.shape[0]
    heads, d, eps = cfg.num_heads, cfg.head_dim, cfg.layer_norm_eps
    x = patchify_image(images, cfg.patch_size) @ params["patch_embed"]["kernel"]
    x = x + params["patch_embed"]["bias"]
    cls = params["cls_token"][None].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    x = x + params["pos_embed"][None].to(x.dtype)

    for layer in unbind_layers(params["layers"], cfg.num_layers):
        xn = layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
        q = (xn @ layer["wq"] + layer["bq"]).reshape(b, -1, heads, d)
        k = (xn @ layer["wk"] + layer["bk"]).reshape(b, -1, heads, d)
        v = (xn @ layer["wv"] + layer["bv"]).reshape(b, -1, heads, d)
        a = attention(q, k, v, causal=False).reshape(b, -1, cfg.hidden_size)
        x = x + (a @ layer["wo"] + layer["bo"])
        xn = layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
        x = x + (F.gelu(xn @ layer["w_up"] + layer["b_up"]) @ layer["w_down"]
                 + layer["b_down"])
    x = layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], eps)
    return x[:, 0] @ params["head"]["kernel"] + params["head"]["bias"]


def convert_hf_vit(state: dict, cfg: ViTConfig, device: DeviceLike = None,
                   dtype=torch.float32) -> Params:
    """Convert an HF ViTForImageClassification state dict (torch or numpy
    values) into the port's tree on `device`."""
    t = state_reader(state, resolve_device(device), dtype)
    pre = "vit.encoder.layer.{}."

    def stack(fmt, transpose=False):
        arrs = [t(pre.format(i) + fmt) for i in range(cfg.num_layers)]
        return torch.stack([a.T for a in arrs] if transpose else arrs)

    conv_w = t("vit.embeddings.patch_embeddings.projection.weight")
    return {
        "patch_embed": {
            # (h, C, p, p) -> (C*p*p, h)
            "kernel": conv_w.reshape(conv_w.shape[0], -1).T.contiguous(),
            "bias": t("vit.embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": t("vit.embeddings.cls_token")[0],
        "pos_embed": t("vit.embeddings.position_embeddings")[0],
        "layers": {
            "ln1_scale": stack("layernorm_before.weight"),
            "ln1_bias": stack("layernorm_before.bias"),
            "ln2_scale": stack("layernorm_after.weight"),
            "ln2_bias": stack("layernorm_after.bias"),
            "wq": stack("attention.attention.query.weight", transpose=True),
            "bq": stack("attention.attention.query.bias"),
            "wk": stack("attention.attention.key.weight", transpose=True),
            "bk": stack("attention.attention.key.bias"),
            "wv": stack("attention.attention.value.weight", transpose=True),
            "bv": stack("attention.attention.value.bias"),
            "wo": stack("attention.output.dense.weight", transpose=True),
            "bo": stack("attention.output.dense.bias"),
            "w_up": stack("intermediate.dense.weight", transpose=True),
            "b_up": stack("intermediate.dense.bias"),
            "w_down": stack("output.dense.weight", transpose=True),
            "b_down": stack("output.dense.bias"),
        },
        "final_ln_scale": t("vit.layernorm.weight"),
        "final_ln_bias": t("vit.layernorm.bias"),
        "head": {"kernel": t("classifier.weight").T.contiguous(),
                 "bias": t("classifier.bias")},
    }


def vit_config_from_hf(hf_cfg: dict) -> ViTConfig:
    """Build a ViTConfig from an HF config.json dict (the JAX package does
    this inline in ``LayoutClassifier.from_checkpoint``)."""
    id2label = hf_cfg.get("id2label", {"0": "no_segment", "1": "segment"})
    labels = tuple(id2label[str(i)] for i in range(len(id2label)))
    return ViTConfig(
        image_size=hf_cfg.get("image_size", 224),
        patch_size=hf_cfg.get("patch_size", 16),
        hidden_size=hf_cfg.get("hidden_size", 768),
        num_layers=hf_cfg.get("num_hidden_layers", 12),
        num_heads=hf_cfg.get("num_attention_heads", 12),
        intermediate_size=hf_cfg.get("intermediate_size", 3072),
        num_classes=len(labels), labels=labels)
