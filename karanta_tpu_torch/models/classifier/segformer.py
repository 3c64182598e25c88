"""SegFormer (MiT) image classifier (port of
``karanta_tpu/models/classifier/segformer.py``).

The reference's production document classifier is a SegFormer (the HF
pipeline over ``taresco/newspaper_classifier_segformer``, a fine-tuned
nvidia/mit-b0). The MiT encoder: overlapping patch embeddings, efficient
self-attention whose keys and values come from a sequence-reduction conv
(stride ``sr``), and a Mix-FFN with a depthwise 3x3 conv; activations NHWC,
conv kernels HWIO, as in the JAX package (``layers.conv_nhwc``). Every
block's attention goes through ``ops/attention.attention`` (kernel #2's
float32 instance on the card): at mit-b0 and 512 px its queries are the
stage's 128^2 ... 16^2 positions and its keys (H/sr)(W/sr) = 256 at every
stage, so a forward launches the kernel ``sum(depths)`` = 8 times.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.classifier.layers import (conv_nhwc,
                                                       layer_norm,
                                                       normal_init,
                                                       state_reader)
from karanta_tpu_torch.ops.attention import attention

Params = Any


@dataclasses.dataclass(frozen=True)
class SegFormerConfig:
    # nvidia/mit-b0 geometry (the reference's base checkpoint)
    num_channels: int = 3
    hidden_sizes: tuple[int, ...] = (32, 64, 160, 256)
    depths: tuple[int, ...] = (2, 2, 2, 2)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: tuple[int, ...] = (7, 3, 3, 3)
    strides: tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratios: tuple[int, ...] = (4, 4, 4, 4)
    num_classes: int = 2
    layer_norm_eps: float = 1e-6
    image_size: int = 512                 # SegformerImageProcessor default
    labels: tuple[str, ...] = ("no_segment", "segment")

    @property
    def num_stages(self) -> int:
        return len(self.hidden_sizes)


def tiny_segformer(num_classes: int = 2) -> SegFormerConfig:
    return SegFormerConfig(
        hidden_sizes=(8, 16), depths=(1, 1), num_heads=(1, 2),
        sr_ratios=(4, 1), patch_sizes=(7, 3), strides=(4, 2),
        mlp_ratios=(2, 2), num_classes=num_classes, image_size=64)


def init_segformer_params(cfg: SegFormerConfig, seed: int = 0,
                          dtype=torch.float32,
                          device: DeviceLike = None) -> Params:
    """Random parameters with the JAX initialisers' scales (fan-in over
    every axis but the last), from a seeded ``torch.Generator`` on the
    device (the card unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    normal = normal_init(torch.Generator(device=device).manual_seed(seed),
                         device, dtype)

    def dense(shape):
        return normal(shape, int(np.prod(shape[:-1])) ** -0.5)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    stages = []
    in_ch = cfg.num_channels
    for si in range(cfg.num_stages):
        h = cfg.hidden_sizes[si]
        p, inter = cfg.patch_sizes[si], h * cfg.mlp_ratios[si]
        blocks = []
        for _ in range(cfg.depths[si]):
            blk = {
                "ln1_scale": ones(h), "ln1_bias": zeros(h),
                "wq": dense((h, h)), "bq": zeros(h),
                "wk": dense((h, h)), "bk": zeros(h),
                "wv": dense((h, h)), "bv": zeros(h),
                "wo": dense((h, h)), "bo": zeros(h),
                "ln2_scale": ones(h), "ln2_bias": zeros(h),
                "w1": dense((h, inter)), "b1": zeros(inter),
                "dw_kernel": dense((3, 3, 1, inter)), "dw_bias": zeros(inter),
                "w2": dense((inter, h)), "b2": zeros(h),
            }
            if cfg.sr_ratios[si] > 1:
                sr = cfg.sr_ratios[si]
                blk["sr_kernel"] = dense((sr, sr, h, h))
                blk["sr_bias"] = zeros(h)
                blk["sr_ln_scale"] = ones(h)
                blk["sr_ln_bias"] = zeros(h)
            blocks.append(blk)
        stages.append({
            "patch_kernel": dense((p, p, in_ch, h)),
            "patch_bias": zeros(h),
            "patch_ln_scale": ones(h), "patch_ln_bias": zeros(h),
            "blocks": blocks,
            "ln_scale": ones(h), "ln_bias": zeros(h),
        })
        in_ch = h
    return {
        "stages": stages,
        "head": {"kernel": dense((cfg.hidden_sizes[-1], cfg.num_classes)),
                 "bias": zeros(cfg.num_classes)},
    }


def _block(x, p, hgt: int, wid: int, heads: int, sr: int, eps: float):
    b, n, c = x.shape
    d = c // heads
    xn = layer_norm(x, p["ln1_scale"], p["ln1_bias"], eps)
    q = (xn @ p["wq"] + p["bq"]).reshape(b, n, heads, d)
    kv_in = xn
    if sr > 1:
        xs = conv_nhwc(xn.reshape(b, hgt, wid, c), p["sr_kernel"],
                       p["sr_bias"], sr, 0)
        kv_in = layer_norm(xs.reshape(b, -1, c), p["sr_ln_scale"],
                           p["sr_ln_bias"], eps)
    k = (kv_in @ p["wk"] + p["bk"]).reshape(b, -1, heads, d)
    v = (kv_in @ p["wv"] + p["bv"]).reshape(b, -1, heads, d)
    a = attention(q, k, v, causal=False).reshape(b, n, c)
    x = x + (a @ p["wo"] + p["bo"])

    xn = layer_norm(x, p["ln2_scale"], p["ln2_bias"], eps)
    y = xn @ p["w1"] + p["b1"]
    inter = y.shape[-1]
    y = conv_nhwc(y.reshape(b, hgt, wid, inter), p["dw_kernel"], p["dw_bias"],
                  1, 1, groups=inter)
    y = F.gelu(y.reshape(b, n, inter))
    return x + (y @ p["w2"] + p["b2"])


def segformer_forward(params: Params, cfg: SegFormerConfig,
                      images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized floats -> logits (B, num_classes)."""
    x = images
    eps = cfg.layer_norm_eps
    for si, stage in enumerate(params["stages"]):
        x = conv_nhwc(x, stage["patch_kernel"], stage["patch_bias"],
                      cfg.strides[si], cfg.patch_sizes[si] // 2)
        b, hgt, wid, c = x.shape
        x = layer_norm(x.reshape(b, hgt * wid, c), stage["patch_ln_scale"],
                       stage["patch_ln_bias"], eps)
        for blk in stage["blocks"]:
            x = _block(x, blk, hgt, wid, cfg.num_heads[si], cfg.sr_ratios[si],
                       eps)
        x = layer_norm(x, stage["ln_scale"], stage["ln_bias"], eps)
        x = x.reshape(b, hgt, wid, c)
    # global average pool over the final feature map, then classify
    # (SegformerForImageClassification semantics)
    pooled = x.reshape(x.shape[0], -1, x.shape[-1]).mean(1)
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def convert_hf_segformer(state: dict, cfg: SegFormerConfig,
                         device: DeviceLike = None,
                         dtype=torch.float32) -> Params:
    """Convert an HF SegformerForImageClassification state dict (torch or
    numpy values) into the port's tree on `device`."""
    t = state_reader(state, resolve_device(device), dtype)

    def lin(key):  # torch Linear (out, in) -> (in, out)
        return t(key).T.contiguous()

    def conv(key):  # torch Conv2d (out, in/groups, kh, kw) -> HWIO
        return t(key).permute(2, 3, 1, 0).contiguous()

    enc = "segformer.encoder."
    stages = []
    for si in range(cfg.num_stages):
        blocks = []
        for bi in range(cfg.depths[si]):
            pre = f"{enc}block.{si}.{bi}."
            blk = {
                "ln1_scale": t(pre + "layer_norm_1.weight"),
                "ln1_bias": t(pre + "layer_norm_1.bias"),
                "wq": lin(pre + "attention.self.query.weight"),
                "bq": t(pre + "attention.self.query.bias"),
                "wk": lin(pre + "attention.self.key.weight"),
                "bk": t(pre + "attention.self.key.bias"),
                "wv": lin(pre + "attention.self.value.weight"),
                "bv": t(pre + "attention.self.value.bias"),
                "wo": lin(pre + "attention.output.dense.weight"),
                "bo": t(pre + "attention.output.dense.bias"),
                "ln2_scale": t(pre + "layer_norm_2.weight"),
                "ln2_bias": t(pre + "layer_norm_2.bias"),
                "w1": lin(pre + "mlp.dense1.weight"),
                "b1": t(pre + "mlp.dense1.bias"),
                "dw_kernel": conv(pre + "mlp.dwconv.dwconv.weight"),
                "dw_bias": t(pre + "mlp.dwconv.dwconv.bias"),
                "w2": lin(pre + "mlp.dense2.weight"),
                "b2": t(pre + "mlp.dense2.bias"),
            }
            if cfg.sr_ratios[si] > 1:
                blk["sr_kernel"] = conv(pre + "attention.self.sr.weight")
                blk["sr_bias"] = t(pre + "attention.self.sr.bias")
                blk["sr_ln_scale"] = t(pre + "attention.self.layer_norm.weight")
                blk["sr_ln_bias"] = t(pre + "attention.self.layer_norm.bias")
            blocks.append(blk)
        stages.append({
            "patch_kernel": conv(f"{enc}patch_embeddings.{si}.proj.weight"),
            "patch_bias": t(f"{enc}patch_embeddings.{si}.proj.bias"),
            "patch_ln_scale": t(f"{enc}patch_embeddings.{si}.layer_norm.weight"),
            "patch_ln_bias": t(f"{enc}patch_embeddings.{si}.layer_norm.bias"),
            "blocks": blocks,
            "ln_scale": t(f"{enc}layer_norm.{si}.weight"),
            "ln_bias": t(f"{enc}layer_norm.{si}.bias"),
        })
    return {
        "stages": stages,
        "head": {"kernel": lin("classifier.weight"),
                 "bias": t("classifier.bias")},
    }


def segformer_config_from_hf(hf_cfg: dict) -> SegFormerConfig:
    """Build a SegFormerConfig from an HF config.json dict."""
    id2label = hf_cfg.get("id2label", {"0": "no_segment", "1": "segment"})
    labels = tuple(id2label[str(i)] for i in range(len(id2label)))
    return SegFormerConfig(
        num_channels=hf_cfg.get("num_channels", 3),
        hidden_sizes=tuple(hf_cfg.get("hidden_sizes", (32, 64, 160, 256))),
        depths=tuple(hf_cfg.get("depths", (2, 2, 2, 2))),
        num_heads=tuple(hf_cfg.get("num_attention_heads", (1, 2, 5, 8))),
        sr_ratios=tuple(hf_cfg.get("sr_ratios", (8, 4, 2, 1))),
        patch_sizes=tuple(hf_cfg.get("patch_sizes", (7, 3, 3, 3))),
        strides=tuple(hf_cfg.get("strides", (4, 2, 2, 2))),
        mlp_ratios=tuple(hf_cfg.get("mlp_ratios", (4, 4, 4, 4))),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-6),
        num_classes=len(labels), labels=labels)
