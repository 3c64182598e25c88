"""ConvNeXt V2 and ResNet image classifiers (port of
``karanta_tpu/models/classifier/convnets.py``).

NHWC activations and HWIO conv kernels, as in the JAX package, through
``layers.conv_nhwc`` (cuDNN's channels-last convolutions on the card). No
kernel of the port runs here: the JAX package leaves convolution to XLA.

ResNet's batch norm is the JAX package's ``_bn``: it always normalises with
the stored ``mean`` and ``var``, which are ordinary leaves of the tree, so a
training step differentiates them and AdamW updates and decays them, as
``jax.value_and_grad`` and ``optax.adamw`` do in the JAX trainer; there are
no batch statistics and no running averages.
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

Params = Any


def _init_tools(seed: int, dtype, device: DeviceLike):
    device = resolve_device(device)
    normal = normal_init(torch.Generator(device=device).manual_seed(seed),
                         device, dtype)

    def dense(shape):
        return normal(shape, int(np.prod(shape[:-1])) ** -0.5)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    return dense, full


# ---------------------------------------------------------------------------
# ConvNeXt V2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvNeXtV2Config:
    # facebook/convnextv2-tiny-1k-224 geometry
    num_channels: int = 3
    patch_size: int = 4
    hidden_sizes: tuple[int, ...] = (96, 192, 384, 768)
    depths: tuple[int, ...] = (3, 3, 9, 3)
    num_classes: int = 2
    layer_norm_eps: float = 1e-12   # HF config.layer_norm_eps (final LN)
    image_size: int = 224
    labels: tuple[str, ...] = ("no_segment", "segment")

    @property
    def num_stages(self) -> int:
        return len(self.hidden_sizes)


def tiny_convnextv2(num_classes: int = 2) -> ConvNeXtV2Config:
    return ConvNeXtV2Config(hidden_sizes=(8, 16), depths=(1, 1),
                            num_classes=num_classes, image_size=64)


def init_convnextv2_params(cfg: ConvNeXtV2Config, seed: int = 0,
                           dtype=torch.float32,
                           device: DeviceLike = None) -> Params:
    """Random parameters with the JAX initialisers' scales, from a seeded
    ``torch.Generator`` on the device (the card unless the caller passes
    ``device="cpu"``)."""
    dense, full = _init_tools(seed, dtype, device)
    stages = []
    for si in range(cfg.num_stages):
        c = cfg.hidden_sizes[si]
        stage: dict = {"blocks": []}
        if si > 0:
            cin = cfg.hidden_sizes[si - 1]
            stage["down_ln_scale"] = full(cin, 1.0)
            stage["down_ln_bias"] = full(cin, 0.0)
            stage["down_kernel"] = dense((2, 2, cin, c))
            stage["down_bias"] = full(c, 0.0)
        for _ in range(cfg.depths[si]):
            stage["blocks"].append({
                "dw_kernel": dense((7, 7, 1, c)), "dw_bias": full(c, 0.0),
                "ln_scale": full(c, 1.0), "ln_bias": full(c, 0.0),
                "w1": dense((c, 4 * c)), "b1": full(4 * c, 0.0),
                "grn_scale": full(4 * c, 0.0), "grn_bias": full(4 * c, 0.0),
                "w2": dense((4 * c, c)), "b2": full(c, 0.0),
            })
        stages.append(stage)
    c0, cl = cfg.hidden_sizes[0], cfg.hidden_sizes[-1]
    return {
        "stem_kernel": dense((cfg.patch_size, cfg.patch_size,
                              cfg.num_channels, c0)),
        "stem_bias": full(c0, 0.0),
        "stem_ln_scale": full(c0, 1.0),
        "stem_ln_bias": full(c0, 0.0),
        "stages": stages,
        "final_ln_scale": full(cl, 1.0),
        "final_ln_bias": full(cl, 0.0),
        "head": {"kernel": dense((cl, cfg.num_classes)),
                 "bias": full(cfg.num_classes, 0.0)},
    }


def _grn(x, scale, bias):
    """Global Response Normalization (ConvNeXt V2): L2 over spatial dims,
    normalized by the channel mean."""
    xf = x.float()
    g = torch.sqrt(torch.sum(xf * xf, dim=(1, 2), keepdim=True))  # (B,1,1,C)
    n = g / (g.mean(-1, keepdim=True) + 1e-6)
    return (scale * (xf * n) + bias + xf).to(x.dtype)


def convnextv2_forward(params: Params, cfg: ConvNeXtV2Config,
                       images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized floats -> logits (B, num_classes)."""
    x = conv_nhwc(images, params["stem_kernel"], params["stem_bias"],
                  cfg.patch_size, 0)
    x = layer_norm(x, params["stem_ln_scale"], params["stem_ln_bias"], 1e-6)
    for si, stage in enumerate(params["stages"]):
        if si > 0:
            x = layer_norm(x, stage["down_ln_scale"], stage["down_ln_bias"],
                           1e-6)
            x = conv_nhwc(x, stage["down_kernel"], stage["down_bias"], 2, 0)
        c = cfg.hidden_sizes[si]
        for blk in stage["blocks"]:
            y = conv_nhwc(x, blk["dw_kernel"], blk["dw_bias"], 1, 3, groups=c)
            y = layer_norm(y, blk["ln_scale"], blk["ln_bias"], 1e-6)
            y = F.gelu(y @ blk["w1"] + blk["b1"])
            y = _grn(y, blk["grn_scale"], blk["grn_bias"])
            x = x + (y @ blk["w2"] + blk["b2"])
    pooled = x.mean(dim=(1, 2))
    pooled = layer_norm(pooled, params["final_ln_scale"],
                        params["final_ln_bias"], cfg.layer_norm_eps)
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def _hf_readers(state: dict, device: DeviceLike, dtype):
    t = state_reader(state, resolve_device(device), dtype)

    def conv(key):  # torch Conv2d (out, in/groups, kh, kw) -> HWIO
        return t(key).permute(2, 3, 1, 0).contiguous()

    def lin(key):  # torch Linear (out, in) -> (in, out)
        return t(key).T.contiguous()

    def vec(key):
        return t(key).reshape(-1)

    return conv, lin, vec


def convert_hf_convnextv2(state: dict, cfg: ConvNeXtV2Config,
                          device: DeviceLike = None,
                          dtype=torch.float32) -> Params:
    """Convert an HF ConvNextV2ForImageClassification state dict (torch or
    numpy values) into the port's tree on `device`."""
    conv, lin, vec = _hf_readers(state, device, dtype)
    enc = "convnextv2.encoder.stages"
    stages = []
    for si in range(cfg.num_stages):
        stage: dict = {"blocks": []}
        if si > 0:
            down = f"{enc}.{si}.downsampling_layer"
            stage["down_ln_scale"] = vec(f"{down}.0.weight")
            stage["down_ln_bias"] = vec(f"{down}.0.bias")
            stage["down_kernel"] = conv(f"{down}.1.weight")
            stage["down_bias"] = vec(f"{down}.1.bias")
        for bi in range(cfg.depths[si]):
            pre = f"{enc}.{si}.layers.{bi}."
            stage["blocks"].append({
                "dw_kernel": conv(pre + "dwconv.weight"),
                "dw_bias": vec(pre + "dwconv.bias"),
                "ln_scale": vec(pre + "layernorm.weight"),
                "ln_bias": vec(pre + "layernorm.bias"),
                "w1": lin(pre + "pwconv1.weight"),
                "b1": vec(pre + "pwconv1.bias"),
                "grn_scale": vec(pre + "grn.weight"),
                "grn_bias": vec(pre + "grn.bias"),
                "w2": lin(pre + "pwconv2.weight"),
                "b2": vec(pre + "pwconv2.bias"),
            })
        stages.append(stage)
    return {
        "stem_kernel": conv("convnextv2.embeddings.patch_embeddings.weight"),
        "stem_bias": vec("convnextv2.embeddings.patch_embeddings.bias"),
        "stem_ln_scale": vec("convnextv2.embeddings.layernorm.weight"),
        "stem_ln_bias": vec("convnextv2.embeddings.layernorm.bias"),
        "stages": stages,
        "final_ln_scale": vec("convnextv2.layernorm.weight"),
        "final_ln_bias": vec("convnextv2.layernorm.bias"),
        "head": {"kernel": lin("classifier.weight"),
                 "bias": vec("classifier.bias")},
    }


def convnextv2_config_from_hf(hf_cfg: dict) -> ConvNeXtV2Config:
    id2label = hf_cfg.get("id2label", {"0": "no_segment", "1": "segment"})
    labels = tuple(id2label[str(i)] for i in range(len(id2label)))
    return ConvNeXtV2Config(
        num_channels=hf_cfg.get("num_channels", 3),
        patch_size=hf_cfg.get("patch_size", 4),
        hidden_sizes=tuple(hf_cfg.get("hidden_sizes", (96, 192, 384, 768))),
        depths=tuple(hf_cfg.get("depths", (3, 3, 9, 3))),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        num_classes=len(labels), labels=labels)


# ---------------------------------------------------------------------------
# ResNet (bottleneck, v1.5-style: stride in the 3x3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    # microsoft/resnet-50 geometry
    num_channels: int = 3
    embedding_size: int = 64
    hidden_sizes: tuple[int, ...] = (256, 512, 1024, 2048)
    depths: tuple[int, ...] = (3, 4, 6, 3)
    reduction: int = 4
    downsample_in_first_stage: bool = False
    num_classes: int = 2
    bn_eps: float = 1e-5
    image_size: int = 224
    labels: tuple[str, ...] = ("no_segment", "segment")

    @property
    def num_stages(self) -> int:
        return len(self.hidden_sizes)


def tiny_resnet(num_classes: int = 2) -> ResNetConfig:
    return ResNetConfig(embedding_size=8, hidden_sizes=(8, 16),
                        depths=(1, 1), num_classes=num_classes,
                        image_size=64)


def _bn(x, p, eps):
    """Batch norm with the stored statistics (the JAX package's ``_bn``)."""
    xf = x.float()
    inv = torch.rsqrt(p["var"].float() + eps)
    out = (xf - p["mean"]) * inv * p["scale"] + p["bias"]
    return out.to(x.dtype)


def init_resnet_params(cfg: ResNetConfig, seed: int = 0, dtype=torch.float32,
                       device: DeviceLike = None) -> Params:
    """Random parameters with the JAX initialisers' scales, from a seeded
    ``torch.Generator`` on the device (the card unless the caller passes
    ``device="cpu"``)."""
    dense, full = _init_tools(seed, dtype, device)

    def bn(c):
        return {"scale": full(c, 1.0), "bias": full(c, 0.0),
                "mean": full(c, 0.0), "var": full(c, 1.0)}

    stages = []
    cin = cfg.embedding_size
    for si in range(cfg.num_stages):
        cout = cfg.hidden_sizes[si]
        reduces = cout // cfg.reduction
        layers = []
        for li in range(cfg.depths[si]):
            lin_ch = cin if li == 0 else cout
            layer = {
                "conv1": dense((1, 1, lin_ch, reduces)), "bn1": bn(reduces),
                "conv2": dense((3, 3, reduces, reduces)), "bn2": bn(reduces),
                "conv3": dense((1, 1, reduces, cout)), "bn3": bn(cout),
            }
            if li == 0 and (lin_ch != cout or si > 0
                            or cfg.downsample_in_first_stage):
                layer["short_conv"] = dense((1, 1, lin_ch, cout))
                layer["short_bn"] = bn(cout)
            layers.append(layer)
        stages.append({"layers": layers})
        cin = cout
    return {
        "stem_kernel": dense((7, 7, cfg.num_channels, cfg.embedding_size)),
        "stem_bn": bn(cfg.embedding_size),
        "stages": stages,
        "head": {"kernel": dense((cfg.hidden_sizes[-1], cfg.num_classes)),
                 "bias": full(cfg.num_classes, 0.0)},
    }


def resnet_forward(params: Params, cfg: ResNetConfig,
                   images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized floats -> logits (B, num_classes)."""
    eps = cfg.bn_eps
    x = conv_nhwc(images, params["stem_kernel"], None, 2, 3)
    x = F.relu(_bn(x, params["stem_bn"], eps))
    # maxpool 3x3 stride 2 pad 1; the padding is -inf, as in the JAX
    # package's reduce_window
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    for si, stage in enumerate(params["stages"]):
        stride = 2 if (si > 0 or cfg.downsample_in_first_stage) else 1
        for li, layer in enumerate(stage["layers"]):
            s = stride if li == 0 else 1
            shortcut = x
            if "short_conv" in layer:
                shortcut = _bn(conv_nhwc(x, layer["short_conv"], None, s, 0),
                               layer["short_bn"], eps)
            y = F.relu(_bn(conv_nhwc(x, layer["conv1"], None, 1, 0),
                           layer["bn1"], eps))
            y = F.relu(_bn(conv_nhwc(y, layer["conv2"], None, s, 1),
                           layer["bn2"], eps))
            y = _bn(conv_nhwc(y, layer["conv3"], None, 1, 0), layer["bn3"],
                    eps)
            x = F.relu(y + shortcut)
    pooled = x.mean(dim=(1, 2))
    return pooled @ params["head"]["kernel"] + params["head"]["bias"]


def convert_hf_resnet(state: dict, cfg: ResNetConfig,
                      device: DeviceLike = None,
                      dtype=torch.float32) -> Params:
    """Convert an HF ResNetForImageClassification state dict (torch or numpy
    values) into the port's tree on `device`."""
    conv, lin, vec = _hf_readers(state, device, dtype)

    def bn(prefix):
        return {"scale": vec(prefix + ".weight"),
                "bias": vec(prefix + ".bias"),
                "mean": vec(prefix + ".running_mean"),
                "var": vec(prefix + ".running_var")}

    enc = "resnet.encoder.stages"
    stages = []
    for si in range(cfg.num_stages):
        layers = []
        for li in range(cfg.depths[si]):
            pre = f"{enc}.{si}.layers.{li}."
            layer = {
                "conv1": conv(pre + "layer.0.convolution.weight"),
                "bn1": bn(pre + "layer.0.normalization"),
                "conv2": conv(pre + "layer.1.convolution.weight"),
                "bn2": bn(pre + "layer.1.normalization"),
                "conv3": conv(pre + "layer.2.convolution.weight"),
                "bn3": bn(pre + "layer.2.normalization"),
            }
            if f"{pre}shortcut.convolution.weight" in state:
                layer["short_conv"] = conv(pre + "shortcut.convolution.weight")
                layer["short_bn"] = bn(pre + "shortcut.normalization")
            layers.append(layer)
        stages.append({"layers": layers})
    return {
        "stem_kernel": conv("resnet.embedder.embedder.convolution.weight"),
        "stem_bn": bn("resnet.embedder.embedder.normalization"),
        "stages": stages,
        "head": {"kernel": lin("classifier.1.weight"),
                 "bias": vec("classifier.1.bias")},
    }


def resnet_config_from_hf(hf_cfg: dict) -> ResNetConfig:
    id2label = hf_cfg.get("id2label", {"0": "no_segment", "1": "segment"})
    labels = tuple(id2label[str(i)] for i in range(len(id2label)))
    return ResNetConfig(
        num_channels=hf_cfg.get("num_channels", 3),
        embedding_size=hf_cfg.get("embedding_size", 64),
        hidden_sizes=tuple(hf_cfg.get("hidden_sizes", (256, 512, 1024, 2048))),
        depths=tuple(hf_cfg.get("depths", (3, 4, 6, 3))),
        downsample_in_first_stage=hf_cfg.get("downsample_in_first_stage",
                                             False),
        num_classes=len(labels), labels=labels)
