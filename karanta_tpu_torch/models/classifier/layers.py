"""Layers the classifiers share: LayerNorm over the last axis in float32 and
convolutions over NHWC activations with HWIO kernels (the JAX package's
``lax.conv_general_dilated`` layout).

``conv_nhwc`` hands ``F.conv2d`` the NHWC tensor as a ``channels_last`` NCHW
view and the kernel as an (out, in/groups, kh, kw) view: no copy of the
activations, and cuDNN runs its channels-last kernels; the result's
channels-last memory is NHWC again. Unpadded 1x1 convolutions are products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis, computed in float32."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int, padding: int,
              groups: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin), kernel (kh, kw, Cin/groups, Cout) -> (B, H', W',
    Cout), symmetric zero padding.

    An unpadded 1x1 convolution is the product of the strided pixels with
    the kernel, and runs as one (the ResNet's bottleneck and shortcut
    convs): PyTorch's CPU backward of a strided 1x1 convolution over
    channels-last input crashes (torch 2.13, oneDNN)."""
    if kernel.shape[:2] == (1, 1) and padding == 0 and groups == 1:
        out = x[:, ::stride, ::stride] @ kernel[0, 0].to(x.dtype)
        return out if bias is None else out + bias.to(x.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype),
                   None if bias is None else bias.to(x.dtype), stride=stride,
                   padding=padding, groups=groups)
    return out.permute(0, 2, 3, 1)


def normal_init(gen: torch.Generator, device: torch.device, dtype):
    """normal(shape, std) -> a float32 standard normal from `gen`, times
    std, in `dtype` (the JAX package's initialisers, drawn from a torch
    generator)."""

    def normal(shape, std: float) -> torch.Tensor:
        x = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    return normal


def state_reader(state: dict, device: torch.device, dtype):
    """key -> an HF state dict's value (a torch tensor or a numpy array) as
    a `dtype` tensor on `device` (the HF converters' reader)."""

    def t(key: str) -> torch.Tensor:
        v = state[key]
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, np.float32))
        return v.detach().to(device=device, dtype=torch.float32).to(dtype)

    return t
