"""Default-device resolution for the port's entry points.

The port runs on the card. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do; with no card and no explicit request the
entry points raise instead of silently running somewhere else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def no_tf32() -> None:
    """float32 products and convolutions on the card keep float32: both
    TF32 switches off (the JAX package's float32 semantics; cuDNN's is on by
    default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def float32_reductions() -> None:
    """bf16 and fp16 products on the card reduce in float32: cuBLAS's
    reduced-precision split-K reductions (on by default) off, so a product
    is its float32 accumulation rounded once, as XLA's dot is. With them
    on, the 7B vision tower's MLP down product (K = 3,420) rounds about a
    third of its outputs otherwise on an H100, which a tensor-parallel
    sum of float32 partials does not reproduce."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
