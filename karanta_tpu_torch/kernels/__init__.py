"""Hand-written CUDA kernels (``csrc/``) and their launch counts.

Each kernel's wrapper lives beside its plain PyTorch version in ``ops/`` and
adds one to ``LAUNCHES[name]`` where it launches the kernel, and nowhere
else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"window_attention": 0, "flash_attention": 0,
            "paged_decode_append_quant": 0,
            "paged_decode_append_multi_quant": 0, "paged_decode_append": 0,
            "paged_decode_append_q4": 0, "paged_decode_append_multi_q4": 0,
            "paged_decode_attention": 0, "paged_decode_attention_stacked": 0,
            "dense_stream": 0, "decode_megakernel": 0}

# element-type codes of the C interfaces (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_cuda_inputs(name: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    on one device, and the activations' dtype has a kernel instantiation."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: no kernel for dtype {dtype}")
    device = None
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, expected CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def ptr(t) -> "ctypes.c_void_p | None":
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {code}")
