"""Attention ops (port of ``karanta_tpu/ops/attention.py``).

Public convention, as in the JAX package: q (B, Sq, H, D), k/v (B, Sk, KVH, D)
("BSHD"), float kv masks (B, Sk) with 1 = valid.

Two kernels live here, each beside its plain PyTorch version:

- ``flash_attention``: online-softmax attention with GQA, kv mask and causal
  masking at ``q_offset`` (CUDA ``kernels/csrc/flash_attention.cu``).
- ``window_attention_kernel_call``: attention inside contiguous
  ``window``-token segments with optional fused rope (CUDA
  ``kernels/csrc/window_attention.cu``).

A wrapper takes its plain version only for CPU tensors; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.kernels.build import library
from karanta_tpu_torch.ops.rotary import apply_rope

NEG_INF = -1e30

# head dims with a kernel instantiation (csrc dispatch switches)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128)
WINDOW_HEAD_DIMS = (16, 64, 80)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
                  scale: Optional[float] = None, q_offset: int = 0
                  ) -> torch.Tensor:
    """Dense attention in float32. q (B,Sq,H,D), k/v (B,Sk,KVH,D)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = d ** -0.5 if scale is None else scale
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None, None], s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor,        # (B, 1, H, D)
                     k_cache: torch.Tensor,  # (B, KVH, M, D)
                     v_cache: torch.Tensor,  # (B, KVH, M, D)
                     kv_mask: torch.Tensor,  # (B, M) 1 = valid
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,  # (B, KVH, M)
                     v_scale: Optional[torch.Tensor] = None,
                     ) -> torch.Tensor:
    """Single-token decode attention over per-slot caches, GQA-aware. With
    k_scale/v_scale the caches hold int8 rows whose scales fold into the
    float32 scores and probabilities."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[1]
    group = h // kvh
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, kvh, group, d).float()
    s = torch.einsum("bkgd,bkmd->bkgm", qg, k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    out = torch.einsum("bkgm,bkmd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_multi(q: torch.Tensor,          # (B, T, H, D)
                           k_cache: torch.Tensor,    # (B, KVH, M, D)
                           v_cache: torch.Tensor,    # (B, KVH, M, D)
                           cache_len: torch.Tensor,  # (B,) rows before the T
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """T-query decode attention for speculative verification, over caches in
    which the T new rows are already written at cache_len + [0, T): query t
    attends rows [0, cache_len + t]. With k_scale/v_scale (B, KVH, M) the
    caches hold int8 rows whose scales fold into the float32 scores and
    probabilities. This is the bf16 cache's verify attention (the JAX
    package's XLA path) and the oracle of the int8 multi-token kernel."""
    b, tq, h, d = q.shape
    kvh, m = k_cache.shape[1], k_cache.shape[2]
    group = h // kvh
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, tq, kvh, group, d).float()
    s = torch.einsum("btkgd,bkmd->bkgtm", qg, k_cache.float()) * scale
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, None, :]
    cols = torch.arange(m, device=q.device)[None, None, :]
    horizon = (cache_len.long()[:, None, None]
               + torch.arange(tq, device=q.device)[None, :, None])
    valid = cols <= horizon                                   # (B, T, M)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, None, :]
    out = torch.einsum("bkgtm,bkmd->bkgtd", p, v_cache.float())
    out = out.permute(0, 3, 1, 2, 4)                          # (B, T, KVH, G, D)
    return out.reshape(b, tq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, kv_mask=None, causal=False, scale=None,
                          q_offset=0):
    """The plain PyTorch version of the flash kernel (dense softmax)."""
    return mha_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                         scale=scale, q_offset=q_offset)


@functools.cache
def _flash_fn():
    fn = library("flash_attention").karanta_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention. q (B,Sq,H,D), k/v (B,Sk,KVH,D), kv_mask (B,Sk) f32.

    q_offset shifts query positions for causal masking (query row i sits at
    q_offset + i). On CUDA tensors this launches the CUDA kernel; CPU
    tensors take the plain version."""
    b, sq, h, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)} "
                         f"!= {(b, k.shape[1])}")
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kv_mask, causal, scale, q_offset)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if kv_mask is not None and kv_mask.dtype != torch.float32:
        raise TypeError("flash_attention: kv_mask must be float32")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: no kernel for head dim {d}")
    kernels.check_cuda_inputs("flash_attention", q.dtype, q=q, k=k, v=v,
                              kv_mask=kv_mask)
    out = torch.empty_like(q)
    code = _flash_fn()(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(kv_mask),
        kernels.ptr(out), b, sq, k.shape[1], h, k.shape[2], d, scale,
        int(causal), int(q_offset), kernels.DTYPE_CODES[q.dtype],
        kernels.stream_ptr(q.device))
    kernels.raise_on_error("flash_attention", code)
    kernels.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_info(d: int) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per block
    and resident blocks per SM of the flash kernel's bf16 (tensor-core)
    instance for head dim d, as the CUDA runtime reports them (needs the
    card)."""
    fn = library("flash_attention").karanta_flash_attention_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    info = (ctypes.c_int * 4)()
    kernels.raise_on_error("flash_attention_info", fn(d, info))
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
              scale: Optional[float] = None, q_offset: int = 0
              ) -> torch.Tensor:
    """Dispatcher used by the models: the flash kernel on the card, its plain
    version on the CPU (forward only; training is not ported yet)."""
    return flash_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                           scale=scale, q_offset=q_offset)


# ---------------------------------------------------------------------------
# window attention: kernel wrapper + plain version
# ---------------------------------------------------------------------------

def _window_reference(q, k, v, window: int, kv_mask, scale):
    """Dense batched-windows attention: (B, S, H, D) -> same, block-diagonal
    over contiguous `window`-token segments."""
    b, sq, h, d = q.shape
    nw = sq // window
    scale = float(d ** -0.5 if scale is None else scale)
    qb = q.reshape(b * nw, window, h, d)
    kb = k.reshape(b * nw, window, h, d)
    vb = v.reshape(b * nw, window, h, d)
    mb = None if kv_mask is None else kv_mask.reshape(b * nw, window)
    out = mha_reference(qb, kb, vb, kv_mask=mb, scale=scale)
    return out.reshape(b, sq, h, d)


def window_attention_plain(q, k, v, window: int, kv_mask=None, scale=None,
                           cos=None, sin=None):
    """The plain PyTorch version of the window kernel: rope (when cos/sin
    are given) rounded to the activations' dtype, then dense windows. The
    kernel's bf16 instance, like the TPU kernel (``attention.py:342-343``),
    rounds the normalised probabilities to bf16 before P.V; this version
    keeps them in float32."""
    if cos is not None:
        q, k = apply_rope(q, k, cos, sin)
    return _window_reference(q, k, v, window, kv_mask, scale)


@functools.cache
def _window_fn():
    fn = library("window_attention").karanta_window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def window_attention_kernel_call(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, window: int,
                                 kv_mask: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None,
                                 cos: Optional[torch.Tensor] = None,
                                 sin: Optional[torch.Tensor] = None,
                                 ) -> torch.Tensor:
    """Window attention, q/k/v (B, S, H, D) with S a multiple of `window`.

    With cos/sin (B, S, D) q and k are pre-rotation and rope is applied
    inside the kernel. Outputs of rows whose window has no live key are
    unspecified (the vision encoder discards those rows)."""
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("window attention: q, k, v must share one shape")
    if s % window:
        raise ValueError(f"window attention: S={s} is not a multiple of "
                         f"window={window}")
    if (cos is None) != (sin is None):
        raise ValueError("window attention: pass both cos and sin, or neither")
    if cos is not None and tuple(cos.shape) != (b, s, d):
        raise ValueError(f"window attention: cos {tuple(cos.shape)} != "
                         f"{(b, s, d)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, s):
        raise ValueError(f"window attention: kv_mask {tuple(kv_mask.shape)} "
                         f"!= {(b, s)}")
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return window_attention_plain(q, k, v, window, kv_mask, scale, cos,
                                      sin)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("window attention: q, k, v must share one dtype")
    if d not in WINDOW_HEAD_DIMS:
        raise ValueError(f"window attention: no kernel for head dim {d}")
    if window % 16 or window > 256:
        raise ValueError(f"window attention: window {window} must be a "
                         f"multiple of 16 and at most 256")
    if kv_mask is not None and kv_mask.dtype != torch.float32:
        raise TypeError("window attention: kv_mask must be float32")
    if cos is not None and (cos.dtype != torch.float32
                            or sin.dtype != torch.float32):
        raise TypeError("window attention: cos/sin must be float32")
    kernels.check_cuda_inputs("window_attention", q.dtype, q=q, k=k, v=v,
                              kv_mask=kv_mask, cos=cos, sin=sin)
    out = torch.empty_like(q)
    code = _window_fn()(
        kernels.ptr(q), kernels.ptr(k), kernels.ptr(v), kernels.ptr(kv_mask),
        kernels.ptr(cos), kernels.ptr(sin), kernels.ptr(out), b, s, h, d,
        window, scale, kernels.DTYPE_CODES[q.dtype],
        kernels.stream_ptr(q.device))
    kernels.raise_on_error("window_attention", code)
    kernels.LAUNCHES["window_attention"] += 1
    return out


def window_attention_info(d: int, window: int) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per block,
    resident blocks per SM and heads per block of the window kernel's bf16
    (tensor-core) instance for head dim d and `window`, as the CUDA runtime
    reports them (needs the card)."""
    fn = library("window_attention").karanta_window_attention_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info = (ctypes.c_int * 5)()
    kernels.raise_on_error("window_attention_info", fn(d, window, info))
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm", "heads_per_block"), info))


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, kv_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention restricted to contiguous `window`-token segments (no rope)."""
    return window_attention_kernel_call(q, k, v, window, kv_mask=kv_mask,
                                        scale=scale)
