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

``attention`` and ``window_attention`` are differentiable: each is a
``torch.autograd.Function`` whose forward is the kernel (its plain version
on the CPU) and whose backward is the JAX package's math in plain PyTorch
(``_attention_bwd_math``: the flash-attention-2 recurrence over 512-row kv
blocks and 512-row query chunks; the window backward recomputes the dense
windows and differentiates them). Under ``torch.utils.checkpoint`` the
recompute runs the forward, and so the kernel, again.
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

# head dims with a kernel instantiation (csrc dispatch switches); the flash
# kernel's float32 instance also takes 8 (the tiny SegFormer's heads)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128)
FLASH_F32_HEAD_DIMS = (8,) + FLASH_HEAD_DIMS
WINDOW_HEAD_DIMS = (16, 64, 80)
# the fields of window_attention_info, in the C entry's order
WINDOW_INFO_KEYS = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm",
                    "heads_per_item", "stages", "consumer_warpgroups",
                    "producer_registers", "consumer_registers",
                    "cos_sin_staged")


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
    if d not in (FLASH_F32_HEAD_DIMS if q.dtype == torch.float32
                 else FLASH_HEAD_DIMS):
        raise ValueError(f"flash_attention: no kernel for head dim {d} in "
                         f"{q.dtype}")
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


def flash_attention_info(d: int, dtype: torch.dtype = torch.bfloat16
                         ) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per block
    and resident blocks per SM of the flash kernel's instance for head dim d
    in `dtype` (bf16 or float32), as the CUDA runtime reports them (needs
    the card); for bf16 also the registers a producer and a consumer
    thread hold after the kernel reallocates them."""
    if d not in (FLASH_F32_HEAD_DIMS if dtype == torch.float32
                 else FLASH_HEAD_DIMS):
        raise ValueError(f"flash_attention_info: no kernel for head dim {d} "
                         f"in {dtype}")
    fn = library("flash_attention").karanta_flash_attention_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info = (ctypes.c_int * 4)()
    kernels.raise_on_error("flash_attention_info",
                           fn(d, kernels.DTYPE_CODES[dtype], info))
    out = dict(zip(("registers", "spill_bytes", "smem_bytes",
                    "blocks_per_sm"), info))
    if dtype == torch.bfloat16:
        # the warp-specialised instance moves registers between its roles
        roles = library("flash_attention").karanta_flash_attention_roles
        roles.restype = ctypes.c_int
        roles.argtypes = [ctypes.c_void_p]
        regs = (ctypes.c_int * 2)()
        kernels.raise_on_error("flash_attention_info", roles(regs))
        out.update(producer_registers=regs[0], consumer_registers=regs[1])
    return out


# ---------------------------------------------------------------------------
# Differentiable attention: the flash kernel forward + the blockwise backward
# of the JAX package (``karanta_tpu/ops/attention.py:469-633``), which
# recomputes scores one kv block at a time from the saved q/k/v: one pass
# rebuilds the row logsumexp, a second accumulates dq and emits per-block
# dk/dv. Extra memory is O(Sq * block), never O(Sq * Sk).
# ---------------------------------------------------------------------------

_BWD_BLOCK = 512
_BWD_Q_CHUNK = 512


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_rows(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 up to `rows`."""
    pad = rows - x.shape[1]
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return torch.nn.functional.pad(x, widths, value=value)


def _score_block(qf, kb, maskb, causal, scale, q_offset, k_start):
    """Masked float32 scores for one kv block: (B, KVH, G, Sq, BLK)."""
    s = torch.einsum("bqkgd,bmkd->bkgqm", qf, kb) * scale
    valid = maskb[:, None, None, None, :] > 0
    if causal:
        sq, blk = qf.shape[1], kb.shape[1]
        qpos = q_offset + torch.arange(sq, device=qf.device)[:, None]
        kpos = k_start + torch.arange(blk, device=qf.device)[None, :]
        valid = valid & (qpos >= kpos)[None, None, None]
    return torch.where(valid, s, NEG_INF)


def _attention_bwd_math(q, k, v, kv_mask, out, dout, causal, scale,
                        q_offset):
    """dq, dk, dv of flash attention in float32, cast to the inputs' dtypes."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = float(d ** -0.5 if scale is None else scale)
    blk = min(_BWD_BLOCK, max(_round_up(sk, 128), 128))
    sk_p = _round_up(sk, blk)
    nblk = sk_p // blk

    mask = (torch.ones((b, sk), dtype=torch.float32, device=q.device)
            if kv_mask is None else kv_mask.float())
    mask = _pad_rows(mask, sk_p)
    kb_all = _pad_rows(k.float(), sk_p).reshape(b, nblk, blk, kvh, d)
    vb_all = _pad_rows(v.float(), sk_p).reshape(b, nblk, blk, kvh, d)
    mb_all = mask.reshape(b, nblk, blk)
    qf = q.float().reshape(b, sq, kvh, group, d)
    # causal: a kv block past the last query's position holds only masked
    # scores, whose probabilities are exactly 0; skipping it changes no bit
    live = [not causal or j * blk <= q_offset + sq - 1 for j in range(nblk)]

    # pass 1: row logsumexp by online max/sum
    m = torch.full((b, kvh, group, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, kvh, group, sq), device=q.device)
    for j in range(nblk):
        if not live[j]:
            continue
        s = _score_block(qf, kb_all[:, j], mb_all[:, j], causal, scale,
                         q_offset, j * blk)
        m_new = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))        # (B, KVH, G, Sq)

    # pass 2: dq accumulates across blocks; dk/dv per block
    doutf = dout.float().reshape(b, sq, kvh, group, d)
    outf = out.float().reshape(b, sq, kvh, group, d)
    drow = torch.einsum("bqkgd,bqkgd->bkgq", doutf, outf)  # rowsum(dO * O)
    dq = torch.zeros((b, sq, kvh, group, d), device=q.device)
    dks, dvs = [], []
    for j in range(nblk):
        kb, vb = kb_all[:, j], vb_all[:, j]
        if not live[j]:
            dks.append(torch.zeros_like(kb))
            dvs.append(torch.zeros_like(vb))
            continue
        s = _score_block(qf, kb, mb_all[:, j], causal, scale, q_offset,
                         j * blk)
        p = torch.exp(s - lse[..., None])                 # (B,KVH,G,Sq,BLK)
        dvs.append(torch.einsum("bkgqm,bqkgd->bmkd", p, doutf))
        dp = torch.einsum("bqkgd,bmkd->bkgqm", doutf, vb)
        ds = p * (dp - drow[..., None])
        dq = dq + torch.einsum("bkgqm,bmkd->bqkgd", ds, kb) * scale
        dks.append(torch.einsum("bkgqm,bqkgd->bmkd", ds, qf) * scale)
    dk = torch.cat(dks, 1)[:, :sk]
    dv = torch.cat(dvs, 1)[:, :sk]
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _attention_bwd_q_chunked(q, k, v, kv_mask, out, dout, causal, scale,
                             q_offset):
    """The backward over 512-row query chunks: each chunk's dq accumulator
    stays small; dk/dv sum over the chunks in float32."""
    sq = q.shape[1]
    cq = _BWD_Q_CHUNK
    sq_p = _round_up(sq, cq)
    qp, op, dp = (_pad_rows(x, sq_p) for x in (q, out, dout))
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dqs = []
    for i in range(sq_p // cq):
        rows = slice(i * cq, (i + 1) * cq)
        dq_c, dk_c, dv_c = _attention_bwd_math(
            qp[:, rows], k, v, kv_mask, op[:, rows], dp[:, rows], causal,
            scale, q_offset + i * cq)
        dqs.append(dq_c)
        dk = dk + dk_c.float()
        dv = dv + dv_c.float()
    return torch.cat(dqs, 1)[:, :sq], dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttentionFn(torch.autograd.Function):
    """The flash kernel (plain version on the CPU) with the blockwise
    backward above. kv_mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, q_offset):
        out = flash_attention(q, k, v, kv_mask=kv_mask, causal=causal,
                              scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, kv_mask, out)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out = ctx.saved_tensors
        bwd = (_attention_bwd_q_chunked if q.shape[1] > _BWD_Q_CHUNK
               else _attention_bwd_math)
        dq, dk, dv = bwd(q, k, v, kv_mask, out, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: Optional[torch.Tensor] = None, causal: bool = False,
              scale: Optional[float] = None, q_offset: int = 0
              ) -> torch.Tensor:
    """Dispatcher used by the models: the flash kernel on the card, its plain
    version on the CPU; differentiable in q, k and v on both (the JAX
    package's blockwise backward, in plain PyTorch)."""
    return _FlashAttentionFn.apply(q, k, v, kv_mask, causal, scale, q_offset)


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
    """The window kernel's bf16 instance for head dim d and `window` with
    rope and a mask, as the CUDA runtime reports it (needs the card):
    registers and spilled bytes per thread, dynamic shared bytes per block,
    resident blocks per SM, heads an item, ring stages, consumer
    warpgroups, the producer's and the consumers' registers after
    ``setmaxnreg``, and whether cos/sin are staged in shared memory (1) or
    read in place (0)."""
    fn = library("window_attention").karanta_window_attention_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    info = (ctypes.c_int * len(WINDOW_INFO_KEYS))()
    kernels.raise_on_error("window_attention_info", fn(d, window, info))
    return dict(zip(WINDOW_INFO_KEYS, info))


class _WindowAttentionFn(torch.autograd.Function):
    """The window kernel's no-rope instance (plain version on the CPU) with
    the JAX package's backward: recompute the dense windows
    (``_window_reference``) and differentiate them; each window's scores are
    (window, window), so the memory is small."""

    @staticmethod
    def forward(ctx, q, k, v, window, kv_mask, scale):
        out = window_attention_kernel_call(q, k, v, window, kv_mask=kv_mask,
                                           scale=scale)
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.args = (window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        window, scale = ctx.args
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = _window_reference(*qkv, window, kv_mask, scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, kv_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention restricted to contiguous `window`-token segments (no rope),
    differentiable in q, k and v: the kernel forward, the dense-windows
    backward."""
    return _WindowAttentionFn.apply(q, k, v, window, kv_mask, scale)
