"""Fused int8-KV append + decode attention (port of
``karanta_tpu/ops/decode_attention.py:887 paged_decode_append_quant``).

``paged_decode_append_quant`` writes one decode step's int8 K/V rows and
their scales at ``cache_len`` of one layer of the stacked
``(L, B, KVH, M, D)`` cache, IN PLACE (the TPU kernel aliases the four
buffers through ``input_output_aliases``; here the tensors themselves are
updated), then attends over rows ``[0, cache_len)`` and folds the new row in
last, in float32. On CUDA tensors it launches
``kernels/csrc/decode_append_quant.cu``; CPU tensors take the plain version
below, which does the same two-part sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.kernels.build import library

NEG_INF = -1e30


def paged_decode_append_quant_plain(q, new_k, new_v, new_ks, new_vs, k_cache,
                                    v_cache, ks_cache, vs_cache, layer: int,
                                    cache_len, scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """The plain PyTorch version of the kernel; updates the caches in place.

    Old rows [0, cache_len) are summed first (scores scaled by the K row
    scales, probabilities by the V row scales), then the new row joins in
    float32 from its int8 value times its scale, as the kernel does."""
    b, _, h, d = q.shape
    kvh, m = k_cache.shape[2], k_cache.shape[3]
    g = h // kvh
    scale = float(d ** -0.5 if scale is None else scale)
    lens = cache_len.long().clamp(0, m - 1)
    bidx = torch.arange(b, device=q.device)
    k_cache[layer, bidx, :, lens] = new_k
    v_cache[layer, bidx, :, lens] = new_v
    ks_cache[layer, bidx, :, lens] = new_ks.to(ks_cache.dtype)
    vs_cache[layer, bidx, :, lens] = new_vs.to(vs_cache.dtype)

    qg = q.reshape(b, kvh, g, d).float()
    live = (torch.arange(m, device=q.device)[None, :] < lens[:, None])
    live = live[:, None, None, :]                                # (B,1,1,M)
    s = torch.einsum("bkgd,bkmd->bkgm", qg, k_cache[layer].float())
    s = s * ks_cache[layer].float()[:, :, None, :] * scale
    s = torch.where(live, s, NEG_INF)
    m_old = s.amax(dim=-1)                                       # (B,KVH,G)
    p = torch.where(live, torch.exp(s - m_old[..., None]), 0.0)
    l_old = p.sum(dim=-1)
    p = p * vs_cache[layer].float()[:, :, None, :]
    acc = torch.einsum("bkgm,bkmd->bkgd", p, v_cache[layer].float())

    nk = new_k.float() * new_ks.float()[..., None]               # (B,KVH,D)
    s_x = (qg * nk[:, :, None, :]).sum(dim=-1) * scale           # (B,KVH,G)
    m_new = torch.maximum(m_old, s_x)
    p_x = torch.exp(s_x - m_new)
    alpha = torch.exp(m_old - m_new)
    l = alpha * l_old + p_x
    nv = new_v.float() * new_vs.float()[..., None]
    acc = acc * alpha[..., None] + p_x[..., None] * nv[:, :, None, :]
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(b, 1, h, d).to(q.dtype)


@functools.cache
def _decode_fns():
    lib = library("decode_append_quant")
    fn = lib.karanta_decode_append_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


def paged_decode_append_quant(
    q: torch.Tensor,          # (B, 1, H, D)
    new_k: torch.Tensor,      # (B, KVH, D) int8 quantized rows
    new_v: torch.Tensor,      # (B, KVH, D) int8
    new_ks: torch.Tensor,     # (B, KVH) row scales, the caches' scale dtype
    new_vs: torch.Tensor,     # (B, KVH)
    k_cache: torch.Tensor,    # (L, B, KVH, M, D) int8, updated in place
    v_cache: torch.Tensor,    # (L, B, KVH, M, D) int8, updated in place
    ks_cache: torch.Tensor,   # (L, B, KVH, M), updated in place
    vs_cache: torch.Tensor,   # (L, B, KVH, M), updated in place
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32 rows already present (< M)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Append this step's rows at cache_len (in place) and attend over the
    live prefix plus the new row. Returns attn (B, 1, H, D)."""
    b, one, h, d = q.shape
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError("paged_decode_append_quant: caches must be "
                         "(L, B, KVH, M, D) and equal in shape")
    n_layers, cb, kvh, m, cd = k_cache.shape
    if one != 1 or cb != b or cd != d or h % kvh:
        raise ValueError(f"paged_decode_append_quant: q {tuple(q.shape)} does "
                         f"not fit cache {tuple(k_cache.shape)}")
    for name, t, shape in (("new_k", new_k, (b, kvh, d)),
                           ("new_v", new_v, (b, kvh, d)),
                           ("new_ks", new_ks, (b, kvh)),
                           ("new_vs", new_vs, (b, kvh)),
                           ("ks_cache", ks_cache, (n_layers, b, kvh, m)),
                           ("vs_cache", vs_cache, (n_layers, b, kvh, m)),
                           ("cache_len", cache_len, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_append_quant: {name} "
                             f"{tuple(t.shape)} != {shape}")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"paged_decode_append_quant: layer {layer} out of "
                         f"range for {n_layers} layers")
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_append_quant_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
            vs_cache, int(layer), cache_len, scale)
    for name, t in (("new_k", new_k), ("new_v", new_v), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.dtype != torch.int8:
            raise TypeError(f"paged_decode_append_quant: {name} must be int8")
    for name, t in (("new_ks", new_ks), ("new_vs", new_vs),
                    ("ks_cache", ks_cache), ("vs_cache", vs_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"paged_decode_append_quant: {name} must have "
                            f"q's dtype {q.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError("paged_decode_append_quant: cache_len must be int32")
    fn, supported = _decode_fns()
    if not supported(d, h // kvh):
        raise ValueError(f"paged_decode_append_quant: no kernel for head dim "
                         f"{d} with {h // kvh} query heads per kv head")
    kernels.check_cuda_inputs(
        "paged_decode_append_quant", q.dtype, q=q, new_k=new_k, new_v=new_v,
        new_ks=new_ks, new_vs=new_vs, k_cache=k_cache, v_cache=v_cache,
        ks_cache=ks_cache, vs_cache=vs_cache, cache_len=cache_len)
    out = torch.empty_like(q)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              b, kvh, h // kvh, m, d, int(layer), scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append_quant", code)
    kernels.LAUNCHES["paged_decode_append_quant"] += 1
    return out
