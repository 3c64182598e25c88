"""Fused KV append + decode attention (port of three functions of
``karanta_tpu/ops/decode_attention.py``).

Each writes this step's K/V rows into one layer of the stacked
``(L, B, KVH, M, D)`` cache IN PLACE (the TPU kernels alias the buffers
through ``input_output_aliases``; here the tensors themselves are updated),
attends over the live rows ``[0, cache_len)`` and then folds the new rows in
last, in float32:

- ``paged_decode_append_quant`` (``:887``): one int8 row and its scale per
  slot, ``kernels/csrc/decode_append_quant.cu``;
- ``paged_decode_append_multi_quant`` (``:1245``): T int8 rows per slot at
  ``cache_len + [0, T)``, query t seeing the fresh rows ``t_k <= t`` (the
  speculative verify pass), ``kernels/csrc/decode_append_multi_quant.cu``;
- ``paged_decode_append`` (``:582``): one row per slot in the cache's own
  dtype (the bf16 cache), ``kernels/csrc/decode_append.cu``.

On CUDA tensors each wrapper launches its kernel; CPU tensors take the plain
version beside it, which does the same two-part sum.
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


# ---------------------------------------------------------------------------
# multi-token int8 append (the speculative verify pass)
# ---------------------------------------------------------------------------

def paged_decode_append_multi_quant_plain(q, new_k, new_v, new_ks, new_vs,
                                          k_cache, v_cache, ks_cache,
                                          vs_cache, layer: int, cache_len,
                                          scale: Optional[float] = None
                                          ) -> torch.Tensor:
    """The plain PyTorch version of the multi-token kernel; updates the
    caches in place.

    Writes the T rows at cache_len + [0, T), sums the old rows
    [0, cache_len) for all T queries, then folds the fresh rows in one at a
    time, t_k = 0..T-1, each dequantized in float32 and visible to the
    queries t_q >= t_k, as the kernel does."""
    b, tq, h, d = q.shape
    kvh, m = k_cache.shape[2], k_cache.shape[3]
    g = h // kvh
    scale = float(d ** -0.5 if scale is None else scale)
    lens = cache_len.long().clamp(0, m - tq)
    bidx = torch.arange(b, device=q.device)[:, None]
    wpos = lens[:, None] + torch.arange(tq, device=q.device)[None]   # (B, T)
    k_cache[layer, bidx, :, wpos] = new_k
    v_cache[layer, bidx, :, wpos] = new_v
    ks_cache[layer, bidx, :, wpos] = new_ks.to(ks_cache.dtype)
    vs_cache[layer, bidx, :, wpos] = new_vs.to(vs_cache.dtype)

    qg = q.reshape(b, tq, kvh, g, d).permute(0, 2, 3, 1, 4).float()  # B,K,G,T,D
    live = (torch.arange(m, device=q.device)[None, :] < lens[:, None])
    live = live[:, None, None, None, :]                          # (B,1,1,1,M)
    s = torch.einsum("bkgtd,bkmd->bkgtm", qg, k_cache[layer].float())
    s = s * ks_cache[layer].float()[:, :, None, None, :] * scale
    s = torch.where(live, s, NEG_INF)
    m_run = s.amax(dim=-1)                                       # (B,K,G,T)
    p = torch.where(live, torch.exp(s - m_run[..., None]), 0.0)
    l_run = p.sum(dim=-1)
    p = p * vs_cache[layer].float()[:, :, None, None, :]
    acc = torch.einsum("bkgtm,bkmd->bkgtd", p, v_cache[layer].float())

    t_q = torch.arange(tq, device=q.device)
    for t in range(tq):
        nk = new_k[:, t].float() * new_ks[:, t].float()[..., None]  # (B,K,D)
        s_x = (qg * nk[:, :, None, None, :]).sum(dim=-1) * scale   # (B,K,G,T)
        s_x = torch.where(t_q >= t, s_x, NEG_INF)
        m_new = torch.maximum(m_run, s_x)
        p_x = torch.exp(s_x - m_new)
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p_x
        m_run = m_new
        nv = new_v[:, t].float() * new_vs[:, t].float()[..., None]
        acc = acc * alpha[..., None] + p_x[..., None] * nv[:, :, None, None, :]
    l_run = torch.where(l_run == 0.0, torch.ones_like(l_run), l_run)
    out = (acc / l_run[..., None]).permute(0, 3, 1, 2, 4)        # B,T,K,G,D
    return out.reshape(b, tq, h, d).to(q.dtype)


@functools.cache
def _multi_fns():
    lib = library("decode_append_multi_quant")
    fn = lib.karanta_decode_append_multi_quant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_multi_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


def paged_decode_append_multi_quant(
    q: torch.Tensor,          # (B, T, H, D)
    new_k: torch.Tensor,      # (B, T, KVH, D) int8 quantized rows
    new_v: torch.Tensor,      # (B, T, KVH, D) int8
    new_ks: torch.Tensor,     # (B, T, KVH) row scales, the caches' dtype
    new_vs: torch.Tensor,     # (B, T, KVH)
    k_cache: torch.Tensor,    # (L, B, KVH, M, D) int8, updated in place
    v_cache: torch.Tensor,    # (L, B, KVH, M, D) int8, updated in place
    ks_cache: torch.Tensor,   # (L, B, KVH, M), updated in place
    vs_cache: torch.Tensor,   # (L, B, KVH, M), updated in place
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32 rows present before the T new ones
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Append T rows per slot at cache_len + [0, T) (in place) and attend:
    query t sees rows [0, cache_len + t]. Returns attn (B, T, H, D).

    The caller keeps cache_len + T <= M - 1 (the engine clamps exactly that
    from its host mirror); the kernel clamps cache_len to M - T only so that
    a bad value cannot write outside the slot."""
    b, tq, h, d = q.shape
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError("paged_decode_append_multi_quant: caches must be "
                         "(L, B, KVH, M, D) and equal in shape")
    n_layers, cb, kvh, m, cd = k_cache.shape
    if cb != b or cd != d or h % kvh or not 1 <= tq <= m:
        raise ValueError(f"paged_decode_append_multi_quant: q "
                         f"{tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    for name, t, shape in (("new_k", new_k, (b, tq, kvh, d)),
                           ("new_v", new_v, (b, tq, kvh, d)),
                           ("new_ks", new_ks, (b, tq, kvh)),
                           ("new_vs", new_vs, (b, tq, kvh)),
                           ("ks_cache", ks_cache, (n_layers, b, kvh, m)),
                           ("vs_cache", vs_cache, (n_layers, b, kvh, m)),
                           ("cache_len", cache_len, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_append_multi_quant: {name} "
                             f"{tuple(t.shape)} != {shape}")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"paged_decode_append_multi_quant: layer {layer} "
                         f"out of range for {n_layers} layers")
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_append_multi_quant_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
            vs_cache, int(layer), cache_len, scale)
    for name, t in (("new_k", new_k), ("new_v", new_v), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.dtype != torch.int8:
            raise TypeError(f"paged_decode_append_multi_quant: {name} must "
                            f"be int8")
    for name, t in (("new_ks", new_ks), ("new_vs", new_vs),
                    ("ks_cache", ks_cache), ("vs_cache", vs_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"paged_decode_append_multi_quant: {name} must "
                            f"have q's dtype {q.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError("paged_decode_append_multi_quant: cache_len must be "
                        "int32")
    fn, supported = _multi_fns()
    g = h // kvh
    if not supported(d, g * tq):
        raise ValueError(f"paged_decode_append_multi_quant: no kernel for "
                         f"head dim {d} with {g} query heads per kv head x "
                         f"{tq} tokens")
    kernels.check_cuda_inputs(
        "paged_decode_append_multi_quant", q.dtype, q=q, new_k=new_k,
        new_v=new_v, new_ks=new_ks, new_vs=new_vs, k_cache=k_cache,
        v_cache=v_cache, ks_cache=ks_cache, vs_cache=vs_cache,
        cache_len=cache_len)
    out = torch.empty_like(q)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              b, tq, kvh, g, m, d, int(layer), scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append_multi_quant", code)
    kernels.LAUNCHES["paged_decode_append_multi_quant"] += 1
    return out


# ---------------------------------------------------------------------------
# single-token append over a cache in the activations' dtype (bf16 cache)
# ---------------------------------------------------------------------------

def paged_decode_append_plain(q, new_k, new_v, k_cache, v_cache, layer: int,
                              cache_len, scale: Optional[float] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version of the bf16-cache kernel; updates the caches
    in place. The new row is cast to the cache dtype, written at cache_len,
    and folded in after the old rows [0, cache_len), as the kernel does."""
    b, _, h, d = q.shape
    kvh, m = k_cache.shape[2], k_cache.shape[3]
    g = h // kvh
    scale = float(d ** -0.5 if scale is None else scale)
    lens = cache_len.long().clamp(0, m - 1)
    bidx = torch.arange(b, device=q.device)
    new_k = new_k.to(k_cache.dtype)
    new_v = new_v.to(v_cache.dtype)
    k_cache[layer, bidx, :, lens] = new_k
    v_cache[layer, bidx, :, lens] = new_v

    qg = q.reshape(b, kvh, g, d).float()
    live = (torch.arange(m, device=q.device)[None, :] < lens[:, None])
    live = live[:, None, None, :]                                # (B,1,1,M)
    s = torch.einsum("bkgd,bkmd->bkgm", qg, k_cache[layer].float()) * scale
    s = torch.where(live, s, NEG_INF)
    m_old = s.amax(dim=-1)
    p = torch.where(live, torch.exp(s - m_old[..., None]), 0.0)
    l_old = p.sum(dim=-1)
    acc = torch.einsum("bkgm,bkmd->bkgd", p, v_cache[layer].float())

    s_x = (qg * new_k.float()[:, :, None, :]).sum(dim=-1) * scale
    m_new = torch.maximum(m_old, s_x)
    p_x = torch.exp(s_x - m_new)
    alpha = torch.exp(m_old - m_new)
    l = alpha * l_old + p_x
    acc = acc * alpha[..., None] + p_x[..., None] * new_v.float()[:, :, None, :]
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).reshape(b, 1, h, d).to(q.dtype)


@functools.cache
def _append_fns():
    lib = library("decode_append")
    fn = lib.karanta_decode_append
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_append_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


def paged_decode_append(
    q: torch.Tensor,          # (B, 1, H, D)
    new_k: torch.Tensor,      # (B, KVH, D) this step's key rows
    new_v: torch.Tensor,      # (B, KVH, D)
    k_cache: torch.Tensor,    # (L, B, KVH, M, D), updated in place
    v_cache: torch.Tensor,    # (L, B, KVH, M, D), updated in place
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32 rows already present (< M)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Append this step's rows (cast to the cache dtype) at cache_len, in
    place, and attend over the live prefix plus the new row. Returns attn
    (B, 1, H, D).

    The JAX decoder takes its Pallas kernel only for KV buckets >= 8192,
    because each Pallas call costs about 125 us of TPU dispatch; on the card
    a launch costs a few us, so the port's decoder launches this kernel at
    every bucket: it computes the dense path's values and reads only the
    live rows."""
    b, one, h, d = q.shape
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError("paged_decode_append: caches must be "
                         "(L, B, KVH, M, D) and equal in shape")
    n_layers, cb, kvh, m, cd = k_cache.shape
    if one != 1 or cb != b or cd != d or h % kvh:
        raise ValueError(f"paged_decode_append: q {tuple(q.shape)} does not "
                         f"fit cache {tuple(k_cache.shape)}")
    for name, t, shape in (("new_k", new_k, (b, kvh, d)),
                           ("new_v", new_v, (b, kvh, d)),
                           ("cache_len", cache_len, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_append: {name} "
                             f"{tuple(t.shape)} != {shape}")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"paged_decode_append: layer {layer} out of range "
                         f"for {n_layers} layers")
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_append_plain(q, new_k, new_v, k_cache, v_cache,
                                         int(layer), cache_len, scale)
    for name, t in (("new_k", new_k), ("new_v", new_v), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"paged_decode_append: {name} must have q's "
                            f"dtype {q.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError("paged_decode_append: cache_len must be int32")
    fn, supported = _append_fns()
    if not supported(d, h // kvh):
        raise ValueError(f"paged_decode_append: no kernel for head dim {d} "
                         f"with {h // kvh} query heads per kv head")
    kernels.check_cuda_inputs(
        "paged_decode_append", q.dtype, q=q, new_k=new_k, new_v=new_v,
        k_cache=k_cache, v_cache=v_cache, cache_len=cache_len)
    out = torch.empty_like(q)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(k_cache), kernels.ptr(v_cache),
              kernels.ptr(cache_len), kernels.ptr(out),
              b, kvh, h // kvh, m, d, int(layer), scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append", code)
    kernels.LAUNCHES["paged_decode_append"] += 1
    return out
