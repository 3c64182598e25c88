"""Paged decode attention (port of seven functions of
``karanta_tpu/ops/decode_attention.py``).

The fused append kernels write this step's K/V rows into one layer of the
stacked cache IN PLACE (the TPU kernels alias the buffers through
``input_output_aliases``; here the tensors themselves are updated), attend
over the live rows ``[0, cache_len)`` and then fold the new rows in last, in
float32:

- ``paged_decode_append_quant`` (``:887``): one int8 row and its scale per
  slot, ``kernels/csrc/decode_append_quant.cu``;
- ``paged_decode_append_multi_quant`` (``:1245``): T int8 rows per slot at
  ``cache_len + [0, T)``, query t seeing the fresh rows ``t_k <= t`` (the
  speculative verify pass), ``kernels/csrc/decode_append_multi_quant.cu``;
- ``paged_decode_append`` (``:582``): one row per slot in the cache's own
  dtype (the bf16 cache), ``kernels/csrc/decode_append.cu``;
- ``paged_decode_append_q4`` (``:1622``) and ``paged_decode_append_multi_q4``
  (``:1998``): the int8 kernels' work over the nibble-packed int4 cache
  (layout below), ``kernels/csrc/decode_append_q4.cu`` and
  ``decode_append_multi_q4.cu``.

The read-only kernels attend over rows ``[0, cache_len]``, this step's row
having been written at ``cache_len`` before the call
(``kernels/csrc/decode_attention.cu``):

- ``paged_decode_attention`` (``:120``): a per-slot cache ``(B, KVH, M, D)``;
- ``paged_decode_attention_stacked`` (``:272``): one layer of the stacked
  cache, read in place (the decoder's stacked mode).

On CUDA tensors each wrapper launches its kernel; CPU tensors take the plain
version beside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.kernels.build import library
from karanta_tpu_torch.ops.attention import (decode_attention,
                                             decode_attention_multi)

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
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


# The bf16 instance's run-length rule over the int8 cache (measured on an
# H100 with ``python -m karanta_tpu_torch.bench.verify_runs --kernel 3``):
# split_run_rows with runs of QUANT_MIN_RUN to QUANT_MAX_RUN rows and up to
# QUANT_BLOCKS_PER_SM live blocks an SM (its blocks of 4 warps fit two an
# SM; the verify kernels' blocks of 8 warps one).
QUANT_MIN_RUN, QUANT_MAX_RUN, QUANT_BLOCKS_PER_SM = 256, 1024, 2


def quant_run_rows(b: int, kvh: int, m: int, n_sm: int,
                   max_runs: int) -> int:
    """Rows per run of the int8 decode kernel's bf16 instance for B slots,
    KVH kv heads and M cache rows on a card with n_sm SMs."""
    return split_run_rows(b, kvh, m, n_sm, QUANT_MIN_RUN, QUANT_MAX_RUN,
                          max_runs, blocks_per_sm=QUANT_BLOCKS_PER_SM)


@functools.cache
def paged_decode_append_quant_info(d: int, g: int, b: Optional[int] = None,
                                   kvh: Optional[int] = None,
                                   m: Optional[int] = None) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per
    block, resident blocks per SM and the most runs a slot may have of the
    int8 decode kernel's bf16 (tensor-core) instance for head dim d with g
    query heads per kv head, as the CUDA runtime reports them (needs the
    card); given a shape (B slots, KVH kv heads, M cache rows), also its rows
    per run on the current card."""
    info = _info("decode_append_quant", "karanta_decode_append_quant_info", d,
                 g, "max_runs")
    if b is not None:
        info["run_rows"] = quant_run_rows(
            b, kvh, m, _sm_count(torch.cuda.current_device()),
            info["max_runs"])
    return info


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
    partials = counters = None
    run_rows = 0
    if q.dtype == torch.bfloat16:
        run_rows = quant_run_rows(
            b, kvh, m, _sm_count(q.device),
            paged_decode_append_quant_info(d, h // kvh)["max_runs"])
        partials, counters = _split_workspace(q, b * kvh, -(-m // run_rows),
                                              SPLIT_PARTIAL_ROWS)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              kernels.ptr(partials), kernels.ptr(counters),
              b, kvh, h // kvh, m, d, int(layer), run_rows, scale,
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
    queries t_q >= t_k, as the kernel does. The kernel's bf16 instance, like
    the JAX kernel (``decode_attention.py:1192``), rounds p * vsc to bf16
    before P.V (relative to each warp's running max); this version keeps it
    in float32."""
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
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_multi_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


# the bf16 instance's partial record holds this many query rows (G * T);
# it folds in at most this many fresh rows
MULTI_PARTIAL_ROWS = 32
MULTI_MAX_TOKENS = 8
# The int8 verify kernel's run lengths for split_run_rows (measured on an
# H100 at B = 1..64, M = 4096 with ``python -m
# karanta_tpu_torch.bench.verify_runs``)
MULTI_MIN_RUN, MULTI_MAX_RUN = 256, 1024


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_run_rows(b: int, kvh: int, m: int, n_sm: int, lo: int, hi: int,
                   max_runs: int, blocks_per_sm: float = 0.5) -> int:
    """The split kernels' run-length rule: the shortest run of cache rows (or
    tokens), a power of two from lo to hi, that gives at most blocks_per_sm
    live blocks an SM (one per two SMs by default) when the B slots of KVH
    kv heads are half full (B * KVH * ceil(M / 2 / run) blocks); longer if a
    slot would otherwise have more than max_runs runs (what the last block
    can merge). Shorter runs put more SMs to work; longer runs leave fewer
    partials for the last block of a slot to merge, which costs more than it
    saves once the card is full."""
    run = lo
    while run < hi and b * kvh * -(-m // (2 * run)) > blocks_per_sm * n_sm:
        run *= 2
    while -(-m // run) > max_runs:
        run *= 2
    return run


def multi_quant_run_rows(b: int, kvh: int, m: int, n_sm: int,
                         max_runs: int) -> int:
    """Rows per run of the multi-token kernel's bf16 instance for B slots,
    KVH kv heads and M cache rows on a card with n_sm SMs."""
    return split_run_rows(b, kvh, m, n_sm, MULTI_MIN_RUN, MULTI_MAX_RUN,
                          max_runs)


@functools.cache
def paged_decode_append_multi_quant_info(d: int, nq: int,
                                         b: Optional[int] = None,
                                         kvh: Optional[int] = None,
                                         m: Optional[int] = None) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per block,
    resident blocks per SM and the most runs a slot may have of the
    multi-token kernel's bf16 (tensor-core) instance for head dim d with
    nq = G * T query rows per kv head, as the CUDA runtime reports them
    (needs the card); given a shape (B slots, KVH kv heads, M cache rows),
    also its rows per run on the current card."""
    info = _info("decode_append_multi_quant",
                 "karanta_decode_append_multi_quant_info", d, nq, "max_runs")
    if b is not None:
        info["run_rows"] = multi_quant_run_rows(
            b, kvh, m, _sm_count(torch.cuda.current_device()),
            info["max_runs"])
    return info


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
    if q.dtype == torch.bfloat16 and tq > MULTI_MAX_TOKENS:
        raise ValueError(f"paged_decode_append_multi_quant: the bf16 kernel "
                         f"folds in at most {MULTI_MAX_TOKENS} fresh rows, "
                         f"not {tq}")
    kernels.check_cuda_inputs(
        "paged_decode_append_multi_quant", q.dtype, q=q, new_k=new_k,
        new_v=new_v, new_ks=new_ks, new_vs=new_vs, k_cache=k_cache,
        v_cache=v_cache, ks_cache=ks_cache, vs_cache=vs_cache,
        cache_len=cache_len)
    out = torch.empty_like(q)
    partials = counters = None
    run_rows = 0
    if q.dtype == torch.bfloat16:
        run_rows = multi_quant_run_rows(
            b, kvh, m, _sm_count(q.device),
            paged_decode_append_multi_quant_info(d, g * tq)["max_runs"])
        partials, counters = _split_workspace(q, b * kvh, -(-m // run_rows),
                                              MULTI_PARTIAL_ROWS)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              kernels.ptr(partials), kernels.ptr(counters),
              b, tq, kvh, g, m, d, int(layer), run_rows, scale,
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
    and folded in after the old rows [0, cache_len), as the kernel does. The
    kernel's bf16 instance, like the JAX kernel (``decode_attention.py:487``),
    rounds P to bf16 before P.V (relative to each warp's running max); this
    version keeps it in float32."""
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
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_append_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


@functools.cache
def paged_decode_append_info(d: int, g: int) -> dict:
    """The resources of the bf16-cache append kernel's bf16 instance (the
    read-only kernels' body with the append), as
    ``paged_decode_attention_info`` reports them (needs the card)."""
    return _info("decode_append", "karanta_decode_append_info", d, g,
                 "split_rows")


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
    partials = counters = None
    if q.dtype == torch.bfloat16:
        runs = -(-m // paged_decode_append_info(d, h // kvh)["split_rows"])
        partials, counters = _split_workspace(q, b * kvh, runs,
                                              SPLIT_PARTIAL_ROWS)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(k_cache), kernels.ptr(v_cache),
              kernels.ptr(cache_len), kernels.ptr(out), kernels.ptr(partials),
              kernels.ptr(counters), b, kvh, h // kvh, m, d, int(layer), scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append", code)
    kernels.LAUNCHES["paged_decode_append"] += 1
    return out


# ---------------------------------------------------------------------------
# the nibble-packed int4 cache (models/qwen25_vl/decoder.py Q4KVCache)
# ---------------------------------------------------------------------------
#
# Within each 64-token window w, packed row 32w + j (j < 32) holds token
# 64w + j in its LOW nibble and token 64w + 32 + j in its HIGH nibble. Scales
# stay per token, in nibble-plane order (L, B, 2*KVH, M/2): row 2h + nib is
# kv head h, nibble plane nib, column = packed row. This is the JAX package's
# layout (chosen for the TPU's 32-row int8 tiles), kept so that the caches of
# the two packages compare byte for byte; the decoder re-exports these.

def bits_to_int8(u: torch.Tensor) -> torch.Tensor:
    """int32 byte values in [0, 255] -> bit-identical int8."""
    return (((u & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def pack_q4_rows(q: torch.Tensor) -> torch.Tensor:
    """(..., S, D) int8 nibbles -> (..., S/2, D) packed bytes (S % 64 == 0)."""
    *lead, s, d = q.shape
    if s % 64:
        raise ValueError(f"pack_q4_rows: {s} tokens is not a whole number of "
                         f"64-token windows")
    r = q.reshape(*lead, s // 64, 2, 32, d).to(torch.int32)
    b = (r[..., 0, :, :] & 0xF) | ((r[..., 1, :, :] & 0xF) << 4)
    return bits_to_int8(b).reshape(*lead, s // 2, d)


def unpack_q4_rows(p: torch.Tensor) -> torch.Tensor:
    """(..., S/2, D) packed -> (..., S, D) int8 nibble values, token order."""
    *lead, pm, d = p.shape
    b = p.to(torch.int32)
    both = torch.stack([(b << 28) >> 28, b >> 4], dim=-3)  # (..., 2, S/2, D)
    both = both.reshape(*lead, 2, pm // 32, 32, d).transpose(-4, -3)
    return both.reshape(*lead, 2 * pm, d).to(torch.int8)


def pack_q4_scales(s: torch.Tensor) -> torch.Tensor:
    """Per-token scales (..., KVH, S) -> nibble planes (..., 2*KVH, S/2)."""
    *lead, kvh, seq = s.shape
    if seq % 64:
        raise ValueError(f"pack_q4_scales: {seq} tokens is not a whole number "
                         f"of 64-token windows")
    r = s.reshape(*lead, kvh, seq // 64, 2, 32).movedim(-2, -3)
    return r.reshape(*lead, 2 * kvh, seq // 2)


def unpack_q4_scales(p: torch.Tensor) -> torch.Tensor:
    """Nibble planes (..., 2*KVH, S/2) -> per-token scales (..., KVH, S)."""
    *lead, kvh2, pm = p.shape
    r = p.reshape(*lead, kvh2 // 2, 2, pm // 32, 32).movedim(-3, -2)
    return r.reshape(*lead, kvh2 // 2, 2 * pm)


def q4_row_nib(pos: torch.Tensor):
    """Token position -> (packed row, nibble plane) under the pairing."""
    w, j = pos >> 6, pos & 63
    return (w << 5) + (j & 31), j >> 5


def _q4_write(k_cache, v_cache, ks_cache, vs_cache, layer: int, pos, new_k,
              new_v, new_ks, new_vs) -> None:
    """Merge one token per slot (tokens pos (B,), nibbles (B, KVH, D),
    scales (B, KVH)) into layer `layer` of the packed caches, in place: a
    read-modify-write of each token's byte that keeps its other nibble."""
    b, kvh = new_k.shape[:2]
    r, nib = q4_row_nib(pos.long())
    bidx = torch.arange(b, device=pos.device)
    low = (nib == 0)[:, None, None]
    for cache, new in ((k_cache, new_k), (v_cache, new_v)):
        old = cache[layer, bidx, :, r].to(torch.int32)        # (B, KVH, D)
        n4 = new.to(torch.int32) & 0xF
        cache[layer, bidx, :, r] = bits_to_int8(
            torch.where(low, (old & 0xF0) | n4, (old & 0x0F) | (n4 << 4)))
    rows2 = 2 * torch.arange(kvh, device=pos.device)[None, :] + nib[:, None]
    for cache, new in ((ks_cache, new_ks), (vs_cache, new_vs)):
        cache[layer, bidx[:, None], rows2, r[:, None]] = new.to(cache.dtype)


def _q4_layer(k_cache, v_cache, ks_cache, vs_cache, layer: int):
    """Layer `layer` of the packed caches unpacked to token order: nibble
    values (B, KVH, M, D) and scales (B, KVH, M)."""
    return (unpack_q4_rows(k_cache[layer]), unpack_q4_rows(v_cache[layer]),
            unpack_q4_scales(ks_cache[layer]),
            unpack_q4_scales(vs_cache[layer]))


def _check_q4(name: str, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
              ks_cache, vs_cache, layer, cache_len, tq=None) -> None:
    """Shape checks shared by the int4 wrappers."""
    b, h, d = q.shape[0], q.shape[2], q.shape[3]
    if k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must be (L, B, KVH, M/2, D) packed "
                         f"and equal in shape")
    n_layers, cb, kvh, pm, cd = k_cache.shape
    if cb != b or cd != d or h % kvh or pm % 32:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit packed "
                         f"cache {tuple(k_cache.shape)} (M/2 must be a "
                         f"multiple of 32)")
    lead = (b,) if tq is None else (b, tq)
    for key, t, shape in (("new_k", new_k, lead + (kvh, d)),
                          ("new_v", new_v, lead + (kvh, d)),
                          ("new_ks", new_ks, lead + (kvh,)),
                          ("new_vs", new_vs, lead + (kvh,)),
                          ("ks_cache", ks_cache, (n_layers, b, 2 * kvh, pm)),
                          ("vs_cache", vs_cache, (n_layers, b, 2 * kvh, pm)),
                          ("cache_len", cache_len, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != {shape}")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"{name}: layer {layer} out of range for {n_layers} "
                         f"layers")


def _check_q4_cuda(name: str, q, new_k, new_v, new_ks, new_vs, k_cache,
                   v_cache, ks_cache, vs_cache, cache_len) -> None:
    for key, t in (("new_k", new_k), ("new_v", new_v), ("k_cache", k_cache),
                   ("v_cache", v_cache)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {key} must be int8")
    for key, t in (("new_ks", new_ks), ("new_vs", new_vs),
                   ("ks_cache", ks_cache), ("vs_cache", vs_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} must have q's dtype {q.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"{name}: cache_len must be int32")
    kernels.check_cuda_inputs(
        name, q.dtype, q=q, new_k=new_k, new_v=new_v, new_ks=new_ks,
        new_vs=new_vs, k_cache=k_cache, v_cache=v_cache, ks_cache=ks_cache,
        vs_cache=vs_cache, cache_len=cache_len)


# ---------------------------------------------------------------------------
# single-token append over the int4 cache
# ---------------------------------------------------------------------------

def paged_decode_append_q4_plain(q, new_k, new_v, new_ks, new_vs, k_cache,
                                 v_cache, ks_cache, vs_cache, layer: int,
                                 cache_len, scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of the int4 kernel (the JAX decoder's dense
    branch, ``decoder.py:570-597``); updates the caches in place.

    Merges the new token's nibbles and scales at cache_len, unpacks the
    layer to token order and runs ``decode_attention`` with the scales over
    tokens [0, cache_len], in float32. The kernel sums the same terms in
    another order (old tokens, then the new one)."""
    m = 2 * k_cache.shape[3]
    lens = cache_len.long().clamp(0, m - 1)
    _q4_write(k_cache, v_cache, ks_cache, vs_cache, layer, lens, new_k, new_v,
              new_ks, new_vs)
    kt, vt, kst, vst = _q4_layer(k_cache, v_cache, ks_cache, vs_cache, layer)
    mask = (torch.arange(m, device=q.device)[None, :] <= lens[:, None]).float()
    return decode_attention(q, kt, vt, mask, scale=scale, k_scale=kst,
                            v_scale=vst)


@functools.cache
def _q4_fns():
    lib = library("decode_append_q4")
    fn = lib.karanta_decode_append_q4
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_q4_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


# The int4 decode kernel's run lengths in tokens for split_run_rows (measured
# on an H100 with ``python -m karanta_tpu_torch.bench.verify_runs --kernel
# 6``): multiples of 64, so that no 64-token window is split across runs, and
# up to Q4_BLOCKS_PER_SM live blocks an SM at half-full slots (its blocks of
# 4 warps fit two an SM, but one was faster from B = 8 on).
Q4_MIN_RUN, Q4_MAX_RUN, Q4_BLOCKS_PER_SM = 256, 1024, 1


def q4_run_tokens(b: int, kvh: int, m: int, n_sm: int, max_runs: int) -> int:
    """Tokens per run of the int4 decode kernel's bf16 instance for B slots,
    KVH kv heads and M cache tokens on a card with n_sm SMs."""
    return split_run_rows(b, kvh, m, n_sm, Q4_MIN_RUN, Q4_MAX_RUN, max_runs,
                          blocks_per_sm=Q4_BLOCKS_PER_SM)


@functools.cache
def paged_decode_append_q4_info(d: int, g: int, b: Optional[int] = None,
                                kvh: Optional[int] = None,
                                m: Optional[int] = None) -> dict:
    """The resources of the int4 decode kernel's bf16 (tensor-core)
    instance, as ``paged_decode_append_quant_info`` reports them (m in
    tokens; needs the card); given a shape, also its tokens per run."""
    info = _info("decode_append_q4", "karanta_decode_append_q4_info", d, g,
                 "max_runs")
    if b is not None:
        info["run_tokens"] = q4_run_tokens(
            b, kvh, m, _sm_count(torch.cuda.current_device()),
            info["max_runs"])
    return info


def paged_decode_append_q4(
    q: torch.Tensor,          # (B, 1, H, D)
    new_k: torch.Tensor,      # (B, KVH, D) int8 nibble values in [-7, 7]
    new_v: torch.Tensor,      # (B, KVH, D)
    new_ks: torch.Tensor,     # (B, KVH) row scales, the caches' scale dtype
    new_vs: torch.Tensor,     # (B, KVH)
    k_cache: torch.Tensor,    # (L, B, KVH, M/2, D) int8 packed, in place
    v_cache: torch.Tensor,    # (L, B, KVH, M/2, D)
    ks_cache: torch.Tensor,   # (L, B, 2*KVH, M/2) nibble planes, in place
    vs_cache: torch.Tensor,   # (L, B, 2*KVH, M/2)
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32 TOKENS already present (< M)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Merge this step's nibbles into their bytes at token cache_len (in
    place) and attend over the live tokens plus the new one. Returns attn
    (B, 1, H, D). The JAX wrapper's plane-duplicated scale rows are a Mosaic
    workaround (``:1733-1736``); this one takes the (B, KVH) scales."""
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"paged_decode_append_q4: q {tuple(q.shape)} must "
                         f"hold one token per slot")
    _check_q4("paged_decode_append_q4", q, new_k, new_v, new_ks, new_vs,
              k_cache, v_cache, ks_cache, vs_cache, layer, cache_len)
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_append_q4_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
            vs_cache, int(layer), cache_len, scale)
    _check_q4_cuda("paged_decode_append_q4", q, new_k, new_v, new_ks, new_vs,
                   k_cache, v_cache, ks_cache, vs_cache, cache_len)
    kvh = k_cache.shape[2]
    fn, supported = _q4_fns()
    if not supported(d, h // kvh):
        raise ValueError(f"paged_decode_append_q4: no kernel for head dim {d} "
                         f"with {h // kvh} query heads per kv head")
    out = torch.empty_like(q)
    pm = k_cache.shape[3]
    partials = counters = None
    run_tokens = 0
    if q.dtype == torch.bfloat16:
        run_tokens = q4_run_tokens(
            b, kvh, 2 * pm, _sm_count(q.device),
            paged_decode_append_q4_info(d, h // kvh)["max_runs"])
        partials, counters = _split_workspace(
            q, b * kvh, -(-2 * pm // run_tokens), SPLIT_PARTIAL_ROWS)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              kernels.ptr(partials), kernels.ptr(counters),
              b, kvh, h // kvh, pm, d, int(layer), run_tokens, scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append_q4", code)
    kernels.LAUNCHES["paged_decode_append_q4"] += 1
    return out


# ---------------------------------------------------------------------------
# multi-token append over the int4 cache (the speculative verify pass)
# ---------------------------------------------------------------------------

def paged_decode_append_multi_q4_plain(q, new_k, new_v, new_ks, new_vs,
                                       k_cache, v_cache, ks_cache, vs_cache,
                                       layer: int, cache_len,
                                       scale: Optional[float] = None
                                       ) -> torch.Tensor:
    """The plain PyTorch version of the multi-token int4 kernel (the JAX
    decoder's dense branch, ``decoder.py:727-762``); updates the caches in
    place. Merges the T tokens one at a time, then runs
    ``decode_attention_multi`` with the scales over the unpacked layer, in
    float32: query t sees tokens [0, cache_len + t]."""
    tq = q.shape[1]
    m = 2 * k_cache.shape[3]
    lens = cache_len.long().clamp(0, m - tq)
    for t in range(tq):
        _q4_write(k_cache, v_cache, ks_cache, vs_cache, layer, lens + t,
                  new_k[:, t], new_v[:, t], new_ks[:, t], new_vs[:, t])
    kt, vt, kst, vst = _q4_layer(k_cache, v_cache, ks_cache, vs_cache, layer)
    return decode_attention_multi(q, kt, vt, lens, scale=scale, k_scale=kst,
                                  v_scale=vst)


@functools.cache
def _multi_q4_fns():
    lib = library("decode_append_multi_q4")
    fn = lib.karanta_decode_append_multi_q4
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_multi_q4_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return fn, supported


# The int4 verify kernel's run lengths in tokens for split_run_rows (measured
# on an H100 with ``python -m karanta_tpu_torch.bench.verify_runs --kernel
# 7``): multiples of 64, so that no 64-token window is split across runs.
MULTI_Q4_MIN_RUN, MULTI_Q4_MAX_RUN = 256, 2048


def multi_q4_run_tokens(b: int, kvh: int, m: int, n_sm: int,
                        max_runs: int) -> int:
    """Tokens per run of the int4 multi-token kernel's bf16 instance for B
    slots, KVH kv heads and M cache tokens on a card with n_sm SMs."""
    return split_run_rows(b, kvh, m, n_sm, MULTI_Q4_MIN_RUN,
                          MULTI_Q4_MAX_RUN, max_runs)


@functools.cache
def paged_decode_append_multi_q4_info(d: int, nq: int,
                                      b: Optional[int] = None,
                                      kvh: Optional[int] = None,
                                      m: Optional[int] = None) -> dict:
    """The resources of the int4 multi-token kernel's bf16 (tensor-core)
    instance, as ``paged_decode_append_multi_quant_info`` reports them (m in
    tokens; needs the card); given a shape, also its tokens per run."""
    info = _info("decode_append_multi_q4",
                 "karanta_decode_append_multi_q4_info", d, nq, "max_runs")
    if b is not None:
        info["run_tokens"] = multi_q4_run_tokens(
            b, kvh, m, _sm_count(torch.cuda.current_device()),
            info["max_runs"])
    return info


def paged_decode_append_multi_q4(
    q: torch.Tensor,          # (B, T, H, D)
    new_k: torch.Tensor,      # (B, T, KVH, D) int8 nibble values in [-7, 7]
    new_v: torch.Tensor,      # (B, T, KVH, D)
    new_ks: torch.Tensor,     # (B, T, KVH) row scales, the caches' dtype
    new_vs: torch.Tensor,     # (B, T, KVH)
    k_cache: torch.Tensor,    # (L, B, KVH, M/2, D) int8 packed, in place
    v_cache: torch.Tensor,    # (L, B, KVH, M/2, D)
    ks_cache: torch.Tensor,   # (L, B, 2*KVH, M/2) nibble planes, in place
    vs_cache: torch.Tensor,   # (L, B, 2*KVH, M/2)
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32 TOKENS present before the T new
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Merge T tokens per slot at cache_len + [0, T) (in place) and attend:
    query t sees tokens [0, cache_len + t]. Returns attn (B, T, H, D).

    T <= 32, so no two fresh tokens share a byte. The caller keeps
    cache_len + T <= M - 1 (the engine clamps exactly that); the kernel
    clamps cache_len to M - T only so that a bad value cannot write outside
    the slot."""
    b, tq, h, d = q.shape
    if not 1 <= tq <= 32:
        raise ValueError(f"paged_decode_append_multi_q4: {tq} tokens per "
                         f"slot; 1 to 32 fit the packing (two tokens of a "
                         f"byte are 32 apart)")
    _check_q4("paged_decode_append_multi_q4", q, new_k, new_v, new_ks, new_vs,
              k_cache, v_cache, ks_cache, vs_cache, layer, cache_len, tq=tq)
    scale = float(d ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_append_multi_q4_plain(
            q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, ks_cache,
            vs_cache, int(layer), cache_len, scale)
    _check_q4_cuda("paged_decode_append_multi_q4", q, new_k, new_v, new_ks,
                   new_vs, k_cache, v_cache, ks_cache, vs_cache, cache_len)
    kvh = k_cache.shape[2]
    g = h // kvh
    fn, supported = _multi_q4_fns()
    if not supported(d, g * tq):
        raise ValueError(f"paged_decode_append_multi_q4: no kernel for head "
                         f"dim {d} with {g} query heads per kv head x {tq} "
                         f"tokens")
    if q.dtype == torch.bfloat16 and tq > MULTI_MAX_TOKENS:
        raise ValueError(f"paged_decode_append_multi_q4: the bf16 kernel "
                         f"folds in at most {MULTI_MAX_TOKENS} fresh tokens, "
                         f"not {tq}")
    out = torch.empty_like(q)
    pm = k_cache.shape[3]
    partials = counters = None
    run_tokens = 0
    if q.dtype == torch.bfloat16:
        run_tokens = multi_q4_run_tokens(
            b, kvh, 2 * pm, _sm_count(q.device),
            paged_decode_append_multi_q4_info(d, g * tq)["max_runs"])
        partials, counters = _split_workspace(
            q, b * kvh, -(-2 * pm // run_tokens), MULTI_PARTIAL_ROWS)
    code = fn(kernels.ptr(q), kernels.ptr(new_k), kernels.ptr(new_v),
              kernels.ptr(new_ks), kernels.ptr(new_vs), kernels.ptr(k_cache),
              kernels.ptr(v_cache), kernels.ptr(ks_cache),
              kernels.ptr(vs_cache), kernels.ptr(cache_len), kernels.ptr(out),
              kernels.ptr(partials), kernels.ptr(counters),
              b, tq, kvh, g, pm, d, int(layer), run_tokens, scale,
              kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    kernels.raise_on_error("paged_decode_append_multi_q4", code)
    kernels.LAUNCHES["paged_decode_append_multi_q4"] += 1
    return out


# ---------------------------------------------------------------------------
# read-only decode attention over a cache in the activations' dtype
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_cache, v_cache, cache_len,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of kernels #8 and #9 over a per-slot cache
    (B, KVH, M, D): dense attention over rows [0, cache_len], in float32.
    The JAX kernels round the probabilities to the value dtype before the PV
    product (``decode_attention.py:107``, ``:244``), and so does the kernels'
    bf16 instance (relative to each warp's running max); this version keeps
    them in float32, as kernel #5 (``paged_decode_append``) does."""
    m = k_cache.shape[2]
    lens = cache_len.long().clamp(0, m - 1)
    mask = (torch.arange(m, device=q.device)[None, :] <= lens[:, None]).float()
    return decode_attention(q, k_cache, v_cache, mask, scale=scale)


def paged_decode_attention_stacked_plain(q, k_cache, v_cache, layer: int,
                                         cache_len,
                                         scale: Optional[float] = None
                                         ) -> torch.Tensor:
    """The plain version of kernel #9: kernel #8's over layer `layer`."""
    return paged_decode_attention_plain(q, k_cache[layer], v_cache[layer],
                                        cache_len, scale)


@functools.cache
def _attention_fns():
    lib = library("decode_attention")
    per_slot = lib.karanta_decode_attention
    per_slot.restype = ctypes.c_int
    per_slot.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    stacked = lib.karanta_decode_attention_stacked
    stacked.restype = ctypes.c_int
    stacked.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    supported = lib.karanta_decode_attention_supported
    supported.restype = ctypes.c_int
    supported.argtypes = [ctypes.c_int, ctypes.c_int]
    return per_slot, stacked, supported


# the split kernels' merge counters per (device, stream): zero between calls
# (each call resets the ones it used), so they are allocated once and shared
# by kernels #3-#9 on one stream
_SPLIT_COUNTERS: dict = {}
# the read-only and single-token append kernels' partial record holds 8
# query rows
SPLIT_PARTIAL_ROWS = 8


def _split_workspace(q, n_slabs: int, n_runs: int, rows: int):
    """Partials (float32: one record (O [rows][D], m [rows], l [rows]) per
    (slot, kv head) slab and run of cache rows) and merge counters for a
    bf16 split kernel."""
    partials = torch.empty(n_slabs * n_runs * rows * (q.shape[-1] + 2),
                           dtype=torch.float32, device=q.device)
    key = (q.device, torch.cuda.current_stream(q.device).cuda_stream)
    counters = _SPLIT_COUNTERS.get(key)
    if counters is None or counters.numel() < n_slabs:
        counters = torch.zeros(n_slabs, dtype=torch.int32, device=q.device)
        _SPLIT_COUNTERS[key] = counters
    return partials, counters


def _info(source: str, entry: str, d: int, n: int, *keys: str) -> dict:
    fn = getattr(library(source), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    keys = ("registers", "spill_bytes", "smem_bytes", "blocks_per_sm", *keys)
    info = (ctypes.c_int * len(keys))()
    kernels.raise_on_error(entry, fn(d, n, info))
    return dict(zip(keys, info))


@functools.cache
def paged_decode_attention_info(d: int, g: int) -> dict:
    """Registers and spilled bytes per thread, dynamic shared bytes per block,
    resident blocks per SM and cache rows per block of the read-only
    kernels' bf16 (tensor-core) instance for head dim d with g query heads
    per kv head, as the CUDA runtime reports them (needs the card)."""
    return _info("decode_attention", "karanta_decode_attention_info", d, g,
                 "split_rows")


def _attention_launch(name: str, q, k_cache, v_cache, cache_len,
                      layer: Optional[int], scale: float) -> torch.Tensor:
    """Launch kernel #8 (layer None, cache (B, KVH, M, D)) or #9 (cache
    (L, B, KVH, M, D) at `layer`)."""
    b, _, h, d = q.shape
    kvh, m = k_cache.shape[-3], k_cache.shape[-2]
    for key, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {key} must have q's dtype {q.dtype}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"{name}: cache_len must be int32")
    per_slot, stacked, supported = _attention_fns()
    if not supported(d, h // kvh):
        raise ValueError(f"{name}: no kernel for head dim {d} with "
                         f"{h // kvh} query heads per kv head")
    kernels.check_cuda_inputs(name, q.dtype, q=q, k_cache=k_cache,
                              v_cache=v_cache, cache_len=cache_len)
    out = torch.empty_like(q)
    partials = counters = None
    if q.dtype == torch.bfloat16:
        runs = -(-m // paged_decode_attention_info(d, h // kvh)["split_rows"])
        partials, counters = _split_workspace(q, b * kvh, runs,
                                              SPLIT_PARTIAL_ROWS)
    args = (kernels.ptr(q), kernels.ptr(k_cache), kernels.ptr(v_cache),
            kernels.ptr(cache_len), kernels.ptr(out), kernels.ptr(partials),
            kernels.ptr(counters), b, kvh, h // kvh, m, d)
    tail = (scale, kernels.DTYPE_CODES[q.dtype], kernels.stream_ptr(q.device))
    if layer is None:
        code = per_slot(*args, *tail)
    else:
        code = stacked(*args, int(layer), *tail)
    kernels.raise_on_error(name, code)
    kernels.LAUNCHES[name] += 1
    return out


def _check_attention(name: str, q, k_cache, v_cache, cache_len, n_lead: int
                     ) -> None:
    b, one, h, d = q.shape
    if k_cache.dim() != 4 + n_lead or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: caches must be "
                         f"{'(L, ' if n_lead else '('}B, KVH, M, D) and equal "
                         f"in shape")
    cb, kvh, _, cd = k_cache.shape[n_lead:]
    if one != 1 or cb != b or cd != d or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    if tuple(cache_len.shape) != (b,):
        raise ValueError(f"{name}: cache_len {tuple(cache_len.shape)} != "
                         f"{(b,)}")


def paged_decode_attention(
    q: torch.Tensor,          # (B, 1, H, D)
    k_cache: torch.Tensor,    # (B, KVH, M, D)
    v_cache: torch.Tensor,    # (B, KVH, M, D)
    cache_len: torch.Tensor,  # (B,) int32: this step's row sits AT this index
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Length-bounded decode attention over per-slot caches: slot b attends
    rows [0, cache_len[b]]. Returns attn (B, 1, H, D)."""
    _check_attention("paged_decode_attention", q, k_cache, v_cache, cache_len,
                     0)
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, cache_len,
                                            scale)
    return _attention_launch("paged_decode_attention", q, k_cache, v_cache,
                             cache_len, None, scale)


def paged_decode_attention_stacked(
    q: torch.Tensor,          # (B, 1, H, D)
    k_cache: torch.Tensor,    # (L, B, KVH, M, D), read in place
    v_cache: torch.Tensor,    # (L, B, KVH, M, D)
    layer: int,
    cache_len: torch.Tensor,  # (B,) int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel #8 reading layer `layer` of the stacked cache in place (no
    per-layer slice is made). Returns attn (B, 1, H, D); the caches are not
    written, so unlike the JAX function it does not return them."""
    _check_attention("paged_decode_attention_stacked", q, k_cache, v_cache,
                     cache_len, 1)
    if not 0 <= int(layer) < k_cache.shape[0]:
        raise ValueError(f"paged_decode_attention_stacked: layer {layer} out "
                         f"of range for {k_cache.shape[0]} layers")
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if not q.is_cuda:
        return paged_decode_attention_stacked_plain(q, k_cache, v_cache,
                                                    int(layer), cache_len,
                                                    scale)
    return _attention_launch("paged_decode_attention_stacked", q, k_cache,
                             v_cache, cache_len, int(layer), scale)
