"""Decode-step weight streams (port of ``karanta_tpu/ops/decode_stream.py``).

Two functions that run every decoder layer of one decode step in ONE kernel
launch, each a persistent cooperative kernel in
``kernels/csrc/decode_stream.cu``:

- ``dense_stream`` (``:173``, kernel #10): all layers' int8 dense products;
  the per-layer attention outputs are an input and the per-layer qkv
  projections an output;
- ``decode_megakernel`` (``:589``, kernel #11): a whole decode step over the
  int8 KV cache (``QuantKVCache`` layout): qkv, rope, int8 K/V quantization
  and append at ``cache_len`` IN PLACE, attention, o, the fused MLP.

As in the JAX package neither is wired into ``decode_step``, the engine or
the server. On CUDA tensors each wrapper launches its kernel; CPU tensors
take the plain version beside it, which follows the kernel's rounding
points. ``dense_stream_reference`` is the JAX package's test oracle.

Weights (``pack_stream_params``): the JAX dict's keys, shapes and values,
int8 weights ``(L, in, out)`` for ``wqkv``/``wo``/``wd`` as views of
out-major ``(L, out, in)`` storage (``quantization.out_major``) and
``wg_t``/``wu_t`` ``(L, FF, H)`` contiguous, so the kernels read every
output column's K bytes contiguously.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from karanta_tpu_torch import kernels
from karanta_tpu_torch.kernels.build import library
from karanta_tpu_torch.ops.quantization import QUANT_KEY, out_major
from karanta_tpu_torch.ops.rotary import rotate_half

KT = 256  # the JAX kernel's K-tile rows (h and ff must be multiples)
MT = 256  # its MLP output-chunk rows
NEG_INF = -1e30
MAX_BATCH = 128  # the kernels' register tiles take up to 128 rows
ATTN_CHUNK = 128  # cache rows per online-softmax step of kernel #11

_INT8_KEYS = ("wqkv", "wo", "wg_t", "wu_t", "wd")
_OUT_MAJOR = ("wqkv", "wo", "wd")  # (L, in, out) views of (L, out, in)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX ``_rms``: float32 ``x * rsqrt(mean(x^2) + eps) * w``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.float()


def pack_stream_params(layers: dict) -> dict:
    """The decoder's int8 stacked layers (``quantize_decoder_params`` or
    ``init_params_bench``) -> the stream kernels' dict: wqkv (L, H, QKV)
    int8, qs (L, 1, QKV) f32, bias (L, 1, QKV), wo (L, QD, H), os (L, 1, H),
    wg_t/wu_t (L, FF, H), gs/us (L, 1, FF), wd (L, FF, H), ds (L, 1, H),
    ln1/ln2 (L, 1, H). Only wqkv is a new copy; the rest share storage with
    the layers where it is already in the kernels' layout."""
    attn, mlp = layers["attn"], layers["mlp"]
    wq, wk, wv = (attn[n][QUANT_KEY] for n in ("wq", "wk", "wv"))
    wqkv = torch.cat([w.transpose(-1, -2) for w in (wq, wk, wv)],
                     dim=-2).contiguous().transpose(-1, -2)
    return {
        "ln1": layers["ln1"][:, None, :], "ln2": layers["ln2"][:, None, :],
        "wqkv": wqkv,
        "qs": torch.cat([attn[n]["scale"] for n in ("wq", "wk", "wv")], -1),
        "bias": torch.cat([attn["bq"], attn["bk"], attn["bv"]],
                          -1)[:, None, :],
        "wo": out_major(attn["wo"][QUANT_KEY]), "os": attn["wo"]["scale"],
        "wg_t": mlp["gate"][QUANT_KEY].transpose(1, 2).contiguous(),
        "gs": mlp["gate"]["scale"],
        "wu_t": mlp["up"][QUANT_KEY].transpose(1, 2).contiguous(),
        "us": mlp["up"]["scale"],
        "wd": out_major(mlp["down"][QUANT_KEY]), "ds": mlp["down"]["scale"],
    }


def _linear(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor
            ) -> torch.Tensor:
    """a (B, K) @ int8 w (K, N) in float32, times the per-column scale."""
    return (a.float() @ w.float()) * scale.reshape(-1)


def _mlp_tail(x: torch.Tensor, xn: torch.Tensor, sp: dict, layer: int
              ) -> torch.Tensor:
    """gate/up, h = bf16(silu(g) * u), down and the residual, rounded."""
    g = _linear(xn, sp["wg_t"][layer].transpose(0, 1), sp["gs"][layer])
    u = _linear(xn, sp["wu_t"][layer].transpose(0, 1), sp["us"][layer])
    h = (F.silu(g) * u).to(x.dtype)
    return (x.float() + _linear(h, sp["wd"][layer], sp["ds"][layer])
            ).to(x.dtype)


def _o_residual(x, attn, sp, layer: int, eps: float):
    """o product added to the float32 residual; ln2 of that float32 sum
    (the kernel's order, ``decode_stream.py:104-106``), then x rounded."""
    x32 = x.float() + _linear(attn, sp["wo"][layer], sp["os"][layer])
    xn = _rms(x32, sp["ln2"][layer, 0], eps).to(x.dtype)
    return x32.to(x.dtype), xn


def _qkv(xn, sp, layer: int, dtype):
    return (_linear(xn, sp["wqkv"][layer], sp["qs"][layer])
            + sp["bias"][layer, 0].float()).to(dtype)


def dense_stream_plain(x, attn_out, sp: dict, eps: float = 1e-6):
    """The plain PyTorch version of kernel #10, at the Pallas kernel's
    rounding points. Returns (x_final (B, H), qkv (L, B, QKV))."""
    qkvs = []
    for l in range(sp["wqkv"].shape[0]):
        xn = _rms(x, sp["ln1"][l, 0], eps).to(x.dtype)
        qkvs.append(_qkv(xn, sp, l, x.dtype))
        x, xn = _o_residual(x, attn_out[l], sp, l, eps)
        x = _mlp_tail(x, xn, sp, l)
    return x, torch.stack(qkvs)


def dense_stream_reference(x, attn_out, sp: dict, eps: float = 1e-6):
    """The JAX package's test oracle (``:742-769``): as the plain version,
    but ln2 is taken of the residual after rounding it to x's dtype."""
    qkvs = []
    for l in range(sp["wqkv"].shape[0]):
        xn = _rms(x, sp["ln1"][l, 0], eps).to(x.dtype)
        qkvs.append(_qkv(xn, sp, l, x.dtype))
        x = (x.float() + _linear(attn_out[l], sp["wo"][l], sp["os"][l])
             ).to(x.dtype)
        xn = _rms(x, sp["ln2"][l, 0], eps).to(x.dtype)
        x = _mlp_tail(x, xn, sp, l)
    return x, torch.stack(qkvs)


def _attend(q, kq, vq, k_cache, v_cache, ks_cache, vs_cache, layer, lens,
            nks, nvs, scale):
    """One layer's attention at the kernels' rounding points: old rows
    [0, len) with the row scales in chunks of ATTN_CHUNK rows under a
    running max (the kernel's online softmax; the TPU kernel's blocks are
    up to 512 rows, 128 at the 1920-row bucket), ``p * v_scale`` rounded to bf16 against the int8 V, then the
    new row folded in last in float32. The running max matters: each chunk
    rounds its probabilities relative to the max seen so far. q (B, KVH, G,
    D) bf16."""
    b, kvh, g, _ = q.shape
    m = k_cache.shape[3]
    chunk = min(ATTN_CHUNK, m)
    qf = q.float()
    live = (torch.arange(m, device=q.device)[None, :] < lens[:, None])
    live = live[:, None, None, :]                               # (B,1,1,M)
    s = torch.einsum("bkgd,bkmd->bkgm", qf, k_cache[layer].float())
    s = s * ks_cache[layer].float()[:, :, None, :] * scale
    s = torch.where(live, s, NEG_INF).reshape(b, kvh, g, m // chunk, chunk)
    run = torch.cummax(s.amax(dim=-1), dim=-1).values           # (B,K,G,C)
    p = torch.where(live.reshape(b, 1, 1, m // chunk, chunk),
                    torch.exp(s - run[..., None]), 0.0)
    vs = vs_cache[layer].float().reshape(b, kvh, 1, m // chunk, chunk)
    pv = (p * vs).to(q.dtype).float()
    m_old = run[..., -1]
    carry = torch.exp(run - m_old[..., None])                   # (B,K,G,C)
    l_old = (p.sum(dim=-1) * carry).sum(dim=-1)
    v = v_cache[layer].float().reshape(b, kvh, m // chunk, chunk, -1)
    acc = torch.einsum("bkgcm,bkcmd->bkgcd", pv, v)
    acc = (acc * carry[..., None]).sum(dim=-2)
    nk = kq.float() * nks.float()[..., None]                    # (B,KVH,D)
    s_x = (qf * nk[:, :, None, :]).sum(dim=-1) * scale
    m_new = torch.maximum(m_old, s_x)
    p_x = torch.exp(s_x - m_new)
    alpha = torch.exp(m_old - m_new)
    l = alpha * l_old + p_x
    nv = vq.float() * nvs.float()[..., None]
    acc = acc * alpha[..., None] + p_x[..., None] * nv[:, :, None, :]
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def decode_megakernel_plain(x, cos, sin, sp: dict, k_cache, v_cache,
                            ks_cache, vs_cache, cache_len, qd: int, kvd: int,
                            scale: float, eps: float = 1e-6):
    """The plain PyTorch version of kernel #11; appends to the caches in
    place at cache_len clamped into [0, M), as the kernel does. Returns
    x_final (B, H) before the final norm."""
    # the decoder's own row quantization (the decoder does not import this
    # module, so there is no cycle)
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows

    b = x.shape[0]
    n_layers, _, kvh, m, d = k_cache.shape
    g = qd // d // kvh
    lens = cache_len.long().clamp(0, m - 1)
    bidx = torch.arange(b, device=x.device)
    cos, sin = cos.float()[:, None, :], sin.float()[:, None, :]
    for l in range(n_layers):
        xn = _rms(x, sp["ln1"][l, 0], eps).to(x.dtype)
        qkv = _qkv(xn, sp, l, x.dtype).float()
        q = qkv[:, :qd].reshape(b, kvh * g, d)
        k = qkv[:, qd:qd + kvd].reshape(b, kvh, d)
        v = qkv[:, qd + kvd:qd + 2 * kvd].reshape(b, kvh, d)
        q = (q * cos + rotate_half(q) * sin).to(x.dtype)
        k = (k * cos + rotate_half(k) * sin).to(x.dtype)
        # int8 from the float32 scale, the scale stored in bf16
        kq, ks = quantize_kv_rows(k)
        vq, vs = quantize_kv_rows(v)
        k_cache[l, bidx, :, lens] = kq
        v_cache[l, bidx, :, lens] = vq
        ks_cache[l, bidx, :, lens] = ks
        vs_cache[l, bidx, :, lens] = vs
        attn = _attend(q.reshape(b, kvh, g, d), kq, vq, k_cache, v_cache,
                       ks_cache, vs_cache, l, lens, ks, vs, scale)
        x, xn = _o_residual(x, attn.reshape(b, qd), sp, l, eps)
        x = _mlp_tail(x, xn, sp, l)
    return x


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def stream_fns(lib: ctypes.CDLL) -> tuple:
    """The typed C entries (dense stream, megakernel, workspace query) of a
    library built from ``decode_stream.cu``: the port's own, or an
    instrumented copy of the source (``bench/stream_trace.py``)."""
    dense = lib.karanta_dense_stream
    dense.restype = ctypes.c_int
    dense.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    mega = lib.karanta_decode_megakernel
    mega.restype = ctypes.c_int
    mega.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    workspace = lib.karanta_decode_stream_workspace
    workspace.restype = ctypes.c_longlong
    workspace.argtypes = [ctypes.c_int] * 11
    return dense, mega, workspace


@functools.cache
def _stream_fns() -> tuple:
    return stream_fns(library("decode_stream"))


def _check_params(name: str, sp: dict, n_layers: int, h: int, qkvd: int,
                  ff: int) -> None:
    shapes = {"wqkv": (n_layers, h, qkvd), "qs": (n_layers, 1, qkvd),
              "bias": (n_layers, 1, qkvd), "os": (n_layers, 1, h),
              "wg_t": (n_layers, ff, h), "wu_t": (n_layers, ff, h),
              "gs": (n_layers, 1, ff), "us": (n_layers, 1, ff),
              "wd": (n_layers, ff, h), "ds": (n_layers, 1, h),
              "ln1": (n_layers, 1, h), "ln2": (n_layers, 1, h)}
    for key, shape in shapes.items():
        if tuple(sp[key].shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(sp[key].shape)} != "
                             f"{shape}")
    if sp["wo"].shape[0] != n_layers or sp["wo"].shape[2] != h:
        raise ValueError(f"{name}: wo {tuple(sp['wo'].shape)} does not fit "
                         f"{n_layers} layers of width {h}")


def _cuda_params(name: str, sp: dict, dtype: torch.dtype) -> list:
    """The weight pointers in the C interface's order, after the checks the
    kernel needs: int8 weights in the kernels' layout, float32 scales, norm
    weights and biases in the activations' dtype."""
    for key in _INT8_KEYS:
        w = sp[key]
        if w.dtype != torch.int8:
            raise TypeError(f"{name}: {key} must be int8")
        stored = w.transpose(-1, -2) if key in _OUT_MAJOR else w
        if not stored.is_contiguous():
            raise ValueError(f"{name}: {key} must be "
                             f"{'out-major (quantization.out_major)' if key in _OUT_MAJOR else 'contiguous'}")
    for key in ("qs", "os", "gs", "us", "ds"):
        if sp[key].dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32")
    for key in ("ln1", "ln2", "bias"):
        if sp[key].dtype != dtype:
            raise TypeError(f"{name}: {key} must have x's dtype {dtype}")
    stored = {k: (sp[k].transpose(-1, -2) if k in _OUT_MAJOR else sp[k])
              for k in sp}
    kernels.check_cuda_inputs(name, dtype, **stored)
    return [kernels.ptr(stored[k]) for k in
            ("ln1", "ln2", "wqkv", "qs", "bias", "wo", "os", "wg_t", "gs",
             "wu_t", "us", "wd", "ds")]


def _workspace(workspace, device, b, h, qkvd, ff, qd, kvh, m, d, g,
               mega: bool):
    n_bytes = workspace(int(mega), b, h, qkvd, ff, qd, kvh, m, d, g,
                        device.index or 0)
    if n_bytes < 0:
        raise ValueError(f"{'decode_megakernel' if mega else 'dense_stream'}"
                         f": no kernel for batch {b}, head dim {d} with {g} "
                         f"query heads per kv head (error {n_bytes})")
    return (torch.empty(n_bytes, dtype=torch.uint8, device=device),
            torch.zeros(2, dtype=torch.int32, device=device))


def dense_stream(x: torch.Tensor,          # (B, H)
                 attn_out: torch.Tensor,   # (L, B, H) per-layer attention
                 sp: dict,                 # pack_stream_params output
                 eps: float = 1e-6):
    """All layers' int8 dense decode products in one launch. Returns
    (x_final (B, H), qkv (L, B, QKV)) in x's dtype."""
    return dense_stream_on(None, x, attn_out, sp, eps)


def dense_stream_on(fns, x, attn_out, sp: dict, eps: float = 1e-6):
    """``dense_stream`` launching through ``fns``, the ``stream_fns`` of
    another library built from the same source, or through the port's own
    library where fns is None."""
    b, h = x.shape
    n_layers, _, qkvd = sp["wqkv"].shape
    ff = sp["wd"].shape[1]
    if h % KT or ff % MT:
        raise ValueError(f"dense_stream: hidden {h} and ffn {ff} must be "
                         f"multiples of {KT} and {MT}")
    _check_params("dense_stream", sp, n_layers, h, qkvd, ff)
    # the attention output stands in for the o product's input, so the
    # JAX kernel's blocks take o as (H, H)
    if sp["wo"].shape[1] != h or tuple(attn_out.shape) != (n_layers, b, h):
        raise ValueError(f"dense_stream: attn_out {tuple(attn_out.shape)} "
                         f"and wo {tuple(sp['wo'].shape)} must be "
                         f"{(n_layers, b, h)} and {(n_layers, h, h)}")
    if not x.is_cuda:
        return dense_stream_plain(x, attn_out, sp, eps)
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"dense_stream: batch {b} outside 1..{MAX_BATCH}")
    if x.dtype != torch.bfloat16 or attn_out.dtype != x.dtype:
        raise TypeError("dense_stream: the kernel takes bf16 x and attn_out")
    weights = _cuda_params("dense_stream", sp, x.dtype)
    kernels.check_cuda_inputs("dense_stream", x.dtype, x=x,
                              attn_out=attn_out)
    dense, _, workspace = fns or _stream_fns()
    work, barrier = _workspace(workspace, x.device, b, h, qkvd, ff, h, 0, 0,
                               0, 0, mega=False)
    xout = torch.empty_like(x)
    qkv = torch.empty((n_layers, b, qkvd), dtype=x.dtype, device=x.device)
    code = dense(kernels.ptr(x), kernels.ptr(attn_out), *weights,
                 kernels.ptr(xout), kernels.ptr(qkv), kernels.ptr(work),
                 kernels.ptr(barrier), b, h, qkvd, ff, n_layers, float(eps),
                 kernels.stream_ptr(x.device))
    kernels.raise_on_error("dense_stream", code)
    kernels.LAUNCHES["dense_stream"] += 1
    return xout, qkv


def decode_megakernel(x: torch.Tensor,          # (B, H)
                      cos: torch.Tensor,        # (B, D) float32
                      sin: torch.Tensor,        # (B, D) float32
                      sp: dict,                 # pack_stream_params output
                      k_cache: torch.Tensor,    # (L, B, KVH, M, D) int8
                      v_cache: torch.Tensor,
                      ks_cache: torch.Tensor,   # (L, B, KVH, M)
                      vs_cache: torch.Tensor,
                      cache_len: torch.Tensor,  # (B,) int32
                      qd: Optional[int] = None,
                      kvd: Optional[int] = None,
                      scale: Optional[float] = None,
                      eps: float = 1e-6):
    """One decode step across all layers in one launch: each layer appends
    this token's int8 K/V row and scale at cache_len, IN PLACE, and attends
    over cache_len + 1 rows. Returns (x_final (B, H) before the final norm,
    k_cache, v_cache, ks_cache, vs_cache), the caches being the inputs.

    cache_len should lie in [0, M). A value outside is clamped into it, on
    the card and on the CPU alike (checking it would make the host wait for
    the device), so a slot at or past M rewrites its row M - 1."""
    return decode_megakernel_on(None, x, cos, sin, sp, k_cache, v_cache,
                                ks_cache, vs_cache, cache_len, qd, kvd, scale,
                                eps)


def decode_megakernel_on(fns, x, cos, sin, sp: dict, k_cache, v_cache,
                         ks_cache, vs_cache, cache_len, qd=None, kvd=None,
                         scale=None, eps: float = 1e-6):
    """``decode_megakernel`` launching through ``fns``, as
    ``dense_stream_on``."""
    b, h = x.shape
    n_layers, cb, kvh, m, d = k_cache.shape
    qkvd = sp["wqkv"].shape[2]
    ff = sp["wd"].shape[1]
    qd = h if qd is None else qd
    kvd = (qkvd - qd) // 2 if kvd is None else kvd
    scale = float(d ** -0.5 if scale is None else scale)
    slab, sslab = min(32, m), min(128, m)
    if m % slab or m % sslab:
        raise ValueError(f"bucket {m} must be a multiple of {slab}/{sslab}")
    if h % 128 or ff % 256:
        raise ValueError(f"decode_megakernel: hidden {h} must be a multiple "
                         f"of 128 and ffn {ff} of 256")
    if (cb != b or qd % (d * kvh) or kvd != kvh * d or qd + 2 * kvd != qkvd
            or tuple(cos.shape) != (b, d) or tuple(sin.shape) != (b, d)):
        raise ValueError(f"decode_megakernel: x {tuple(x.shape)}, cos "
                         f"{tuple(cos.shape)}, qkv width {qkvd} (qd {qd}, "
                         f"kvd {kvd}) do not fit cache {tuple(k_cache.shape)}")
    for key, t, shape in (("v_cache", v_cache, tuple(k_cache.shape)),
                          ("ks_cache", ks_cache, (n_layers, b, kvh, m)),
                          ("vs_cache", vs_cache, (n_layers, b, kvh, m)),
                          ("cache_len", cache_len, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_megakernel: {key} {tuple(t.shape)} != "
                             f"{shape}")
    _check_params("decode_megakernel", sp, n_layers, h, qkvd, ff)
    out = (k_cache, v_cache, ks_cache, vs_cache)
    if not x.is_cuda:
        return (decode_megakernel_plain(x, cos, sin, sp, *out, cache_len, qd,
                                        kvd, scale, eps), *out)
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"decode_megakernel: batch {b} outside "
                         f"1..{MAX_BATCH}")
    if x.dtype != torch.bfloat16:
        raise TypeError("decode_megakernel: the kernel takes bf16 "
                        "activations")
    for key, t, dtype in (("k_cache", k_cache, torch.int8),
                          ("v_cache", v_cache, torch.int8),
                          ("ks_cache", ks_cache, x.dtype),
                          ("vs_cache", vs_cache, x.dtype),
                          ("cos", cos, torch.float32),
                          ("sin", sin, torch.float32),
                          ("cache_len", cache_len, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"decode_megakernel: {key} must be {dtype}")
    weights = _cuda_params("decode_megakernel", sp, x.dtype)
    kernels.check_cuda_inputs(
        "decode_megakernel", x.dtype, x=x, cos=cos, sin=sin, k_cache=k_cache,
        v_cache=v_cache, ks_cache=ks_cache, vs_cache=vs_cache,
        cache_len=cache_len)
    _, mega, workspace = fns or _stream_fns()
    g = qd // d // kvh
    work, barrier = _workspace(workspace, x.device, b, h, qkvd, ff, qd, kvh,
                               m, d, g, mega=True)
    xout = torch.empty_like(x)
    code = mega(kernels.ptr(x), kernels.ptr(cos), kernels.ptr(sin),
                *weights, *(kernels.ptr(t) for t in out),
                kernels.ptr(cache_len), kernels.ptr(xout), kernels.ptr(work),
                kernels.ptr(barrier), b, h, qkvd, ff, n_layers, qd, kvh, g, m, d, scale, float(eps),
                kernels.stream_ptr(x.device))
    kernels.raise_on_error("decode_megakernel", code)
    kernels.LAUNCHES["decode_megakernel"] += 1
    return (xout, *out)
