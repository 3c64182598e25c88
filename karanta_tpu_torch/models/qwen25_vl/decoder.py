"""Qwen2.5-VL text decoder (port of ``karanta_tpu/models/qwen25_vl/decoder.py``).

GQA attention with q/k/v biases, SwiGLU MLP, RMSNorm and M-RoPE, with the JAX
package's layouts: per-layer weights stacked on a leading layer axis, weights
``(in, out)``, KV caches ``(layers, batch, kv_heads, max_len, head_dim)``.

- ``prefill_forward`` runs the causal prompt forward through the flash
  kernel and returns the prompt's KV rows; ``prefill_with_prefix`` runs only
  a suffix over a cached prefix's rows (the flash kernel at ``q_offset`` =
  prefix length).
- ``decode_step`` runs one token per slot over the int8 cache
  (``QuantKVCache``), the nibble-packed int4 cache (``Q4KVCache``) or the
  cache in the activations' dtype (``KVCache``); the fused append+attention
  kernel of each updates the cache tensors IN PLACE, layer by layer.
  ``KARANTA_PAGED_DECODE=stacked`` runs the last one as a scatter and the
  read-only stacked kernel instead.
- ``decode_multi`` runs T tokens per slot, the speculative verify pass: the
  int8 and int4 caches through their multi-token append kernels, the bf16
  cache through a scatter and ``decode_attention_multi`` (the JAX package's
  XLA path).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from karanta_tpu_torch.models.qwen25_vl.config import TextConfig
from karanta_tpu_torch.ops.attention import attention, decode_attention_multi
from karanta_tpu_torch.ops.decode_attention import (  # noqa: F401 (re-exports)
    bits_to_int8, pack_q4_rows, pack_q4_scales, paged_decode_append,
    paged_decode_append_multi_q4, paged_decode_append_multi_quant,
    paged_decode_append_q4, paged_decode_append_quant,
    paged_decode_attention_stacked, q4_row_nib, unpack_q4_rows,
    unpack_q4_scales)
from karanta_tpu_torch.ops.norms import rms_norm
from karanta_tpu_torch.ops.quantization import INV_127
from karanta_tpu_torch.ops.quantization import matmul as qmm
from karanta_tpu_torch.ops.quantization import matmul_w8a8
from karanta_tpu_torch.ops.rotary import apply_rope, mrope_cos_sin
from karanta_tpu_torch.utils.tree import layer_slice

Params = Any


def init_decoder_params(cfg: TextConfig, generator: torch.Generator,
                        dtype=torch.bfloat16, device=None) -> Params:
    """Random init with the JAX package's shapes."""
    h, n_layers = cfg.hidden_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    device = generator.device if device is None else device

    def randn(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def stack(shape):
        return (randn((n_layers,) + shape) / np.sqrt(shape[-2])).to(dtype)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    params = {
        "embed": (randn((cfg.vocab_size, h)) * 0.02).to(dtype),
        "layers": {
            "ln1": const((n_layers, h), 1.0),
            "ln2": const((n_layers, h), 1.0),
            "attn": {
                "wq": stack((h, qd)), "bq": const((n_layers, qd), 0.0),
                "wk": stack((h, kvd)), "bk": const((n_layers, kvd), 0.0),
                "wv": stack((h, kvd)), "bv": const((n_layers, kvd), 0.0),
                "wo": stack((qd, h)),
            },
            "mlp": {"gate": stack((h, inter)), "up": stack((h, inter)),
                    "down": stack((inter, h))},
        },
        "final_norm": const((h,), 1.0),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (randn((h, cfg.vocab_size)) / np.sqrt(h)).to(dtype)
    return params


@dataclasses.dataclass
class KVCache:
    """Key/value rows (layers, batch, kv_heads, len, head_dim): the prefill's
    output, and the serving cache in the activations' dtype (the bf16 cache).
    The decode paths update the serving cache's tensors in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TextConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache with per-row (token, kv head) absmax scales.

    k/v int8 (L, B, KVH, M, D); ks/vs (L, B, KVH, M) in the activation dtype.
    The decode step updates these tensors in place."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TextConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> "QuantKVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones(shape[:-1], dtype=dtype, device=device),
                   torch.ones(shape[:-1], dtype=dtype, device=device))


def quantize_kv_rows(x: torch.Tensor):
    """(..., D) -> (int8 (..., D), bf16 scale (...,)) with per-row absmax."""
    xf = x.float()
    a = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp(a * INV_127, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# int4 (nibble-packed) KV cache: the capacity operating point. Rows quantize
# to [-7, 7] with per-row absmax scales, and pairs of token rows pack into
# one byte along the sequence axis, so the cache takes half the memory of
# the int8 cache. The layout (ops/decode_attention.py, kept from the JAX
# package): token 64w + j in the low nibble of packed row 32w + j, token
# 64w + 32 + j in its high nibble; scales per token in nibble-plane order
# (L, B, 2*KVH, M/2), row 2h + nib.
# ---------------------------------------------------------------------------

Q4_WINDOW = 64  # tokens per packing window
# XLA compiles the JAX package's `amax / 7.0` inside jit (its decode step and
# insert) into a multiply by the float32 reciprocal, as for 127; the port
# multiplies too, so scales agree with the jitted paths to the bit
INV_7 = 1.0 / 7.0


def quantize_kv_rows_q4(x: torch.Tensor):
    """(..., D) -> (int8 nibbles in [-7, 7] (..., D), bf16 scale (...,))."""
    xf = x.float()
    a = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp(a * INV_7, min=1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(torch.int8)
    return q, s.to(torch.bfloat16)


def q4_pack_prefill(k_rows: torch.Tensor, v_rows: torch.Tensor):
    """Quantize + pack prefill KV rows (..., KVH, S, D) for a slot insert.

    Returns (k4, v4, ks, vs): packed bytes (..., KVH, ceil64(S)/2, D) and
    nibble-plane scales (..., 2*KVH, ceil64(S)/2). S pads up to a whole
    window with zero rows (dead nibbles, masked by cache_len downstream)."""
    kq, ks = quantize_kv_rows_q4(k_rows)
    vq, vs = quantize_kv_rows_q4(v_rows)
    pad = (-kq.shape[-2]) % Q4_WINDOW
    if pad:
        kq, vq = (F.pad(x, (0, 0, 0, pad)) for x in (kq, vq))
        ks, vs = (F.pad(x, (0, pad)) for x in (ks, vs))
    return (pack_q4_rows(kq), pack_q4_rows(vq), pack_q4_scales(ks),
            pack_q4_scales(vs))


@dataclasses.dataclass
class Q4KVCache:
    """Nibble-packed int4 KV cache (see above): half the memory and half the
    decode cache-read bytes of QuantKVCache. k/v int8 packed
    (L, B, KVH, M/2, D); ks/vs (L, B, 2*KVH, M/2) in the activations' dtype.
    The decode paths update these tensors in place."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @classmethod
    def zeros(cls, cfg: TextConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> "Q4KVCache":
        if max_len % Q4_WINDOW:
            raise ValueError(f"int4 KV cache needs max_seq_len % {Q4_WINDOW} "
                             f"== 0, got {max_len}")
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len // 2,
                 cfg.head_dim)
        sshape = (cfg.num_layers, batch, 2 * cfg.num_kv_heads, max_len // 2)
        return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.ones(sshape, dtype=dtype, device=device),
                   torch.ones(sshape, dtype=dtype, device=device))


def _paged_decode_mode() -> str:
    """The decode kernel for the cache in the activations' dtype, from
    KARANTA_PAGED_DECODE at call time: unset, "1" or "append" -> the fused
    append kernel; "stacked" -> a scatter of the new row and the read-only
    stacked kernel (the JAX package's A/B mode). "0", the JAX package's
    dense XLA path, exists there only to spare the TPU its per-call dispatch
    cost and would run no kernel here: it raises, as other unported features
    do. The int8 and int4 caches keep their append kernels in every mode
    (the JAX package's dense choice for them is a TPU dispatch choice too),
    so this is read for the activations'-dtype cache only."""
    mode = os.environ.get("KARANTA_PAGED_DECODE", "")
    if mode in ("", "1", "append"):
        return "append"
    if mode == "stacked":
        return "stacked"
    if mode == "0":
        raise NotImplementedError(
            "KARANTA_PAGED_DECODE=0 (the JAX package's dense XLA decode path) "
            "is not ported (ROADMAP.md, modules: KARANTA_PAGED_DECODE=0)")
    raise ValueError(f"KARANTA_PAGED_DECODE={mode!r}: expected unset, 1, "
                     f"append, stacked or 0")


def _rope_tables(cfg: TextConfig, positions: torch.Tensor, dtype):
    """positions (3, *lead) -> cos/sin (*lead, head_dim) in dtype."""
    lead = positions.shape[1:]
    cos, sin = mrope_cos_sin(positions.reshape(3, -1), cfg.head_dim,
                             cfg.mrope_section, cfg.rope_theta)
    shape = tuple(lead) + (cfg.head_dim,)
    return cos.reshape(shape).to(dtype), sin.reshape(shape).to(dtype)


def _project_qkv(x, p, cfg: TextConfig, mm=qmm):
    b, s, _ = x.shape
    q = (mm(x, p["wq"]) + p["bq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (mm(x, p["wk"]) + p["bk"]).reshape(b, s, cfg.num_kv_heads,
                                           cfg.head_dim)
    v = (mm(x, p["wv"]) + p["bv"]).reshape(b, s, cfg.num_kv_heads,
                                           cfg.head_dim)
    return q, k, v


def _mlp(x, p, mm=qmm):
    return mm(F.silu(mm(x, p["gate"])) * mm(x, p["up"]), p["down"])


def prefill_forward(params: Params, cfg: TextConfig,
                    embeds: torch.Tensor,          # (B, S, hidden)
                    positions: torch.Tensor,       # (3, B, S) int
                    kv_mask: Optional[torch.Tensor] = None,  # (B, S) f32
                    act_quant: bool = False,
                    ) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence causal forward -> (hidden_states, KV rows of S).

    act_quant=True runs the layer matmuls W8A8 (dynamic per-token int8
    activations x int8 weights); plain weight leaves pass through."""
    mm = matmul_w8a8 if act_quant else qmm
    b, s, _ = embeds.shape
    cos, sin = _rope_tables(cfg, positions, embeds.dtype)
    if kv_mask is not None:
        kv_mask = kv_mask.float().contiguous()
    x = embeds
    ks, vs = [], []
    for i in range(cfg.num_layers):
        layer = layer_slice(params["layers"], i)
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(xn, layer["attn"], cfg, mm=mm)
        q, k = apply_rope(q, k, cos, sin)
        attn = attention(q, k, v, kv_mask=kv_mask, causal=True)
        x = x + mm(attn.reshape(b, s, -1), layer["attn"]["wo"])
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps),
                     layer["mlp"], mm=mm)
        # store (B, KVH, S, D): contiguous per-head slabs, as the cache is
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, KVCache(torch.stack(ks), torch.stack(vs))


def prefill_with_prefix(params: Params, cfg: TextConfig,
                        embeds: torch.Tensor,         # (B, S, hidden) suffix
                        positions: torch.Tensor,      # (3, B, S) absolute
                        prefix: KVCache,              # (L, B, KVH, P, D)
                        prefix_mask: torch.Tensor,    # (B, P) 1 = valid
                        kv_mask: Optional[torch.Tensor] = None,  # (B, S)
                        act_quant: bool = False,
                        ) -> tuple[torch.Tensor, KVCache]:
    """Continuation prefill over a cached prompt prefix.

    The prefix rows (rope-rotated at positions 0..P-1) are reused, so only
    the suffix runs through the layers: its queries attend over P + S keys
    with causal positions shifted by P (the flash kernel's ``q_offset``).
    Returns the suffix's hidden states and the FULL prefix + suffix rows."""
    mm = matmul_w8a8 if act_quant else qmm
    b, s, _ = embeds.shape
    p = prefix.k.shape[3]
    cos, sin = _rope_tables(cfg, positions, embeds.dtype)
    suffix_mask = (kv_mask if kv_mask is not None
                   else torch.ones((b, s), device=embeds.device))
    full_mask = torch.cat([prefix_mask.float(), suffix_mask.float()],
                          dim=1).contiguous()
    x = embeds
    ks, vs = [], []
    for i in range(cfg.num_layers):
        layer = layer_slice(params["layers"], i)
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(xn, layer["attn"], cfg, mm=mm)
        q, k = apply_rope(q, k, cos, sin)
        k_full = torch.cat([prefix.k[i].to(k.dtype).transpose(1, 2), k], 1)
        v_full = torch.cat([prefix.v[i].to(v.dtype).transpose(1, 2), v], 1)
        attn = attention(q, k_full, v_full, kv_mask=full_mask, causal=True,
                         q_offset=p)
        x = x + mm(attn.reshape(b, s, -1), layer["attn"]["wo"])
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps),
                     layer["mlp"], mm=mm)
        ks.append(k_full.transpose(1, 2))
        vs.append(v_full.transpose(1, 2))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, KVCache(torch.stack(ks), torch.stack(vs))


def decode_step(params: Params, cfg: TextConfig,
                embeds: torch.Tensor,       # (B, 1, hidden)
                positions: torch.Tensor,    # (3, B) int
                cache,                      # a KV cache of any kind, in place
                cache_len: torch.Tensor,    # (B,) int32 rows already cached
                ):
    """One decode step: each layer appends this token's K/V rows at
    cache_len (in place, inside the kernel) and attends over cache_len + 1
    rows. Returns (hidden (B, 1, hidden), the same cache).

    The int8 cache goes through ``paged_decode_append_quant``, the int4
    cache through ``paged_decode_append_q4``, and the cache in the
    activations' dtype through ``paged_decode_append`` at every length, or
    with ``KARANTA_PAGED_DECODE=stacked`` through a scatter and
    ``paged_decode_attention_stacked`` (see ``_paged_decode_mode``). (The JAX
    decoder takes its Pallas kernels only from 8192 rows on or for the
    quantized caches, because each Pallas call costs about 125 us of TPU
    dispatch; the kernels compute the dense path's values and read only live
    rows.)"""
    quant = isinstance(cache, QuantKVCache)
    q4 = isinstance(cache, Q4KVCache)
    mode = "append" if quant or q4 else _paged_decode_mode()
    b = embeds.shape[0]
    cos, sin = _rope_tables(cfg, positions[:, :, None], embeds.dtype)
    cache_len = cache_len.to(torch.int32).contiguous()
    bidx = torch.arange(b, device=embeds.device)
    x = embeds
    for i in range(cfg.num_layers):
        layer = layer_slice(params["layers"], i)
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(xn, layer["attn"], cfg)
        q, k = apply_rope(q, k, cos, sin)
        if quant:
            kq, ksc = quantize_kv_rows(k[:, 0])
            vq, vsc = quantize_kv_rows(v[:, 0])
            attn = paged_decode_append_quant(
                q.contiguous(), kq, vq, ksc.to(cache.ks.dtype),
                vsc.to(cache.vs.dtype), cache.k, cache.v, cache.ks, cache.vs,
                i, cache_len)
        elif q4:
            kq, ksc = quantize_kv_rows_q4(k[:, 0])
            vq, vsc = quantize_kv_rows_q4(v[:, 0])
            attn = paged_decode_append_q4(
                q.contiguous(), kq, vq, ksc.to(cache.ks.dtype),
                vsc.to(cache.vs.dtype), cache.k, cache.v, cache.ks, cache.vs,
                i, cache_len)
        elif mode == "stacked":
            # the JAX package's stacked mode: scatter the row at cache_len,
            # then read the layer in place over cache_len + 1 rows
            lens = cache_len.long()
            cache.k[i, bidx, :, lens] = k[:, 0].to(cache.k.dtype)
            cache.v[i, bidx, :, lens] = v[:, 0].to(cache.v.dtype)
            attn = paged_decode_attention_stacked(q.contiguous(), cache.k,
                                                  cache.v, i, cache_len)
        else:
            attn = paged_decode_append(
                q.contiguous(), k[:, 0].to(cache.k.dtype).contiguous(),
                v[:, 0].to(cache.v.dtype).contiguous(), cache.k, cache.v, i,
                cache_len)
        x = x + qmm(attn.reshape(b, 1, -1), layer["attn"]["wo"])
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps), layer["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache


def decode_multi(params: Params, cfg: TextConfig,
                 embeds: torch.Tensor,       # (B, T, hidden)
                 positions: torch.Tensor,    # (3, B, T) int
                 cache,                      # a KV cache of any kind, in place
                 cache_len: torch.Tensor,    # (B,) int32 rows already cached
                 act_quant: bool = False,
                 ):
    """T-token decode for speculative verification: writes T K/V rows per
    slot at cache_len + [0, T) and attends causally within them plus the
    existing cache. The caller keeps cache_len + T <= M - 1.

    act_quant=True runs the layer matmuls W8A8, as the JAX decoder does, so
    the verify pass and the per-step decode (weight-only) differ in rounding.
    Rollback is free: rejected rows stay past the slot's cache_len and every
    later read is bounded by it. Returns (hidden (B, T, hidden), cache)."""
    mm = matmul_w8a8 if act_quant else qmm
    quant = isinstance(cache, QuantKVCache)
    q4 = isinstance(cache, Q4KVCache)
    b, tq, _ = embeds.shape
    cos, sin = _rope_tables(cfg, positions, embeds.dtype)
    cache_len = cache_len.to(torch.int32).contiguous()
    bidx = torch.arange(b, device=embeds.device)[:, None]
    wpos = cache_len.long()[:, None] + torch.arange(tq, device=embeds.device)
    x = embeds
    for i in range(cfg.num_layers):
        layer = layer_slice(params["layers"], i)
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(xn, layer["attn"], cfg, mm=mm)
        q, k = apply_rope(q, k, cos, sin)
        if quant:
            kq, ksc = quantize_kv_rows(k)                # (B, T, KVH, D)
            vq, vsc = quantize_kv_rows(v)
            attn = paged_decode_append_multi_quant(
                q.contiguous(), kq, vq, ksc.to(cache.ks.dtype),
                vsc.to(cache.vs.dtype), cache.k, cache.v, cache.ks, cache.vs,
                i, cache_len)
        elif q4:
            kq, ksc = quantize_kv_rows_q4(k)             # (B, T, KVH, D)
            vq, vsc = quantize_kv_rows_q4(v)
            attn = paged_decode_append_multi_q4(
                q.contiguous(), kq, vq, ksc.to(cache.ks.dtype),
                vsc.to(cache.vs.dtype), cache.k, cache.v, cache.ks, cache.vs,
                i, cache_len)
        else:
            # the JAX package's XLA path: scatter the T rows, dense attention
            cache.k[i, bidx, :, wpos] = k.to(cache.k.dtype)
            cache.v[i, bidx, :, wpos] = v.to(cache.v.dtype)
            attn = decode_attention_multi(q, cache.k[i], cache.v[i],
                                          cache_len)
        x = x + mm(attn.reshape(b, tq, -1), layer["attn"]["wo"])
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps),
                     layer["mlp"], mm=mm)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache


def logits_from_hidden(params: Params, cfg: TextConfig, hidden: torch.Tensor,
                       act_quant: bool = False) -> torch.Tensor:
    """Hidden -> vocab logits (W8A8 with act_quant, as in every JAX path)."""
    mm = matmul_w8a8 if act_quant else qmm
    if "logits_head" in params:  # int8 table for tied embeddings
        return mm(hidden, params["logits_head"])
    if cfg.tie_word_embeddings:
        return hidden @ params["embed"].t()
    return mm(hidden, params["lm_head"])


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][token_ids.long()]
