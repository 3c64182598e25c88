"""Qwen2.5-VL text decoder (port of ``karanta_tpu/models/qwen25_vl/decoder.py``).

GQA attention with q/k/v biases, SwiGLU MLP, RMSNorm and M-RoPE, with the JAX
package's layouts: per-layer weights stacked on a leading layer axis, weights
``(in, out)``, KV caches ``(layers, batch, kv_heads, max_len, head_dim)``.

- ``prefill_forward`` runs the causal prompt forward through the flash
  kernel and returns the prompt's KV rows (differentiable, checkpointed per
  layer with ``remat=True`` for training); ``prefill_with_prefix`` runs only
  a suffix over a cached prefix's rows (the flash kernel at ``q_offset`` =
  prefix length).
- ``decode_step`` runs one token per slot over the int8 cache
  (``QuantKVCache``), the nibble-packed int4 cache (``Q4KVCache``) or the
  cache in the activations' dtype (``KVCache``); the fused append+attention
  kernel of each updates the cache tensors IN PLACE, layer by layer.
  ``KARANTA_PAGED_DECODE=stacked`` runs the last one as a scatter and the
  read-only stacked kernel instead, ``KARANTA_PAGED_DECODE=0`` as a scatter
  and dense attention over the bucket (the JAX package's XLA path).
- ``decode_multi`` runs T tokens per slot, the speculative verify pass: the
  int8 and int4 caches through their multi-token append kernels, the bf16
  cache through a scatter and ``decode_attention_multi`` (the JAX package's
  XLA path).

Tensor parallelism (``group`` = the "model" process group, None on one
rank): the parameters hold this rank's shard (``decoder_param_axes``): q
heads and kv heads in contiguous blocks, the MLP's columns; ``wo`` and
``down`` are row-parallel (``ops/quantization.py``: their products sum over
the group) and the logits head is vocab-parallel (its logits are gathered
over the group). Head counts follow from the shards' widths, and the KV
caches hold this rank's kv heads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from karanta_tpu_torch.models.qwen25_vl.config import TextConfig
from karanta_tpu_torch.ops.attention import (attention, decode_attention,
                                             decode_attention_multi)
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
from karanta_tpu_torch.parallel.sharding import (copy_to_group,
                                                 gather_from_group)
from karanta_tpu_torch.utils.tree import unbind_layers

Params = Any


def init_decoder_params(cfg: TextConfig, generator: torch.Generator,
                        dtype=torch.bfloat16, device=None,
                        leaf_fn=None) -> Params:
    """Random init with the JAX package's shapes. `leaf_fn(path, tensor)`,
    when given, takes each leaf as it is drawn and returns what the tree
    keeps (the sharded loader quantizes and slices it there), so the whole
    tree never exists at once; the draws are the same either way."""
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

    def leaf(path, x):
        return leaf_fn(path, x) if leaf_fn is not None else x

    a, m = ("layers", "attn"), ("layers", "mlp")
    params = {
        "embed": leaf(("embed",), (randn((cfg.vocab_size, h)) * 0.02).to(dtype)),
        "layers": {
            "ln1": leaf(("layers", "ln1"), const((n_layers, h), 1.0)),
            "ln2": leaf(("layers", "ln2"), const((n_layers, h), 1.0)),
            "attn": {
                "wq": leaf(a + ("wq",), stack((h, qd))),
                "bq": leaf(a + ("bq",), const((n_layers, qd), 0.0)),
                "wk": leaf(a + ("wk",), stack((h, kvd))),
                "bk": leaf(a + ("bk",), const((n_layers, kvd), 0.0)),
                "wv": leaf(a + ("wv",), stack((h, kvd))),
                "bv": leaf(a + ("bv",), const((n_layers, kvd), 0.0)),
                "wo": leaf(a + ("wo",), stack((qd, h))),
            },
            "mlp": {"gate": leaf(m + ("gate",), stack((h, inter))),
                    "up": leaf(m + ("up",), stack((h, inter))),
                    "down": leaf(m + ("down",), stack((inter, h)))},
        },
        "final_norm": leaf(("final_norm",), const((h,), 1.0)),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(("lm_head",), (
            randn((h, cfg.vocab_size)) / np.sqrt(h)).to(dtype))
    return params


def decoder_param_axes(cfg: TextConfig) -> Params:
    """Logical sharding axes of every leaf of init_decoder_params (the JAX
    package's ``decoder_param_axes``)."""
    axes = {
        "embed": ("vocab", "embed"),
        "layers": {
            "ln1": ("layers", "embed"),
            "ln2": ("layers", "embed"),
            "attn": {
                "wq": ("layers", "embed", "heads"),
                "bq": ("layers", "heads"),
                "wk": ("layers", "embed", "kv_heads"),
                "bk": ("layers", "kv_heads"),
                "wv": ("layers", "embed", "kv_heads"),
                "bv": ("layers", "kv_heads"),
                "wo": ("layers", "heads", "embed"),
            },
            "mlp": {
                "gate": ("layers", "embed", "mlp"),
                "up": ("layers", "embed", "mlp"),
                "down": ("layers", "mlp", "embed"),
            },
        },
        "final_norm": ("embed",),
    }
    if not cfg.tie_word_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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
    """The decode path for the cache in the activations' dtype, from
    KARANTA_PAGED_DECODE at call time: unset, "1" or "append" -> the fused
    append kernel (at every bucket: the JAX package's auto mode takes its
    dense XLA path below 8192 rows only to spare the TPU a per-call
    dispatch); "stacked" -> a scatter of the new row and the read-only
    stacked kernel (the JAX package's A/B mode); "0" -> the JAX package's
    dense path: a scatter of the new row and dense attention over the
    bucket (``ops/attention.py decode_attention``, plain PyTorch). The int8
    and int4 caches keep their append kernels in every mode (the JAX
    package's dense choice for them is a TPU dispatch choice too), so this
    is read for the activations'-dtype cache only."""
    mode = os.environ.get("KARANTA_PAGED_DECODE", "")
    if mode in ("", "1", "append"):
        return "append"
    if mode == "stacked":
        return "stacked"
    if mode == "0":
        return "dense"
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
    """q (B, S, H, D), k and v (B, S, KVH, D): the head counts of the shards
    the parameters hold (all heads on one rank)."""
    b, s, _ = x.shape
    shape = (b, s, -1, cfg.head_dim)
    q = (mm(x, p["wq"]) + p["bq"]).reshape(shape)
    k = (mm(x, p["wk"]) + p["bk"]).reshape(shape)
    v = (mm(x, p["wv"]) + p["bv"]).reshape(shape)
    return q, k, v


def _mlp(x, p, mm=qmm, group=None):
    return mm(F.silu(mm(x, p["gate"])) * mm(x, p["up"]), p["down"], group)


def _layer(x, layer, cos, sin, kv_mask, cfg: TextConfig, mm=qmm,
           group=None, attn_fn=attention):
    """One decoder layer over full sequences: (x, k, v), k and v
    (B, S, KVH, D). Tensor-parallel inputs of the column-parallel products
    go through ``copy_to_group`` (the identity unless a gradient is taken)."""
    b, s, _ = x.shape
    xn = copy_to_group(rms_norm(x, layer["ln1"], cfg.rms_norm_eps), group)
    q, k, v = _project_qkv(xn, layer["attn"], cfg, mm=mm)
    q, k = apply_rope(q, k, cos, sin)
    attn = attn_fn(q, k, v, kv_mask=kv_mask, causal=True)
    x = x + mm(attn.reshape(b, s, -1), layer["attn"]["wo"], group)
    xn = copy_to_group(rms_norm(x, layer["ln2"], cfg.rms_norm_eps), group)
    return x + _mlp(xn, layer["mlp"], mm=mm, group=group), k, v


def prefill_forward(params: Params, cfg: TextConfig,
                    embeds: torch.Tensor,          # (B, S, hidden)
                    positions: torch.Tensor,       # (3, B, S) int
                    kv_mask: Optional[torch.Tensor] = None,  # (B, S) f32
                    act_quant: bool = False,
                    remat: bool = False,
                    group=None,
                    attn_impl=None,
                    gather_layer=None,
                    ) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence causal forward -> (hidden_states, KV rows of S).

    act_quant=True runs the layer matmuls W8A8 (dynamic per-token int8
    activations x int8 weights); plain weight leaves pass through.
    remat=True checkpoints each layer (training): the backward keeps one
    residual per layer and recomputes the rest, the flash kernel included.
    attn_impl replaces the attention call (``parallel/context.py``'s
    sequence-parallel attention); gather_layer(layer) maps each layer's
    leaves before use, inside the checkpoint (FSDP's gather, redone in the
    recompute)."""
    mm = matmul_w8a8 if act_quant else qmm
    cos, sin = _rope_tables(cfg, positions, embeds.dtype)
    if kv_mask is not None:
        kv_mask = kv_mask.float().contiguous()
    attn_fn = attn_impl or attention

    def layer_fn(x, layer):
        if gather_layer is not None:
            layer = gather_layer(layer)
        x, k, v = _layer(x, layer, cos, sin, kv_mask, cfg, mm, group,
                         attn_fn)
        # store (B, KVH, S, D): contiguous per-head slabs, as the cache is
        return x, k.transpose(1, 2), v.transpose(1, 2)

    x = embeds
    ks, vs = [], []
    for layer in unbind_layers(params["layers"], cfg.num_layers):
        if remat:
            x, k, v = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x, k, v = layer_fn(x, layer)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, KVCache(torch.stack(ks), torch.stack(vs))


def pipeline_prefill_forward(params: Params, cfg: TextConfig,
                             embeds: torch.Tensor,       # (B, S, hidden)
                             positions: torch.Tensor,    # (3, B, S) int
                             mesh,                       # Mesh, "pipe" axis
                             n_micro: int,
                             kv_mask: Optional[torch.Tensor] = None,
                             remat: bool = False,
                             ) -> torch.Tensor:
    """prefill_forward's layer stack under pipeline parallelism: each stage
    of the mesh's "pipe" axis runs its L/n contiguous layers and
    microbatches stream through the GPipe schedule of
    ``parallel/pipeline.py``. Returns the hidden states only (training)."""
    from karanta_tpu_torch.parallel.pipeline import pipeline_apply

    cos, sin = _rope_tables(cfg, positions, embeds.dtype)
    if kv_mask is not None:
        kv_mask = kv_mask.float().contiguous()

    def layer_fn(x, layer, extras):
        cos_mb, sin_mb, mask_mb = extras
        return _layer(x, layer, cos_mb, sin_mb, mask_mb, cfg)[0]

    body = layer_fn
    if remat:
        def body(x, layer, extras):
            return checkpoint(layer_fn, x, layer, extras, use_reentrant=False)
    x = pipeline_apply(mesh, body, params["layers"], embeds,
                       (cos, sin, kv_mask), n_micro)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def prefill_with_prefix(params: Params, cfg: TextConfig,
                        embeds: torch.Tensor,         # (B, S, hidden) suffix
                        positions: torch.Tensor,      # (3, B, S) absolute
                        prefix: KVCache,              # (L, B, KVH, P, D)
                        prefix_mask: torch.Tensor,    # (B, P) 1 = valid
                        kv_mask: Optional[torch.Tensor] = None,  # (B, S)
                        act_quant: bool = False,
                        group=None,
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
    for i, layer in enumerate(unbind_layers(params["layers"],
                                            cfg.num_layers)):
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(xn, layer["attn"], cfg, mm=mm)
        q, k = apply_rope(q, k, cos, sin)
        k_full = torch.cat([prefix.k[i].to(k.dtype).transpose(1, 2), k], 1)
        v_full = torch.cat([prefix.v[i].to(v.dtype).transpose(1, 2), v], 1)
        attn = attention(q, k_full, v_full, kv_mask=full_mask, causal=True,
                         q_offset=p)
        x = x + mm(attn.reshape(b, s, -1), layer["attn"]["wo"], group)
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps),
                     layer["mlp"], mm=mm, group=group)
        ks.append(k_full.transpose(1, 2))
        vs.append(v_full.transpose(1, 2))
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, KVCache(torch.stack(ks), torch.stack(vs))


def decode_step(params: Params, cfg: TextConfig,
                embeds: torch.Tensor,       # (B, 1, hidden)
                positions: torch.Tensor,    # (3, B) int
                cache,                      # a KV cache of any kind, in place
                cache_len: torch.Tensor,    # (B,) int32 rows already cached
                group=None,
                ):
    """One decode step: each layer appends this token's K/V rows at
    cache_len (in place, inside the kernel) and attends over cache_len + 1
    rows. Returns (hidden (B, 1, hidden), the same cache).

    The int8 cache goes through ``paged_decode_append_quant``, the int4
    cache through ``paged_decode_append_q4``, and the cache in the
    activations' dtype through ``paged_decode_append`` at every length, or
    with ``KARANTA_PAGED_DECODE=stacked`` through a scatter and
    ``paged_decode_attention_stacked``, with ``KARANTA_PAGED_DECODE=0``
    through a scatter and dense attention (see ``_paged_decode_mode``). (The JAX
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
    kv_valid = None  # the dense mode's (B, M) mask, built once
    x = embeds
    for i, layer in enumerate(unbind_layers(params["layers"],
                                            cfg.num_layers)):
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
        elif mode in ("stacked", "dense"):
            # scatter the row at cache_len; the stacked mode then reads the
            # layer in place over cache_len + 1 rows, the dense mode (the
            # JAX package's XLA path) attends over the bucket under a mask
            lens = cache_len.long()
            cache.k[i, bidx, :, lens] = k[:, 0].to(cache.k.dtype)
            cache.v[i, bidx, :, lens] = v[:, 0].to(cache.v.dtype)
            if mode == "stacked":
                attn = paged_decode_attention_stacked(q.contiguous(), cache.k,
                                                      cache.v, i, cache_len)
            else:
                if kv_valid is None:
                    kv_valid = (torch.arange(cache.k.shape[3],
                                             device=lens.device)[None, :]
                                <= lens[:, None]).float()
                attn = decode_attention(q, cache.k[i], cache.v[i], kv_valid)
        else:
            attn = paged_decode_append(
                q.contiguous(), k[:, 0].to(cache.k.dtype).contiguous(),
                v[:, 0].to(cache.v.dtype).contiguous(), cache.k, cache.v, i,
                cache_len)
        x = x + qmm(attn.reshape(b, 1, -1), layer["attn"]["wo"], group)
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps), layer["mlp"],
                     group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache


def decode_multi(params: Params, cfg: TextConfig,
                 embeds: torch.Tensor,       # (B, T, hidden)
                 positions: torch.Tensor,    # (3, B, T) int
                 cache,                      # a KV cache of any kind, in place
                 cache_len: torch.Tensor,    # (B,) int32 rows already cached
                 act_quant: bool = False,
                 group=None,
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
    for i, layer in enumerate(unbind_layers(params["layers"],
                                            cfg.num_layers)):
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
        x = x + mm(attn.reshape(b, tq, -1), layer["attn"]["wo"], group)
        x = x + _mlp(rms_norm(x, layer["ln2"], cfg.rms_norm_eps),
                     layer["mlp"], mm=mm, group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, cache


def logits_from_hidden(params: Params, cfg: TextConfig, hidden: torch.Tensor,
                       act_quant: bool = False, group=None) -> torch.Tensor:
    """Hidden -> vocab logits (W8A8 with act_quant, as in every JAX path).
    A vocab-parallel head's logits are gathered over `group`; the tied
    embedding stays whole on every rank, so its logits need no gather."""
    mm = matmul_w8a8 if act_quant else qmm
    if cfg.tie_word_embeddings and "logits_head" not in params:
        return hidden @ params["embed"].t()
    # int8 table for tied embeddings, or the head
    head = params.get("logits_head", params.get("lm_head"))
    return gather_from_group(mm(copy_to_group(hidden, group), head), group)


def embed_tokens(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][token_ids.long()]
