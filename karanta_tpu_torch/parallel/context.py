"""Context (sequence) parallelism for training attention (port of
``karanta_tpu/parallel/context.py``).

The text sequence of a training batch splits over the "seq" axis: each rank
holds S/n contiguous positions of ``token_ids``, ``labels``, ``attn_mask``
and ``positions`` (``sequence_sharded_batch``), every dense op stays local
to its chunk, and causal attention gets its cross-chunk view by gathering
K/V (and the kv mask) over "seq". Each rank's query chunk then attends to
the whole key space at its true global offset: the flash kernel (#2) at
``q_offset`` = rank × S/n through the differentiable ``ops/attention.py
attention``, whose backward is the blockwise plain one. The K/V gather's
backward sums each rank's K/V gradient over "seq" and keeps this rank's
chunk (``sharding.all_gather_dim``). Exact up to reduction order.

In the JAX package one ``shard_map`` views global arrays sharded over
(data, seq, model); here every rank already holds its own block: its rows
(split over "data" by the trainer's feeding, every row where the batch
does not divide the axis: ``training/train_step.py ParallelPlan.rows``),
its heads (split over "model" by tensor parallelism, whose placement
refuses head counts that do not divide the axis, where the JAX package
would compute with whole heads) and its chunk of the sequence.

The vision tower stays data-parallel: every "seq" rank encodes its rows'
whole images, and the model merges the image tokens that fall inside its
chunk (``models/qwen25_vl/model.py forward_train``'s ``seq_offset``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from karanta_tpu_torch.ops.attention import attention
from karanta_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh
from karanta_tpu_torch.parallel.sharding import all_gather_dim, gather_dim

TEXT_KEYS = ("token_ids", "labels", "attn_mask")


def seq_chunk(mesh: Mesh, s: int, seq_axis: str = SEQ_AXIS) -> tuple:
    """(offset, length) of this rank's chunk of an S-position sequence."""
    n = mesh.size(seq_axis)
    if s % n:
        raise ValueError(
            f"sequence length {s} must divide the {seq_axis!r} mesh axis "
            f"size {n} (pad the bucket ladder to a multiple)")
    chunk = s // n
    return mesh.index(seq_axis) * chunk, chunk


def make_context_parallel_attention(mesh: Mesh,
                                    seq_axis: str = SEQ_AXIS) -> Callable:
    """An ``attention(q, k, v, kv_mask=, causal=, scale=)``-compatible
    callable over this rank's chunks: q (B, S/n, H, D), k/v
    (B, S/n, KVH, D), kv_mask (B, S/n). K, V and the mask are gathered over
    `seq_axis`; the output is this rank's chunk (B, S/n, H, D). With one
    "seq" rank it is plain ``attention``. The decoder's ``attn_impl``."""
    n = mesh.size(seq_axis)

    def attn_impl(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
        if n == 1:
            return attention(q, k, v, kv_mask=kv_mask, causal=causal,
                             scale=scale)
        group = mesh.group(seq_axis)
        k_all = all_gather_dim(k, 1, group)
        v_all = all_gather_dim(v, 1, group)
        mask_all = None if kv_mask is None else gather_dim(kv_mask, 1, group)
        return attention(q, k_all, v_all, kv_mask=mask_all, causal=causal,
                         scale=scale,
                         q_offset=mesh.index(seq_axis) * q.shape[1])

    return attn_impl


def sequence_sharded_batch(mesh: Mesh, batch: dict,
                           seq_axis: str = SEQ_AXIS) -> tuple[dict, int]:
    """This rank's chunk of the text-sequence arrays of a batch
    (``token_ids``, ``labels``, ``attn_mask`` (B, S); ``positions``
    (3, B, S)) and the chunk's offset; the vision arrays stay whole. Shift
    the labels before this (the last position of every chunk predicts the
    next chunk's first token)."""
    s = batch["token_ids"].shape[1]
    off, chunk = seq_chunk(mesh, s, seq_axis)
    if mesh.size(seq_axis) == 1:
        return batch, 0
    out = dict(batch)
    for key in TEXT_KEYS:
        if batch.get(key) is not None:
            out[key] = batch[key][:, off:off + chunk]
    if batch.get("positions") is not None:
        out["positions"] = batch["positions"][:, :, off:off + chunk]
    return out, off
