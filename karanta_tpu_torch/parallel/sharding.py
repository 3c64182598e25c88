"""Logical-axis sharding rules and the collectives of the sharded model
(port of ``karanta_tpu/parallel/sharding.py``).

The model code annotates parameters with logical axis names ("embed",
"mlp", "heads", ...); a rule table maps them onto mesh axes. In the JAX
package ``jax.device_put`` then places each shard and XLA inserts the
collectives; here ``shard_leaf`` keeps the contiguous slice this rank owns
along each mapped dim, and the model calls the collectives below, each a
plain function with an explicit process group (None: a one-rank axis, the
identity). These helpers are the only callers of ``torch.distributed``
collectives in the package, and they count their calls and host seconds in
``STATS`` (the share of host time a step spends in collectives).

Backends: NCCL takes every collective on CUDA tensors. Gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only (staged through the host),
so on gloo ``all_gather_last`` is an ``all_reduce_sum`` of a zero-filled
full-size buffer into which each rank wrote its slice: exact, since every
other rank adds zeros.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from karanta_tpu_torch.parallel.mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS,
                                             Mesh)

# rule: logical axis name -> mesh axis (or None = replicated)
LogicalAxisRules = tuple[tuple[str, Optional[str]], ...]

# Default rules: embed dim sharded over fsdp (zero-like param sharding),
# head/mlp output dims over model (tensor parallel), batch over data.
DEFAULT_RULES: LogicalAxisRules = (
    ("batch", DATA_AXIS),
    ("embed", FSDP_AXIS),
    ("heads", MODEL_AXIS),
    ("kv_heads", MODEL_AXIS),
    ("mlp", MODEL_AXIS),
    ("vocab", MODEL_AXIS),
    ("head_dim", None),
    ("seq", None),
    ("kv_seq", None),
    ("layers", None),
    ("patch", None),
    ("vit_embed", None),
    ("vit_mlp", MODEL_AXIS),
    ("vit_heads", MODEL_AXIS),
)

# Rules for pure data-parallel (inference on small meshes / tests).
REPLICATED_RULES: LogicalAxisRules = (("batch", DATA_AXIS),)

# calls and host seconds of the collectives below, since the last reset
STATS = {"calls": 0, "seconds": 0.0}


def reset_stats() -> None:
    STATS["calls"] = 0
    STATS["seconds"] = 0.0


def spec_from_logical(logical_axes: Sequence[Optional[str]],
                      rules: LogicalAxisRules = DEFAULT_RULES) -> tuple:
    """Logical axes -> one mesh axis (or None) per dim: the entries of the
    JAX package's ``PartitionSpec``. A mesh axis appears at most once."""
    table = dict(rules)
    mesh_axes = []
    used: set[str] = set()
    for ax in logical_axes:
        mapped = table.get(ax) if ax is not None else None
        if mapped is not None and mapped in used:
            mapped = None  # a mesh axis can appear at most once in a spec
        if mapped is not None:
            used.add(mapped)
        mesh_axes.append(mapped)
    return tuple(mesh_axes)


def shard_leaf(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
               mesh: Mesh, rules: LogicalAxisRules = DEFAULT_RULES,
               name: str = "leaf") -> torch.Tensor:
    """The contiguous block of `x` this rank owns: along each dim mapped to
    a mesh axis of size n, slice i of n equal slices, i = the rank's index
    on that axis. A view of `x`. A dim that does not split evenly raises
    ValueError naming the leaf and the axis, as ``jax.device_put`` refuses
    an uneven split."""
    spec = spec_from_logical(logical_axes, rules)
    if len(spec) != x.dim():
        raise ValueError(f"{name}: {len(spec)} logical axes for a tensor of "
                         f"shape {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        n = mesh.size(axis) if axis is not None else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(
                f"{name}: dim {dim} ({logical_axes[dim]}) of size "
                f"{x.shape[dim]} does not split evenly over mesh axis "
                f"{axis!r} of size {n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * step, step)
    return x


def shard_quantized(w: dict, logical_axes: Sequence[Optional[str]],
                    mesh: Mesh, rules: LogicalAxisRules = DEFAULT_RULES,
                    name: str = "leaf") -> dict:
    """Shard a quantized leaf ``{int8_q (..., in, out), scale (..., 1,
    out)}`` quantized whole: the int8 matrix along its axes, the scale along
    its output axis only (per output channel, each scale spans the whole
    input dim). The int8 slice keeps the out-major storage of
    ``quantize_weight``."""
    from karanta_tpu_torch.ops.quantization import QUANT_KEY, out_major

    axes = tuple(logical_axes)
    q = shard_leaf(w[QUANT_KEY], axes, mesh, rules, name)
    scale = shard_leaf(w["scale"], axes[:-2] + (None, axes[-1]), mesh, rules,
                       name + ".scale")
    return {**w, QUANT_KEY: out_major(q), "scale": _own(scale, w["scale"])}


def _own(part: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """A shard on storage of its own (contiguous), so the whole leaf it was
    cut from can be freed."""
    if part.numel() < whole.numel() and part.device == whole.device:
        return part.clone(memory_format=torch.contiguous_format)
    return part.contiguous()


def shard_params(tree: Any, axes_tree: Any, mesh: Mesh,
                 rules: LogicalAxisRules = DEFAULT_RULES,
                 device: Optional[torch.device] = None,
                 path: str = "") -> Any:
    """Map shard_leaf over a parameter tree, whose quantized leaves go
    through shard_quantized. `axes_tree` holds one logical-axes tuple per
    leaf of `tree` (extra entries are ignored). Each shard lands on `device`
    when given, on storage of its own."""
    if isinstance(tree, dict) and "int8_q" not in tree:
        return {k: shard_params(v, axes_tree[k], mesh, rules, device,
                                f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, dict):
        out = shard_quantized(tree, axes_tree, mesh, rules, path)
        return {k: v.to(device) if device is not None else v
                for k, v in out.items()}
    out = shard_leaf(tree, axes_tree, mesh, rules, path)
    return _own(out.to(device) if device is not None else out, tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the group's ranks, in place when `x` is contiguous;
    returns the sum. Integer sums are exact."""
    if group is None:
        return x
    x = x.contiguous()
    _timed(lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group))
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise max of `x` over the group's ranks, in place when `x`
    is contiguous; returns the max."""
    if group is None:
        return x
    x = x.contiguous()
    _timed(lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group))
    return x


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` concatenated along the last dim in group-rank order.
    NCCL gathers; gloo sums a zero-filled (n, *x.shape) buffer in which
    each rank wrote its own slice (gloo gathers no CUDA tensors)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        parts = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
        _timed(lambda: dist.all_gather_into_tensor(parts, x.contiguous(),
                                                   group=group))
    else:
        parts = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device)
        parts[dist.get_rank(group)] = x
        all_reduce_sum(parts, group)
    return torch.movedim(parts, 0, -2).reshape(
        tuple(x.shape[:-1]) + (n * x.shape[-1],))


def barrier(group) -> None:
    """Wait until every rank of the group is here."""
    if group is not None:
        _timed(lambda: dist.barrier(group=group))


def broadcast_objects(objs: list, src: int, group) -> list:
    """Picklable host objects from world rank `src` to every rank of the
    group (a gloo group: ``Mesh.cpu_group``), in place; returns the list.
    Only objects this program's ranks wrote are unpickled."""
    if group is None:
        return objs
    _timed(lambda: dist.broadcast_object_list(objs, src=src, group=group))
    return objs


def gather_objects(obj: Any, dst: int, group) -> Optional[list]:
    """Every rank's picklable `obj` to world rank `dst` over a gloo group,
    in group-rank order: the list on `dst`, None elsewhere."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group) if dist.get_rank() == dst \
        else None
    _timed(lambda: dist.gather_object(obj, out, dst=dst, group=group))
    return out
