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

Training differentiates through the collectives, so each has an autograd
form (the backward is itself a collective over the same group):

- ``copy_to_group`` / ``reduce_from_group``: Megatron's pair for tensor
  parallelism. The first is the identity forward and sums the gradient over
  the group backward (before a column-parallel product: each rank's
  backward sees only its columns' share of the input's gradient); the
  second sums forward (a row-parallel product's partials) and passes the
  gradient through.
- ``gather_from_group``: all-gather along a dim forward, this rank's slice
  of the gradient backward (the consumers of the gathered tensor are the
  same on every rank: the vocab-parallel logits, the tower's gathered
  activations).
- ``all_gather_dim``: all-gather along a dim forward, the sum of the
  gradient over the group then this rank's slice backward
  (``reduce_scatter_dim``): each rank's consumers differ (K/V gathered over
  "seq", FSDP's gathered weights), so every rank's share must be summed.
- ``send_to`` / ``recv_from``: point-to-point between pipeline stages.

Backends: NCCL takes every collective on CUDA tensors. Gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast`` only (staged through the host),
so on gloo a gather is an ``all_reduce_sum`` of a zero-filled full-size
buffer into which each rank wrote its slice (exact, since every other rank
adds zeros), a reduce-scatter is an ``all_reduce_sum`` and a slice, and
send/recv stage CUDA tensors through host buffers.
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


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in group-rank order (no
    autograd). NCCL gathers; gloo sums a zero-filled (n, *x.shape) buffer
    in which each rank wrote its own slice (gloo gathers no CUDA tensors)."""
    if group is None:
        return x
    dim = dim % x.dim()
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
    shape = list(x.shape)
    shape[dim] *= n
    return torch.movedim(parts, 0, dim).reshape(shape)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` concatenated along the last dim in group-rank order."""
    return gather_dim(x, -1, group)


def own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n block of `x` along `dim` (a view)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * step, step)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of `x` over the group, this rank's 1/n block along `dim`.
    NCCL reduce-scatters; gloo sums the whole tensor and slices it."""
    if group is None:
        return x
    dim = dim % x.dim()
    if dist.get_backend(group) == "nccl":
        n = dist.get_world_size(group)
        src = torch.movedim(x, dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _timed(lambda: dist.reduce_scatter_tensor(out, src, group=group))
        return torch.movedim(out, 0, dim)
    return own_slice(all_reduce_sum(x.clone(), group), dim,
                     group).contiguous()


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the group backward (the
    input of a column-parallel product)."""
    if group is None or not _needs_grad(x):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce_sum forward (in place on `x` when no gradient is taken);
    the gradient passed through backward (a row-parallel product)."""
    if group is None or not _needs_grad(x):
        return all_reduce_sum(x, group)
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """gather_dim forward; this rank's slice of the gradient backward (for
    a gathered tensor whose consumers are the same on every rank)."""
    if group is None or not _needs_grad(x):
        return gather_dim(x, dim, group)
    return _GatherFromGroup.apply(x, dim, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """gather_dim forward; reduce_scatter_dim of the gradient backward (for
    a gathered tensor whose consumers differ by rank: K/V over "seq",
    FSDP's weights)."""
    if group is None or not _needs_grad(x):
        return gather_dim(x, dim, group)
    return _AllGatherDim.apply(x, dim, group)


def _peer(group, group_rank: int) -> int:
    return dist.get_global_rank(group, group_rank)


def send_to(x: torch.Tensor, group_rank: int, group) -> None:
    """Send `x` to the rank at `group_rank` of the group (blocking). On
    gloo a CUDA tensor goes through a host copy."""
    x = x.detach().contiguous()
    if x.is_cuda and dist.get_backend(group) != "nccl":
        x = x.cpu()
    _timed(lambda: dist.send(x, dst=_peer(group, group_rank), group=group))


def recv_from(shape, dtype, device, group_rank: int, group) -> torch.Tensor:
    """Receive a tensor of `shape` and `dtype` from the rank at
    `group_rank` of the group, on `device` (blocking)."""
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend(group) != "nccl"
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else device)
    _timed(lambda: dist.recv(buf, src=_peer(group, group_rank), group=group))
    return buf.to(device) if staged else buf


# elements per bucket of all_reduce_tensors: 64 Mi (128 MiB of bf16)
_BUCKET = 1 << 26


def all_reduce_tensors(tensors: list, group) -> None:
    """Sum each tensor of the list over the group, in place, in buckets of
    one dtype and device (one collective per bucket, not per tensor)."""
    if group is None:
        return
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for items in by_kind.values():
        start = 0
        while start < len(items):
            bucket, size = [], 0
            while start < len(items) and (not bucket or size
                                          + items[start].numel() <= _BUCKET):
                bucket.append(items[start])
                size += items[start].numel()
                start += 1
            flat = all_reduce_sum(
                torch.cat([t.reshape(-1) for t in bucket]), group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


class Placement:
    """Where each leaf of a parameter tree lives on the mesh: per flat path
    ("/"-joined, as ``utils.tree.flatten_tree`` writes them), the dims
    split over mesh axes of size > 1. Leaves missing from the axes tree are
    whole on every rank."""

    def __init__(self, axes_tree: Any, mesh: Mesh,
                 rules: LogicalAxisRules = DEFAULT_RULES):
        from karanta_tpu_torch.utils.tree import flatten_tree

        self.mesh, self.rules, self.axes_tree = mesh, rules, axes_tree
        self.split: dict = {}
        for path, axes in flatten_tree(axes_tree).items():
            dims = {axis: dim for dim, axis in
                    enumerate(spec_from_logical(axes, rules))
                    if axis is not None and mesh.size(axis) > 1}
            if dims:
                self.split[path] = dims

    def dims(self, path: str) -> dict:
        """{mesh axis: dim} of the leaf at `path`."""
        return self.split.get(path, {})

    def shard(self, tree: Any) -> Any:
        """This rank's slices of a whole tree (shard_params)."""
        return shard_params(tree, _axes_for(tree, self.axes_tree), self.mesh,
                            self.rules)

    def whole(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's slice (gathered over every axis
        that splits it; no autograd)."""
        for axis, dim in self.dims(path).items():
            x = gather_dim(x, dim, self.mesh.group(axis))
        return x

    def own(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole leaf (a view)."""
        for axis, dim in self.dims(path).items():
            x = own_slice(x, dim, self.mesh.group(axis))
        return x

    def sum_squares(self, flat: dict) -> torch.Tensor:
        """The global sum of squares of a flat tree of this rank's slices
        (float32): each leaf's local sum, divided by the number of ranks
        that hold the same slice, summed over the axes that split leaves."""
        axes = [a for a in (FSDP_AXIS, MODEL_AXIS) if self.mesh.size(a) > 1]
        total = None
        for path, g in flat.items():
            s = (g * g).sum().float()
            dims = self.dims(path)
            for a in axes:
                if a not in dims:
                    s = s / self.mesh.size(a)
            total = s if total is None else total + s
        if total is None:
            return torch.zeros(())
        for a in axes:
            total = all_reduce_sum(total, self.mesh.group(a))
        return total

    def any_true(self, flag: bool, device) -> bool:
        """`flag` or-ed over the ranks that hold different slices."""
        axes = [a for a in (FSDP_AXIS, MODEL_AXIS) if self.mesh.size(a) > 1]
        if not axes:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        for a in axes:
            t = all_reduce_max(t, self.mesh.group(a))
        return bool(t.item() > 0)


def _axes_for(tree: Any, axes: Any) -> Any:
    """The axes tree restricted to `tree`'s keys; leaves without an entry
    stay whole (None on every dim)."""
    if isinstance(tree, dict) and "int8_q" not in tree:
        return {k: _axes_for(v, axes.get(k) if isinstance(axes, dict)
                             else None) for k, v in tree.items()}
    if axes is None or isinstance(axes, dict):
        return (None,) * tree.dim()
    return axes


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
