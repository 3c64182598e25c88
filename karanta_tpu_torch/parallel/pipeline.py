"""Pipeline parallelism over the "pipe" mesh axis (port of
``karanta_tpu/parallel/pipeline.py``).

Each stage (a rank's index on "pipe") runs L/n contiguous layers of the
stacked layer tree, and microbatches stream through a GPipe schedule: at
tick t, stage i runs microbatch t - i, taking it from the embeddings (stage
0) or from stage i - 1 (``recv_from``), and hands its output to stage i + 1
(``send_to``); n_micro + n - 1 ticks in all. The last stage's outputs reach
every stage through a sum over "pipe" in which the other stages add zeros,
as the JAX ``psum`` does, so every stage holds the same outputs and runs the
same loss after them.

The schedule is one autograd Function. Its forward keeps each stage's input
of each microbatch and nothing else; its backward runs the ticks in reverse
order: the last stage takes its output gradient (only the last stage's
outputs carry gradient), every stage recomputes its layers on the saved
input and differentiates them, and hands the input's gradient to stage
i - 1. At the end the first stage's input gradients reach every stage (a sum
over "pipe" again) and each stage's layer gradients are summed over "pipe"
into the whole stack's, so every stage returns the unsharded gradients.

The layer tree is whole on every stage, as the JAX package's rules place it
("layers" is not split), and each stage computes with its own L/n layers.
The batch a stage sees is its rank's rows (the caller splits rows over
"data"); it must divide ``n_micro``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from karanta_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh
from karanta_tpu_torch.parallel.sharding import (all_reduce_sum,
                                                 all_reduce_tensors,
                                                 recv_from, send_to)
from karanta_tpu_torch.utils.tree import (flatten_tree, unbind_layers,
                                          unflatten_tree)


def _chunks(tree: Any, n: int) -> list:
    """n microbatch views of a tree (tuples, dicts, tensors, None) of
    per-row tensors, split along the leading axis."""
    if tree is None:
        return [None] * n
    if isinstance(tree, tuple):
        parts = [_chunks(t, n) for t in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    if isinstance(tree, dict):
        parts = {k: _chunks(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.chunk(tree, n, dim=0))


class _Stage:
    """One stage's share of the schedule: its layers, its neighbours and
    the microbatched extras."""

    def __init__(self, mesh: Mesh, pipe_axis: str, layer_fn: Callable,
                 paths: list, extras: Any, n_micro: int):
        self.n = mesh.size(pipe_axis)
        self.idx = mesh.index(pipe_axis)
        self.group = mesh.group(pipe_axis)
        self.layer_fn = layer_fn
        self.paths = paths
        self.extras = _chunks(extras, n_micro)
        self.n_micro = n_micro

    def own(self, leaves: list) -> list:
        per = leaves[0].shape[0] // self.n
        return [x.narrow(0, self.idx * per, per) for x in leaves]

    def run(self, act: torch.Tensor, own_leaves: list, m: int
            ) -> torch.Tensor:
        tree = unflatten_tree(dict(zip(self.paths, own_leaves)))
        for layer in unbind_layers(tree, own_leaves[0].shape[0]):
            act = self.layer_fn(act, layer, self.extras[m])
        return act

    def ticks(self):
        """The microbatches this stage works on, in schedule order (tick t
        runs microbatch t - stage)."""
        for t in range(self.n_micro + self.n - 1):
            m = t - self.idx
            if 0 <= m < self.n_micro:
                yield m


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage: _Stage, x: torch.Tensor, *leaves):
        own = stage.own(leaves)
        x_mb = torch.chunk(x, stage.n_micro, dim=0)
        shape = x_mb[0].shape
        inputs: list = [None] * stage.n_micro
        outputs = torch.zeros_like(x)
        out_mb = torch.chunk(outputs, stage.n_micro, dim=0)
        for m in stage.ticks():
            act = (x_mb[m] if stage.idx == 0 else
                   recv_from(shape, x.dtype, x.device, stage.idx - 1,
                             stage.group))
            inputs[m] = act
            out = stage.run(act, own, m)
            if stage.idx < stage.n - 1:
                send_to(out, stage.idx + 1, stage.group)
            else:
                out_mb[m].copy_(out)
        ctx.stage, ctx.inputs = stage, inputs
        ctx.save_for_backward(*leaves)
        return all_reduce_sum(outputs, stage.group)

    @staticmethod
    def backward(ctx, gout):
        stage = ctx.stage
        leaves = ctx.saved_tensors
        own = [x.detach() for x in stage.own(leaves)]
        acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
               for x in own]
        gout_mb = torch.chunk(gout.contiguous(), stage.n_micro, dim=0)
        dx = torch.zeros_like(gout)
        dx_mb = torch.chunk(dx, stage.n_micro, dim=0)
        shape = gout_mb[0].shape
        for m in reversed(list(stage.ticks())):
            dout = (gout_mb[m] if stage.idx == stage.n - 1 else
                    recv_from(shape, gout.dtype, gout.device, stage.idx + 1,
                              stage.group))
            with torch.enable_grad():
                act = ctx.inputs[m].detach().requires_grad_(True)
                live = [x.requires_grad_(True) for x in
                        (y.detach() for y in own)]
                out = stage.run(act, live, m)
                grads = torch.autograd.grad(out, [act] + live, dout,
                                            allow_unused=True)
            ctx.inputs[m] = None
            for a, g in zip(acc, grads[1:]):
                if g is not None:
                    a.add_(g)
            if stage.idx > 0:
                send_to(grads[0], stage.idx - 1, stage.group)
            else:
                dx_mb[m].copy_(grads[0])
        all_reduce_sum(dx, stage.group)
        whole = []
        for x, a in zip(leaves, acc):
            g = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            per = a.shape[0]
            g.narrow(0, stage.idx * per, per).copy_(a)
            whole.append(g)
        all_reduce_tensors(whole, stage.group)
        return (None, dx) + tuple(g.to(x.dtype) for g, x in
                                  zip(whole, leaves))


def pipeline_apply(mesh: Mesh, layer_fn: Callable[[torch.Tensor, Any, Any],
                                                  torch.Tensor],
                   layers: Any, x: torch.Tensor, extras: Any, n_micro: int,
                   pipe_axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run x through a stacked layer tree under the GPipe schedule.

    layer_fn(activation, one_layer_params, extras_microbatch) -> activation:
    the body a plain loop over the layers would run. layers: the whole tree
    with a leading stacked-layers axis L (L % n_stages == 0). x: (B, S, H),
    this rank's rows. extras: a tuple, dict or tensor tree (None entries
    allowed) of per-row tensors (rope tables, masks), microbatched alongside
    x. n_micro must divide B. Returns the last stage's outputs (B, S, H) on
    every stage. With one stage the layers run as a plain loop."""
    n = mesh.size(pipe_axis)
    flat = flatten_tree(layers)
    n_layers = next(iter(flat.values())).shape[0]
    if n == 1:
        for layer in unbind_layers(layers, n_layers):
            x = layer_fn(x, layer, extras)
        return x
    if n_layers % n:
        raise ValueError(f"{n_layers} layers must divide {n} pipeline stages")
    if x.shape[0] % n_micro:
        raise ValueError(
            f"per-stage batch {x.shape[0]} must divide n_micro={n_micro}")
    stage = _Stage(mesh, pipe_axis, layer_fn, list(flat), extras, n_micro)
    return _GPipe.apply(stage, x, *flat.values())
