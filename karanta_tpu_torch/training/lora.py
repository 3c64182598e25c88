"""LoRA adapters for the stacked-layer decoder (port of
``karanta_tpu/training/lora.py``).

Adapters on q/k/v/o and gate/up/down, base weights frozen. The adapters are
a parallel tree of (a, b) factors stacked over the layers axis: a target
(L, in, out) gets a (L, in, r) and b (L, r, out). The train step wraps each
target as ``{lora_base, a, b, scale}`` (``wrap_lora``), which the model's
matmul applies inline without building the merged weight, and
differentiates only the factors. ``merge_lora`` builds plain merged
weights for serving and export. QLoRA quantizes the targets of the frozen
base to NF4 first (``quantize_base_nf4``).

On a mesh (``make_lora_train_step(mesh=...)``) the frozen base holds this
rank's slices (``lora_base_placement``: ``train_param_axes``, with an NF4
target split only on 64-row block boundaries and kept whole over an axis
whose slices would cut blocks) and the factors stay whole on every rank
(rank 16 on the 3B decoder is about 30 M parameters):

- "fsdp": each decoder layer's base slices are gathered inside the
  checkpoint, as the full step's are.
- "model" (Megatron's placement): a column-parallel target (``wq``, ``wk``,
  ``wv``, ``gate``, ``up``) computes ``x @ a`` whole and uses this rank's
  columns of ``b``; a row-parallel target (``wo``, ``down``) multiplies
  this rank's rows of ``a`` by its slice of ``x`` and adds the float32
  partial of the delta to the base product's before the one sum over the
  group (``ops/quantization.py _lora_matmul``).
- Every rank's factor gradients are its share (its columns, its rows, its
  rows of the batch), so they are summed over "data", "fsdp", "seq" and
  "model" before the optimizer, which then steps identical whole factors
  on every rank.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from karanta_tpu_torch.ops.quantization import (NF4_BLOCK, NF4_KEY, is_nf4,
                                                nf4_dequantize, nf4_quantize)
from karanta_tpu_torch.parallel.mesh import (DATA_AXIS, FSDP_AXIS,
                                             MODEL_AXIS, SEQ_AXIS)
from karanta_tpu_torch.parallel.sharding import (Placement,
                                                 all_reduce_tensors,
                                                 own_slice, spec_from_logical)
from karanta_tpu_torch.training.optimizer import Optimizer, global_norm
from karanta_tpu_torch.training.train_step import (TrainState,
                                                   accumulate_grads,
                                                   make_loss_fn,
                                                   train_param_axes,
                                                   value_and_grad)

# target paths inside params["text"]["layers"]
ATTN_TARGETS = ("wq", "wk", "wv", "wo")
MLP_TARGETS = ("gate", "up", "down")


def init_lora_params(params: Any, rank: int, generator: torch.Generator,
                     alpha: float = 16.0, dtype=torch.float32) -> Any:
    """Adapters for every decoder attn/mlp target in `params`: a ~ N(0, 1/r)
    from `generator`, b zero (the adapted model starts as the base)."""
    layers = params["text"]["layers"]

    def factors(w):
        num_layers, d_in, d_out = w.shape
        a = torch.randn((num_layers, d_in, rank), generator=generator,
                        device=generator.device, dtype=torch.float32)
        return {"a": (a / rank ** 0.5).to(dtype),
                "b": torch.zeros((num_layers, rank, d_out), dtype=dtype,
                                 device=generator.device)}

    lora = {"attn": {n: factors(layers["attn"][n]) for n in ATTN_TARGETS},
            "mlp": {n: factors(layers["mlp"][n]) for n in MLP_TARGETS}}
    lora["alpha"] = torch.tensor(alpha, dtype=torch.float32,
                                 device=generator.device)
    lora["rank"] = rank
    return lora


def _replace_targets(params: Any, fn) -> Any:
    """params with every target leaf w replaced by fn(group, name, w)."""
    layers = params["text"]["layers"]
    new_attn = dict(layers["attn"])
    for name in ATTN_TARGETS:
        new_attn[name] = fn("attn", name, layers["attn"][name])
    new_mlp = dict(layers["mlp"])
    for name in MLP_TARGETS:
        new_mlp[name] = fn("mlp", name, layers["mlp"][name])
    new_layers = {**layers, "attn": new_attn, "mlp": new_mlp}
    return {**params, "text": {**params["text"], "layers": new_layers}}


def quantize_base_nf4(params: Any) -> Any:
    """QLoRA base: every adapter target quantized to NF4; the other leaves
    (embeddings, norms, the vision tower) stay as they are."""
    return _replace_targets(params, lambda group, name, w: nf4_quantize(w))


def _scale(lora: Any) -> torch.Tensor:
    return (torch.as_tensor(lora["alpha"]).float() / lora["rank"])


def _target_path(group: str, name: str) -> str:
    return f"text/layers/{group}/{name}"


def _own_where_whole(w: torch.Tensor, path: str, whole_shape,
                     placement: Placement) -> torch.Tensor:
    """This rank's slice of `w` along each dim that `placement` splits and
    `w` still holds whole (an NF4 target kept whole over an axis)."""
    for axis, dim in placement.dims(path).items():
        if w.shape[dim] == whole_shape[dim]:
            w = own_slice(w, dim, placement.mesh.group(axis))
    return w


def merge_lora(params: Any, lora: Any,
               placement: Optional[Placement] = None) -> Any:
    """params + scale * a @ b on every target (NF4 targets dequantized to
    bf16 first), as plain tensors. With `placement` (``train_param_axes``
    on the mesh) `params` holds this rank's base slices and the result this
    rank's slices of the merged weights (the whole factors' delta sliced to
    match)."""
    scale = _scale(lora)

    def merged(group, name, w):
        if is_nf4(w):
            w = nf4_dequantize(w, torch.bfloat16)
        f = lora[group][name]
        delta = torch.einsum("lir,lro->lio", f["a"].float(),
                             f["b"].float()) * scale
        if placement is not None:
            path = _target_path(group, name)
            w = _own_where_whole(w, path, delta.shape, placement)
            delta = placement.own(path, delta)
        return (w.float() + delta).to(w.dtype)

    return _replace_targets(params, merged)


def wrap_lora(params: Any, lora: Any,
              placement: Optional[Placement] = None) -> Any:
    """Every target leaf as {lora_base, a, b, scale}, each member with a
    leading layers axis (scale broadcast to (L,)), for the inline matmul.
    With `placement` (``train_param_axes`` on the mesh), a target split over
    "model" takes this rank's columns of b (column-parallel) or rows of a
    (row-parallel): views of the whole factors, so their gradients land in
    the rank's slice."""
    scale = _scale(lora)
    group = placement.mesh.group(MODEL_AXIS) if placement is not None \
        else None

    def wrapped(kind, name, w):
        f = lora[kind][name]
        a, b = f["a"], f["b"]
        dim = placement.dims(_target_path(kind, name)).get(MODEL_AXIS) \
            if group is not None else None
        if dim == 2:
            b = own_slice(b, 2, group)
        elif dim == 1:
            a = own_slice(a, 1, group)
        num_layers = a.shape[0]
        return {"lora_base": w, "a": a, "b": b,
                "scale": scale.to(a.device).expand(num_layers)}

    return _replace_targets(params, wrapped)


def trainable_lora(lora: Any) -> Any:
    """The differentiable subset (factors only, not alpha/rank)."""
    return {"attn": lora["attn"], "mlp": lora["mlp"]}


def with_factors(lora: Any, factors: Any) -> Any:
    return {**lora, "attn": factors["attn"], "mlp": factors["mlp"]}


def lora_base_placement(cfg, mesh, nf4: bool = False) -> Placement:
    """The frozen base's placement on `mesh` (``.shard(base)`` keeps this
    rank's slices of a whole base, quantized first for QLoRA):
    ``train_param_axes``, with each NF4 target as ``{nf4_q, absmax}`` split
    with the matrix it packs along both its dims, except that an axis whose
    slices of the reduction dim would cut 64-row absmax blocks leaves that
    dim whole (``ops/quantization.py _lora_matmul`` then slices the
    dequantized rows)."""
    axes = train_param_axes(cfg)
    if nf4:
        t = cfg.text
        d_in = {"wq": t.hidden_size, "wk": t.hidden_size,
                "wv": t.hidden_size, "wo": t.num_heads * t.head_dim,
                "gate": t.hidden_size, "up": t.hidden_size,
                "down": t.intermediate_size}
        layers = axes["text"]["layers"]
        for group, names in (("attn", ATTN_TARGETS), ("mlp", MLP_TARGETS)):
            for name in names:
                ax = tuple(layers[group][name])
                mesh_axis = spec_from_logical(ax)[1]
                n = mesh.size(mesh_axis) if mesh_axis is not None else 1
                if n > 1 and (d_in[name] // n) % NF4_BLOCK:
                    ax = (ax[0], None, ax[2])
                layers[group][name] = {NF4_KEY: ax, "absmax": ax}
    return Placement(axes, mesh)


def make_lora_train_step(cfg, optimizer: Optimizer, remat: bool = False,
                         grad_accum: int = 1, ce_chunk: int = 512,
                         sp_mesh=None, mesh=None):
    """(state, base_params, lora_template, batch) -> (state, metrics); the
    state holds the factors and their optimizer state (updated in place, as
    in ``make_train_step``), the base is frozen. The forward applies the
    factors inline (``wrap_lora``), never materialising merged weights.

    sp_mesh / mesh: as ``make_train_step``'s, over any of "data", "fsdp",
    "model" and "seq" (see the module docstring): `base_params` then holds
    this rank's slices, ``lora_base_placement(cfg, mesh, nf4).shard(base)``
    (nf4: a QLoRA base), and the factors are whole on every rank."""
    plan_mesh = mesh or sp_mesh
    logical = Placement(train_param_axes(cfg), plan_mesh) \
        if plan_mesh is not None else None
    loss_fns: dict = {}

    def loss_fn_for(nf4: bool):
        # the base's placement depends on whether it is NF4 (block bounds)
        if nf4 not in loss_fns:
            loss_fns[nf4] = make_loss_fn(
                cfg, remat=remat, ce_chunk=ce_chunk, sp_mesh=sp_mesh,
                mesh=mesh, placement=(lora_base_placement(cfg, plan_mesh, nf4)
                                      if plan_mesh is not None else None))
        return loss_fns[nf4]

    def reduce(grads: dict) -> None:
        # every factor gradient is this rank's share: sum over every axis
        for axis in (DATA_AXIS, FSDP_AXIS, SEQ_AXIS, MODEL_AXIS):
            all_reduce_tensors(list(grads.values()), plan_mesh.group(axis))

    def grad_once(factors, base_params, lora_template, mb):
        """(loss, tokens, flat grads) of one microbatch, before any sum
        over the ranks."""
        loss_fn = loss_fn_for(is_nf4(base_params["text"]["layers"]["attn"]
                                     ["wq"]))

        def lora_loss(live, mb):
            lora = with_factors(lora_template, live)
            return loss_fn(wrap_lora(base_params, lora, logical), mb)

        return value_and_grad(lora_loss, factors, mb)

    def train_step(state: TrainState, base_params, lora_template,
                   batch: dict):
        grads, loss, tokens = accumulate_grads(
            lambda mb: grad_once(state.params, base_params, lora_template,
                                 mb),
            state.params, batch, grad_accum,
            reduce=reduce if plan_mesh is not None else None)
        grad_norm = global_norm(grads)
        factors, opt_state = optimizer.step(grads, state.opt_state,
                                            state.params)
        return (TrainState(factors, opt_state, state.step + 1),
                {"loss": loss, "tokens": tokens, "grad_norm": grad_norm})

    train_step.grad_once = grad_once
    train_step.reduce = reduce if plan_mesh is not None else None
    return train_step
