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
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from karanta_tpu_torch.ops.quantization import (is_nf4, nf4_dequantize,
                                                nf4_quantize)
from karanta_tpu_torch.training.optimizer import Optimizer, global_norm
from karanta_tpu_torch.training.train_step import (TrainState,
                                                   accumulate_grads,
                                                   make_loss_fn,
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


def merge_lora(params: Any, lora: Any) -> Any:
    """params + scale * a @ b on every target (NF4 targets dequantized to
    bf16 first), as plain tensors."""
    scale = _scale(lora)

    def merged(group, name, w):
        if is_nf4(w):
            w = nf4_dequantize(w, torch.bfloat16)
        f = lora[group][name]
        delta = torch.einsum("lir,lro->lio", f["a"].float(),
                             f["b"].float()) * scale
        return (w.float() + delta).to(w.dtype)

    return _replace_targets(params, merged)


def wrap_lora(params: Any, lora: Any) -> Any:
    """Every target leaf as {lora_base, a, b, scale}, each member with a
    leading layers axis (scale broadcast to (L,)), for the inline matmul."""
    scale = _scale(lora)

    def wrapped(group, name, w):
        f = lora[group][name]
        num_layers = f["a"].shape[0]
        return {"lora_base": w, "a": f["a"], "b": f["b"],
                "scale": scale.to(f["a"].device).expand(num_layers)}

    return _replace_targets(params, wrapped)


def trainable_lora(lora: Any) -> Any:
    """The differentiable subset (factors only, not alpha/rank)."""
    return {"attn": lora["attn"], "mlp": lora["mlp"]}


def with_factors(lora: Any, factors: Any) -> Any:
    return {**lora, "attn": factors["attn"], "mlp": factors["mlp"]}


def make_lora_train_step(cfg, optimizer: Optimizer, remat: bool = False,
                         grad_accum: int = 1, ce_chunk: int = 512,
                         sp_mesh=None, mesh=None):
    """(state, base_params, lora_template, batch) -> (state, metrics); the
    state holds the factors and their optimizer state (updated in place, as
    in ``make_train_step``), the base is frozen. The forward applies the
    factors inline (``wrap_lora``), never materialising merged weights.

    sp_mesh / mesh: as ``make_train_step``'s, over "data" and "seq" (the
    base and the factors whole on every rank); a mesh that splits "fsdp" or
    "model" raises NotImplementedError (ROADMAP.md, queue 1: LoRA under
    fsdp and model)."""
    from karanta_tpu_torch.parallel.sharding import Placement

    for m in (mesh, sp_mesh):
        if m is not None and (m.size("fsdp") > 1 or m.size("model") > 1):
            raise NotImplementedError(
                "LoRA/QLoRA over the fsdp or model mesh axes is not ported "
                "(ROADMAP.md, queue 1: LoRA under fsdp and model)")
    loss_fn = make_loss_fn(cfg, remat=remat, ce_chunk=ce_chunk,
                           sp_mesh=sp_mesh, mesh=mesh)
    plan = loss_fn.plan
    reduce = None
    if plan is not None:
        whole = Placement({}, plan.mesh)
        reduce = functools.partial(plan.reduce_grads, placement=whole)

    def train_step(state: TrainState, base_params, lora_template,
                   batch: dict):
        def lora_loss(factors, mb):
            lora = with_factors(lora_template, factors)
            return loss_fn(wrap_lora(base_params, lora), mb)

        grads, loss, tokens = accumulate_grads(
            lambda mb: value_and_grad(lora_loss, state.params, mb),
            state.params, batch, grad_accum, reduce=reduce)
        grad_norm = global_norm(grads)
        factors, opt_state = optimizer.step(grads, state.opt_state,
                                            state.params)
        return (TrainState(factors, opt_state, state.step + 1),
                {"loss": loss, "tokens": tokens, "grad_norm": grad_norm})

    return train_step
