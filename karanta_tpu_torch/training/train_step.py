"""The training step: loss, gradients and the optimizer update (port of
``karanta_tpu/training/train_step.py``).

Instruction-masked next-token cross entropy (labels == -100 ignored) over
chunks of 512 rows, so the (B, S, vocab) logits never exist at once;
gradient accumulation over microbatches in a float32 accumulator; optional
rematerialization per decoder layer and per vision block. The step is
eager: ``make_train_step`` returns a function (state, batch) -> (state,
metrics) that updates the state's tensors in place.

Parallel training (``mesh``, ``sp_mesh``, ``pp_mesh``: ``ParallelPlan``).
Every rank is given the same global batch and computes its own share:

- "data" (and "fsdp", when a microbatch's rows divide data x fsdp): each
  rank takes its rows of every global microbatch, so each microbatch's
  loss is still its global token sum over its global token count (the
  JAX step's grouping): a rank's loss term is its local sum over the
  count summed over the ranks. Ranks that hold the same rows (a batch that
  does not divide the axis) weight their terms by 1 / their number.
- "fsdp": the parameters and the optimizer state hold this rank's slice of
  the "embed" dim (``DEFAULT_RULES``); each decoder layer's leaves are
  gathered before use (inside the checkpoint, so again in the recompute)
  and the gather's backward reduce-scatters the gradients.
- "model": tensor parallelism with the serving path's placement
  (``train_param_axes``) and Megatron's collectives (``parallel/
  sharding.py``): every rank of the group computes the same loss.
- "seq": each rank holds S/n positions of the text arrays, shifted labels
  included; attention gathers K/V (``parallel/context.py``).
- "pipe": the decoder layers run under GPipe (``parallel/pipeline.py``).

The loss every rank reports is the global one; its gradient is the rank's
own term's. After the microbatches the gradients are summed over "data",
"seq" and "fsdp" (the leaves that "fsdp" does not split), so each rank
holds the global gradient of its slices; the optimizer's norm, finiteness
check and Muon's orthogonalization see whole leaves (``optimizer.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig
from karanta_tpu_torch.models.qwen25_vl.decoder import logits_from_hidden
from karanta_tpu_torch.models.qwen25_vl.model import (forward_train,
                                                      serving_param_axes)
from karanta_tpu_torch.ops.quantization import LORA_KEY
from karanta_tpu_torch.parallel.mesh import (DATA_AXIS, FSDP_AXIS,
                                             MODEL_AXIS, PIPE_AXIS, SEQ_AXIS,
                                             Mesh)
from karanta_tpu_torch.parallel.sharding import (Placement, all_gather_dim,
                                                 all_reduce_sum,
                                                 all_reduce_tensors)
from karanta_tpu_torch.training.optimizer import Optimizer, global_norm
from karanta_tpu_torch.utils.tree import flatten_tree, tree_map

IGNORE_INDEX = -100


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor


def create_train_state(params: Any, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def cross_entropy_loss(logits: torch.Tensor,   # (B, S, V)
                       labels: torch.Tensor,   # (B, S), IGNORE_INDEX masked
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions. Returns (loss, token_count)."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    count = torch.clamp(mask.sum(), min=1)
    return -(token_logp * mask).sum() / count, mask.sum()


def _ce_sums(text_params, text_cfg, hidden: torch.Tensor,
             labels: torch.Tensor, chunk: int, group=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed CE, token count) over non-ignored positions, one chunk of
    rows at a time: each chunk's logits and float32 log-softmax are
    checkpointed, so the backward recomputes them and the full
    (B, S, vocab) logits never exist. `group`: a vocab-parallel head's."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)

    def chunk_sums(h_c, l_c):
        logits = logits_from_hidden(text_params, text_cfg, h_c, group=group)
        mask = l_c != IGNORE_INDEX
        safe = torch.where(mask, l_c, 0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        token_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
        return -(token_logp * mask).sum(), mask.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for start in range(0, s, chunk):
        h_c = hidden[:, start:start + chunk]
        l_c = labels[:, start:start + chunk]
        if torch.is_grad_enabled() and h_c.requires_grad:
            cl, cc = checkpoint(chunk_sums, h_c, l_c, use_reentrant=False)
        else:
            cl, cc = chunk_sums(h_c, l_c)
        loss_sum = loss_sum + cl
        count = count + cc
    return loss_sum, count


def chunked_cross_entropy(text_params, text_cfg,
                          hidden: torch.Tensor,   # (B, S, H) post-final-norm
                          labels: torch.Tensor,   # (B, S) aligned to hidden
                          chunk: int = 512,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions (``_ce_sums`` divided by the
    count)."""
    loss_sum, count = _ce_sums(text_params, text_cfg, hidden, labels, chunk)
    return loss_sum / torch.clamp(count, min=1), count


def train_param_axes(cfg: VLMConfig) -> Any:
    """Where the trained parameters live on a mesh: the serving engine's
    placement with the bf16 tower (``model.serving_param_axes``): the
    decoder's heads and MLP columns over "model" (``wo`` and ``down``
    row-parallel, a vocab-parallel head), the tower's heads and MLP columns
    over "model" with its output products whole, the input embedding, the
    patch embedding and the merger whole over "model"; the "embed" dim of
    the decoder's leaves over "fsdp" (``DEFAULT_RULES``)."""
    return serving_param_axes(cfg)


class ParallelPlan:
    """One rank's part in a training step over `mesh` (see the module
    docstring): which rows it takes, what it gathers, what it sums."""

    def __init__(self, cfg: VLMConfig, mesh: Mesh,
                 placement: Optional[Placement] = None):
        self.mesh = mesh
        self.placement = placement or Placement(train_param_axes(cfg), mesh)
        self.group = mesh.group(MODEL_AXIS)
        self.fsdp = mesh.group(FSDP_AXIS)

    def rows(self, b: int, replicated: bool = False) -> tuple:
        """(row slice, term weight, axes whose ranks split the rows) of a
        b-row microbatch on this rank."""
        m = self.mesh
        nd, nf = m.size(DATA_AXIS), m.size(FSDP_AXIS)
        if not replicated and nd * nf > 1 and b % (nd * nf) == 0:
            per = b // (nd * nf)
            i = m.index(DATA_AXIS) * nf + m.index(FSDP_AXIS)
            return slice(i * per, (i + 1) * per), 1.0, (DATA_AXIS, FSDP_AXIS)
        if not replicated and nd > 1 and b % nd == 0:
            per = b // nd
            i = m.index(DATA_AXIS)
            return slice(i * per, (i + 1) * per), 1.0 / nf, (DATA_AXIS,)
        return slice(None), 1.0 / (nd * nf), ()

    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        for axis in axes:
            x = all_reduce_sum(x, self.mesh.group(axis))
        return x

    def _gather(self, path: str, x: torch.Tensor, shift: int = 0):
        # an inline-LoRA leaf's base is placed as the target it wraps; its
        # factors are whole
        path = "/".join(p for p in path.split("/") if p != LORA_KEY)
        dim = self.placement.dims(path).get(FSDP_AXIS)
        return x if dim is None else all_gather_dim(x, dim - shift,
                                                    self.fsdp)

    def gather_top(self, params: Any) -> Any:
        """The parameters with every FSDP-split leaf outside the decoder's
        layer stack gathered whole (autograd: the gradient is
        reduce-scattered back)."""
        if self.fsdp is None:
            return params
        return tree_map(
            lambda x, path: x if path[:2] == ("text", "layers")
            else self._gather("/".join(map(str, path)), x), params)

    def gather_layer(self, layer: dict, prefix: str = "text/layers") -> dict:
        """One decoder layer's FSDP slices gathered whole (the stacked
        leaf's split dim, less the layers axis)."""
        return tree_map(lambda x, path: self._gather(
            "/".join((prefix,) + tuple(map(str, path))), x, shift=1), layer)

    def reduce_grads(self, grads: dict,
                     placement: Optional[Placement] = None) -> None:
        """Sum flat gradients over "data", "seq" and, for the leaves it
        does not split, "fsdp", in place."""
        placement = placement or self.placement
        everything = list(grads.values())
        for axis in (DATA_AXIS, SEQ_AXIS):
            all_reduce_tensors(everything, self.mesh.group(axis))
        all_reduce_tensors([g for path, g in grads.items()
                            if FSDP_AXIS not in placement.dims(path)],
                           self.fsdp)


def _on(batch: dict, rows: slice, device) -> dict:
    """The rows of a batch (positions: axis 1), on `device`."""
    out = {}
    for key, value in batch.items():
        part = value[:, rows] if key == "positions" else value[rows]
        out[key] = part.to(device) if device is not None else part
    return out


def make_loss_fn(cfg: VLMConfig, remat: bool = False, ce_chunk: int = 512,
                 sp_mesh=None, pp_mesh=None, pp_micro: int = 1,
                 mesh: Optional[Mesh] = None, replicated: bool = False,
                 placement: Optional[Placement] = None):
    """(params, batch) -> (loss, tokens). remat checkpoints each decoder
    layer and each vision block (a checkpoint around the whole forward would
    not lower the peak).

    sp_mesh: a mesh whose "seq" axis is > 1 runs context parallelism;
    pp_mesh: a mesh whose "pipe" axis is > 1 pipelines the decoder with
    pp_micro microbatches (mutually exclusive, as in the JAX package); mesh:
    the mesh of the other axes (it defaults to either). With a mesh the
    batch is the global one and `params` this rank's slices; the loss and
    the token count are the global ones (``replicated``: every rank takes
    every row, the evaluation's batch). The function's ``plan`` attribute
    is its ``ParallelPlan`` (None without a mesh), over `placement` (the
    parameters' placement; ``train_param_axes`` by default)."""
    if pp_mesh is not None and sp_mesh is not None:
        raise ValueError("sp_mesh and pp_mesh are mutually exclusive")
    if pp_mesh is not None and pp_mesh.size(PIPE_AXIS) <= 1:
        pp_mesh = None
    mesh = mesh or sp_mesh or pp_mesh
    plan = ParallelPlan(cfg, mesh, placement) if mesh is not None else None
    attn_impl = None
    if sp_mesh is not None and sp_mesh.size(SEQ_AXIS) > 1:
        from karanta_tpu_torch.parallel.context import \
            make_context_parallel_attention

        attn_impl = make_context_parallel_attention(sp_mesh)

    def loss_fn(params, batch):
        labels = batch["labels"]
        # next-token prediction: hidden[t] predicts labels[t+1]; the last
        # row has no target. Shifted over the whole sequence, before any
        # split over "seq"
        shifted = torch.cat([labels[:, 1:], torch.full_like(
            labels[:, :1], IGNORE_INDEX)], dim=1)
        batch = {**batch, "labels": shifted}
        weight, split, offset, extra = 1.0, (), 0, {}
        if plan is not None:
            rows, weight, split = plan.rows(batch["token_ids"].shape[0],
                                            replicated)
            batch = _on(batch, rows, plan.mesh.device)
            if attn_impl is not None:
                from karanta_tpu_torch.parallel.context import \
                    sequence_sharded_batch

                batch, offset = sequence_sharded_batch(plan.mesh, batch)
                split = split + (SEQ_AXIS,)
            params = plan.gather_top(params)
            extra = dict(group=plan.group, attn_impl=attn_impl,
                         pp_mesh=pp_mesh, pp_micro=pp_micro,
                         seq_offset=offset,
                         gather_layer=(plan.gather_layer if plan.fsdp
                                       is not None else None))
        hidden = forward_train(
            params, cfg, batch["token_ids"], batch["positions"],
            pixel_values=batch.get("pixel_values"),
            vis_perm=batch.get("vis_perm"),
            vis_valid=batch.get("vis_valid"),
            vis_pos_hw=batch.get("vis_pos_hw"),
            vis_extract=batch.get("vis_extract"),
            image_positions=batch.get("image_positions"),
            attn_mask=batch.get("attn_mask"),
            remat=remat, return_hidden=True, **extra)
        loss_sum, count = _ce_sums(params["text"], cfg.text, hidden,
                                   batch["labels"], ce_chunk,
                                   extra.get("group"))
        if plan is None:
            return loss_sum / torch.clamp(count, min=1), count
        count = plan.sum_over(count, split)
        term = loss_sum / torch.clamp(count, min=1)
        if weight != 1.0:
            term = term * weight
        over = [a for a in (DATA_AXIS, FSDP_AXIS, SEQ_AXIS)
                if plan.mesh.size(a) > 1]
        if over:
            # the global loss's value, this rank's term's gradient
            total = plan.sum_over(term.detach().clone(), over)
            term = term + (total - term.detach())
        return term, count

    loss_fn.plan = plan
    return loss_fn


def split_microbatches(batch: dict, grad_accum: int) -> list:
    """A (grad_accum * microbatch)-row batch -> grad_accum microbatches.
    positions is (3, B, S): batch axis 1."""
    out = [dict() for _ in range(grad_accum)]
    for key, value in batch.items():
        axis = 1 if key == "positions" else 0
        for i, part in enumerate(torch.chunk(value, grad_accum, dim=axis)):
            out[i][key] = part
    return out


def value_and_grad(loss_fn, params: Any, *args):
    """(loss, aux, grads) of loss_fn(params, *args) -> (loss, aux) (the
    trainers' aux: the token count, the classifier's logits), grads as a
    flat dict ("/"-joined paths, list indices as keys; zeros for leaves the
    loss does not reach)."""
    live = tree_map(lambda v, _: v.detach().requires_grad_(True), params)
    flat = flatten_tree(live)
    loss, aux = loss_fn(live, *args)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    out = {k: torch.zeros_like(v) if g is None else g
           for (k, v), g in zip(flat.items(), grads)}
    return loss.detach(), aux, out


def accumulate_grads(grad_once, params: Any, batch: dict, grad_accum: int,
                     reduce=None):
    """Average grads over grad_accum microbatches: summed in float32, then
    divided and cast back to each parameter's dtype. `reduce(flat grads)`,
    when given, sums them over the ranks in place before that (once, after
    the last microbatch).

    grad_once(microbatch) -> (loss, tokens, flat grads). Returns (flat
    grads, mean loss, summed tokens)."""
    if grad_accum == 1:
        loss, tokens, grads = grad_once(batch)
        if reduce is not None:
            reduce(grads)
        return grads, loss, tokens
    acc = None
    loss_sum, tokens_sum = 0.0, 0
    for mb in split_microbatches(batch, grad_accum):
        loss, tokens, grads = grad_once(mb)
        if acc is None:
            acc = {k: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device) for k, g in grads.items()}
        for k in list(grads):
            acc[k].add_(grads.pop(k))
        loss_sum = loss_sum + loss
        tokens_sum = tokens_sum + tokens
    if reduce is not None:
        reduce(acc)
    flat_p = flatten_tree(params)
    for k in list(acc):
        acc[k] = (acc.pop(k) / grad_accum).to(flat_p[k].dtype)
    return acc, loss_sum / grad_accum, tokens_sum


def make_train_step(cfg: VLMConfig, optimizer: Optimizer,
                    remat: bool = False, grad_accum: int = 1,
                    sp_mesh=None, pp_mesh=None, pp_micro: int = 1,
                    mesh: Optional[Mesh] = None):
    """Returns (state, batch) -> (state, metrics). With grad_accum > 1 the
    batch's leading dim must be grad_accum * microbatch; the gradients of the
    microbatches are averaged before one optimizer update. The meshes are
    make_loss_fn's: with one, the batch is the global batch and the state
    holds this rank's slices (``ParallelPlan.placement.shard``); the
    metrics are the global ones on every rank.

    Unlike the JAX step, this one mutates: the tensors of the given state's
    parameters and optimizer state are updated in place and returned in the
    new state. A caller that needs the state from before a step clones it
    first."""
    loss_fn = make_loss_fn(cfg, remat=remat, sp_mesh=sp_mesh,
                           pp_mesh=pp_mesh, pp_micro=pp_micro, mesh=mesh)
    plan = loss_fn.plan
    placement = plan.placement if plan is not None else None

    def train_step(state: TrainState, batch: dict):
        grads, loss, tokens = accumulate_grads(
            lambda mb: value_and_grad(loss_fn, state.params, mb),
            state.params, batch, grad_accum,
            reduce=plan.reduce_grads if plan is not None else None)
        grad_norm = global_norm(grads, placement)
        params, opt_state = optimizer.step(grads, state.opt_state,
                                           state.params, placement)
        metrics = {"loss": loss, "tokens": tokens, "grad_norm": grad_norm}
        return TrainState(params, opt_state, state.step + 1), metrics

    train_step.plan = plan
    train_step.loss_fn = loss_fn
    return train_step


def eval_step(cfg: VLMConfig, sp_mesh=None, mesh: Optional[Mesh] = None):
    """(params, batch) -> metrics, every rank over the whole batch."""
    loss_fn = make_loss_fn(cfg, sp_mesh=sp_mesh, mesh=mesh, replicated=True)

    def step(params, batch):
        with torch.no_grad():
            loss, tokens = loss_fn(params, batch)
        return {"loss": loss, "tokens": tokens}

    return step
