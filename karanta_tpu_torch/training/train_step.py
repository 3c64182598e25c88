"""The training step: loss, gradients and the optimizer update (port of
``karanta_tpu/training/train_step.py``).

Instruction-masked next-token cross entropy (labels == -100 ignored) over
chunks of 512 rows, so the (B, S, vocab) logits never exist at once;
gradient accumulation over microbatches in a float32 accumulator; optional
rematerialization per decoder layer and per vision block. The step is
eager: ``make_train_step`` returns a function (state, batch) -> (state,
metrics) that updates the state's tensors in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig
from karanta_tpu_torch.models.qwen25_vl.decoder import logits_from_hidden
from karanta_tpu_torch.models.qwen25_vl.model import forward_train
from karanta_tpu_torch.training.optimizer import Optimizer, global_norm
from karanta_tpu_torch.utils.tree import flatten_tree, tree_map

IGNORE_INDEX = -100
_MESH_ERROR = ("sequence and pipeline parallel meshes are not ported "
               "(ROADMAP.md, queue 1, item 8: parallelism)")


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


def chunked_cross_entropy(text_params, text_cfg,
                          hidden: torch.Tensor,   # (B, S, H) post-final-norm
                          labels: torch.Tensor,   # (B, S) aligned to hidden
                          chunk: int = 512,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored positions, one chunk of rows at a time: each
    chunk's logits and float32 log-softmax are checkpointed, so the backward
    recomputes them and the full (B, S, vocab) logits never exist."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)

    def chunk_sums(h_c, l_c):
        logits = logits_from_hidden(text_params, text_cfg, h_c)
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
    return loss_sum / torch.clamp(count, min=1), count


def make_loss_fn(cfg: VLMConfig, remat: bool = False, ce_chunk: int = 512,
                 sp_mesh=None, pp_mesh=None):
    """(params, batch) -> (loss, tokens). remat checkpoints each decoder
    layer and each vision block (a checkpoint around the whole forward would
    not lower the peak)."""
    if sp_mesh is not None or pp_mesh is not None:
        raise NotImplementedError(_MESH_ERROR)

    def loss_fn(params, batch):
        hidden = forward_train(
            params, cfg, batch["token_ids"], batch["positions"],
            pixel_values=batch.get("pixel_values"),
            vis_perm=batch.get("vis_perm"),
            vis_valid=batch.get("vis_valid"),
            vis_pos_hw=batch.get("vis_pos_hw"),
            vis_extract=batch.get("vis_extract"),
            image_positions=batch.get("image_positions"),
            attn_mask=batch.get("attn_mask"),
            remat=remat, return_hidden=True)
        # next-token prediction: hidden[t] predicts labels[t+1]; the last
        # row has no target
        labels = batch["labels"]
        shifted = torch.cat([labels[:, 1:], torch.full_like(
            labels[:, :1], IGNORE_INDEX)], dim=1)
        return chunked_cross_entropy(params["text"], cfg.text, hidden,
                                     shifted, chunk=ce_chunk)

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


def accumulate_grads(grad_once, params: Any, batch: dict, grad_accum: int):
    """Average grads over grad_accum microbatches: summed in float32, then
    divided and cast back to each parameter's dtype.

    grad_once(microbatch) -> (loss, tokens, flat grads). Returns (flat
    grads, mean loss, summed tokens)."""
    if grad_accum == 1:
        loss, tokens, grads = grad_once(batch)
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
    flat_p = flatten_tree(params)
    for k in list(acc):
        acc[k] = (acc.pop(k) / grad_accum).to(flat_p[k].dtype)
    return acc, loss_sum / grad_accum, tokens_sum


def make_train_step(cfg: VLMConfig, optimizer: Optimizer,
                    remat: bool = False, grad_accum: int = 1,
                    sp_mesh=None, pp_mesh=None):
    """Returns (state, batch) -> (state, metrics). With grad_accum > 1 the
    batch's leading dim must be grad_accum * microbatch; the gradients of the
    microbatches are averaged before one optimizer update.

    Unlike the JAX step, this one mutates: the tensors of the given state's
    parameters and optimizer state are updated in place and returned in the
    new state. A caller that needs the state from before a step clones it
    first."""
    loss_fn = make_loss_fn(cfg, remat=remat, sp_mesh=sp_mesh,
                           pp_mesh=pp_mesh)

    def train_step(state: TrainState, batch: dict):
        grads, loss, tokens = accumulate_grads(
            lambda mb: value_and_grad(loss_fn, state.params, mb),
            state.params, batch, grad_accum)
        grad_norm = global_norm(grads)
        params, opt_state = optimizer.step(grads, state.opt_state,
                                           state.params)
        metrics = {"loss": loss, "tokens": tokens, "grad_norm": grad_norm}
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def eval_step(cfg: VLMConfig):
    loss_fn = make_loss_fn(cfg)

    def step(params, batch):
        with torch.no_grad():
            loss, tokens = loss_fn(params, batch)
        return {"loss": loss, "tokens": tokens}

    return step
