"""Optimizers: AdamW with no-decay groups, and Muon with an Adam auxiliary
(port of ``karanta_tpu/training/optimizer.py``).

The JAX package builds these from optax transforms; here the same chain is
written out leaf by leaf with optax's arithmetic, not ``torch.optim``'s:

- ``skip_nonfinite``: a step whose gradients hold a NaN or an inf changes
  nothing but its counter, until 10 such steps in a row (then it applies);
- ``clip_by_global_norm`` over the raw gradients (the norm is summed in the
  gradients' dtype, as optax does);
- ``scale_by_adam``: moments in the parameter dtype, bias correction by
  division, eps outside the square root;
- ``add_decayed_weights`` on leaves of two or more dimensions (on every
  leaf with ``decay_all_leaves``, as ``optax.adamw`` with no mask does);
- ``scale_by_learning_rate``: the negated schedule at the count before this
  step (the first step sees the schedule at 0).

Every scalar enters an operation in the dtype of the tensor it meets (JAX's
weak scalars), so bfloat16 parameters round where optax's do. Muon
orthogonalizes the momentum of the "muon" leaves (``default_label_fn``:
every leaf of two or more dimensions that is not an embedding or a head,
the stacked (L, n) norms and biases included, as in the JAX package); the
others take Adam with scaled learning rates.

State: ``{"count", "notfinite_count", "mu", "nu", "momentum"}``, the last
three flat dicts keyed by "/"-joined parameter paths. ``update`` returns
optax-style updates and a new state; ``step`` applies them leaf by leaf in
place (parameters and state), so the card never holds a second copy of the
parameters or of the moments.

Sharded parameters (``placement``: a ``parallel.sharding.Placement``, the
leaves and their gradients this rank's slices): Adam's transforms are
element-wise and run on the slices; the gradient norm of the clip is the
global one (each leaf's sum of squares summed over the ranks that split it),
a non-finite gradient on any rank skips the step on every rank, and Muon
orthogonalizes each "muon" leaf's update whole (gathered over the axes that
split it) and keeps this rank's slice of the result.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from karanta_tpu_torch.ops.newton_schulz import orthogonalize
from karanta_tpu_torch.utils.tree import flatten_tree, unflatten_tree

Schedule = Callable[[int], Any]
LearningRate = Union[float, Schedule]


# ---------------------------------------------------------------------------
# schedules (optax's, in float32)
# ---------------------------------------------------------------------------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    def schedule(count):
        c = np.clip(int(count), 0, transition_steps)
        frac = np.float32(1) - np.float32(c) / np.float32(transition_steps)
        return (np.float32(init_value - end_value) * frac
                + np.float32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        c = np.minimum(np.float32(int(count)), np.float32(decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        return np.float32(init_value) * cosine
    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def join_schedules(schedules: list, boundaries: list) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if not int(step) < boundary:
                out = sched(int(step) - boundary)
        return np.float32(out)
    return schedule


def make_lr_schedule(kind: str, base_lr: float, warmup_steps: int,
                     total_steps: int) -> Schedule:
    """cosine / linear / constant with linear warmup."""
    warmup = linear_schedule(0.0, base_lr, max(warmup_steps, 1))
    decay_steps = max(total_steps - warmup_steps, 1)
    if kind == "cosine":
        decay = cosine_decay_schedule(base_lr, decay_steps)
    elif kind == "linear":
        decay = linear_schedule(base_lr, 0.0, decay_steps)
    elif kind == "constant":
        decay = constant_schedule(base_lr)
    else:
        raise ValueError(f"Unknown schedule {kind!r}")
    return join_schedules([warmup, decay], [warmup_steps])


# ---------------------------------------------------------------------------
# labels and per-leaf transforms
# ---------------------------------------------------------------------------

def default_label_fn(path: str, param: torch.Tensor) -> str:
    """'muon' (hidden matrices) / 'embed' / 'head' / 'scalar'."""
    if "embed" in path:
        return "embed"
    if "lm_head" in path or "head" in path:
        return "head"
    if param.dim() < 2:
        return "scalar"
    return "muon"


def _s(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar in the dtype of the tensor it meets."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)


def _lr(learning_rate: LearningRate, count: int, scale: float = 1.0):
    """The learning rate at `count`: a schedule's value times the scale in
    float32, a constant's in Python floats (as the JAX chain computes it)."""
    if callable(learning_rate):
        value = learning_rate(count)
        return value if scale == 1.0 else np.float32(value) * np.float32(scale)
    return learning_rate * scale


def _spread(placement) -> bool:
    """Whether a placement splits leaves over more than one rank."""
    return placement is not None and any(
        placement.mesh.size(a) > 1 for a in ("fsdp", "model"))


def global_norm(tree: Any, placement=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the summed squares, each leaf's sum in the
    leaf's dtype. With a placement that splits leaves, the norm of the whole
    tree of which `tree` holds this rank's slices (summed in float32)."""
    if _spread(placement):
        return torch.sqrt(placement.sum_squares(flatten_tree(tree)))
    total = 0
    for g in flatten_tree(tree).values():
        total = total + (g * g).sum()
    return torch.sqrt(torch.as_tensor(total))


def _adam(g, mu, nu, count_inc: int, b1: float, b2: float, eps: float):
    mu = _s(1 - b1, g) * g + _s(b1, mu) * mu
    nu = _s(1 - b2, g) * (g * g) + _s(b2, nu) * nu
    bc1 = np.float32(1) - np.float32(b1) ** np.float32(count_inc)
    bc2 = np.float32(1) - np.float32(b2) ** np.float32(count_inc)
    mu_hat = mu / _s(bc1, mu)
    nu_hat = nu / _s(bc2, nu)
    u = mu_hat / (torch.sqrt(nu_hat + _s(0.0, nu_hat)) + _s(eps, nu_hat))
    return u, mu, nu


def _muon(g, m, beta: float, ns_steps: int = 5, whole=None, own=None):
    """Muon's update of one leaf; `whole`/`own` gather a slice's update
    whole and cut this rank's slice back out (sharded leaves)."""
    m = _s(beta, m) * m + _s(1 - beta, g) * g
    u = _s(1 - beta, g) * g + _s(beta, m) * m
    if g.dim() >= 2:
        if whole is not None:
            u = whole(u)
        u = orthogonalize(u, steps=ns_steps)
        u = u * _s(math.sqrt(max(1.0, u.shape[-2] / u.shape[-1])), u)
        if own is not None:
            u = own(u).contiguous()
    return u, m


@dataclasses.dataclass
class Optimizer:
    """AdamW (``kind="adamw"``) or Muon with auxiliary Adam
    (``kind="muon"``), wrapped in clip_by_global_norm and skip_nonfinite as
    ``make_optimizer`` chains them."""

    kind: str
    learning_rate: LearningRate
    weight_decay: float = 0.0
    b1: float = 0.9                 # adamw
    b2: float = 0.999
    eps: float = 1e-8
    muon_beta: float = 0.95         # muon
    adam_b1: float = 0.8
    adam_b2: float = 0.95
    embed_lr_scale: float = 12.0
    head_lr_scale: float = 0.8
    label_fn: Callable = default_label_fn
    max_grad_norm: Optional[float] = None
    skip_nonfinite: bool = False
    max_consecutive_errors: int = 10
    decay_all_leaves: bool = False

    def _label(self, path: str, p: torch.Tensor) -> str:
        return "adam" if self.kind == "adamw" else self.label_fn(path, p)

    def init(self, params: Any) -> dict:
        state = {"count": torch.zeros((), dtype=torch.int32),
                 "notfinite_count": torch.zeros((), dtype=torch.int32),
                 "mu": {}, "nu": {}, "momentum": {}}
        for path, p in flatten_tree(params).items():
            if self._label(path, p) == "muon":
                state["momentum"][path] = torch.zeros_like(p)
            else:
                state["mu"][path] = torch.zeros_like(p)
                state["nu"][path] = torch.zeros_like(p)
        return state

    def _leaf(self, path, g, p, state, count: int, placement=None):
        """One leaf through the chain (after clipping): (update, and the
        leaf's new state written into `state`)."""
        label = self._label(path, p)
        if label == "muon":
            whole = own = None
            if placement is not None and placement.dims(path):
                whole = functools.partial(placement.whole, path)
                own = functools.partial(placement.own, path)
            u, state["momentum"][path] = _muon(g, state["momentum"][path],
                                               self.muon_beta, whole=whole,
                                               own=own)
            lr_scale = 1.0
        else:
            b1, b2, eps = ((self.b1, self.b2, self.eps) if label == "adam"
                           else (self.adam_b1, self.adam_b2, 1e-8))
            u, state["mu"][path], state["nu"][path] = _adam(
                g, state["mu"][path], state["nu"][path], count + 1, b1, b2,
                eps)
            lr_scale = {"adam": 1.0, "embed": self.embed_lr_scale}.get(
                label, self.head_lr_scale)
        if p.dim() >= 2 or self.decay_all_leaves:
            u = u + _s(self.weight_decay, p) * p
        return u * _s(-1 * _lr(self.learning_rate, count, lr_scale), u)

    def _updates(self, grads: dict, state: dict, params: dict,
                 placement=None):
        """Yield (path, update) leaf by leaf, replacing each state leaf in
        `state` as its update is made; pops each gradient from `grads`
        once used."""
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        if _spread(placement):
            device = next(iter(grads.values())).device
            finite = not placement.any_true(not finite, device)
        nf = int(state["notfinite_count"])
        use = finite or (self.skip_nonfinite
                         and nf >= self.max_consecutive_errors)
        if self.skip_nonfinite:
            state["notfinite_count"] = torch.tensor(0 if finite else nf + 1,
                                                    dtype=torch.int32)
        if self.skip_nonfinite and not use:
            for path in list(grads):
                yield path, torch.zeros_like(grads.pop(path))
            return
        clip = None
        if self.max_grad_norm:
            norm = global_norm(grads, placement)
            if not bool(norm < self.max_grad_norm):
                clip = norm
        count = int(state["count"])
        for path in list(grads):
            g = grads.pop(path)
            if clip is not None:
                g = (g / clip.to(g.dtype)) * _s(self.max_grad_norm, g)
            yield path, self._leaf(path, g, params[path], state, count,
                                   placement)
        state["count"] = torch.tensor(count + 1, dtype=torch.int32)

    def update(self, grads: Any, state: dict, params: Any, placement=None
               ) -> tuple[Any, dict]:
        """optax's ``update``: (updates tree, new state); `state` is left as
        it was. The trainer uses ``step``; this functional form (with
        ``apply_updates``) is kept so that each update can be held against
        optax's one by one."""
        new = {**state, "mu": dict(state["mu"]), "nu": dict(state["nu"]),
               "momentum": dict(state["momentum"])}
        updates = dict(self._updates(flatten_tree(grads), new,
                                     flatten_tree(params), placement))
        return unflatten_tree(updates), new

    def step(self, grads: dict, state: dict, params: Any, placement=None
             ) -> tuple[Any, dict]:
        """update + apply_updates, leaf by leaf and in place: each parameter
        gets ``p += u`` (optax's ``p + u`` in the parameter's dtype, one
        rounding) and each state leaf is replaced as its update is made.
        `grads` is a flat dict ("/"-joined paths), emptied as it goes.
        Returns (params, state), the objects passed in."""
        flat_p = flatten_tree(params)
        for path, u in self._updates(grads, state, flat_p, placement):
            flat_p[path].add_(u)
        return params, state


def apply_updates(params: Any, updates: Any) -> Any:
    """optax.apply_updates: (p + u) in the parameter's dtype (``update``'s
    companion; the trainer's ``Optimizer.step`` adds in place instead)."""
    flat_u = flatten_tree(updates)
    return unflatten_tree({path: (p + flat_u[path]).to(p.dtype)
                           for path, p in flatten_tree(params).items()})


def make_adamw(learning_rate: LearningRate, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               decay_all_leaves: bool = False) -> Optimizer:
    """The JAX package's ``make_adamw`` (decay on matrices only), or with
    ``decay_all_leaves`` ``optax.adamw`` itself, whose default mask decays
    every leaf (the classifier trainer's optimizer)."""
    return Optimizer("adamw", learning_rate, weight_decay, b1=b1, b2=b2,
                     eps=eps, decay_all_leaves=decay_all_leaves)


def make_muon_with_aux_adam(learning_rate: LearningRate,
                            weight_decay: float = 0.0,
                            muon_beta: float = 0.95, adam_b1: float = 0.8,
                            adam_b2: float = 0.95,
                            embed_lr_scale: float = 12.0,
                            head_lr_scale: float = 0.8,
                            label_fn: Callable = default_label_fn
                            ) -> Optimizer:
    """Muon on hidden matrices, Adam on embed/head/scalars with scaled lrs."""
    return Optimizer("muon", learning_rate, weight_decay,
                     muon_beta=muon_beta, adam_b1=adam_b1, adam_b2=adam_b2,
                     embed_lr_scale=embed_lr_scale,
                     head_lr_scale=head_lr_scale, label_fn=label_fn)


def make_optimizer(name: str, learning_rate: LearningRate,
                   weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = 1.0,
                   skip_nonfinite: bool = True, **kwargs) -> Optimizer:
    if name == "adamw":
        opt = make_adamw(learning_rate, weight_decay, **kwargs)
    elif name == "muon":
        opt = make_muon_with_aux_adam(learning_rate, weight_decay, **kwargs)
    else:
        raise ValueError(f"Unknown optimizer {name!r}")
    return dataclasses.replace(opt, max_grad_norm=max_grad_norm,
                               skip_nonfinite=skip_nonfinite)
