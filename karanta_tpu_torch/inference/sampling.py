"""Token sampling: greedy / temperature / top-p, and the speculative
verifier (port of ``karanta_tpu/inference/sampling.py``). Temperature 0 is
exact greedy (argmax over float32 logits, first index on ties). Random draws
come from an explicit ``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch


def sample_tokens(logits: torch.Tensor,                 # (B, V)
                  generator: Optional[torch.Generator],
                  temperature: Optional[torch.Tensor],  # (B,) 0 = greedy
                  top_p: Optional[torch.Tensor] = None,  # (B,) 1 = off
                  ) -> torch.Tensor:
    """One token per row. temperature=None means a statically greedy batch;
    pass top_p=None when every row has top_p >= 1 (the nucleus sort costs a
    full-vocabulary sort per step)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if temperature is None:
        return greedy
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits / temp
    if top_p is not None:
        scaled = _apply_top_p(scaled, top_p)
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


def spec_verify_sampled(logits: torch.Tensor,   # (B, T, V), T = gamma + 1
                        draft: torch.Tensor,    # (B, gamma) drafted tokens
                        temps: torch.Tensor,    # (B,) float32; <= 0 greedy
                        generator: Optional[torch.Generator],
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection-sampling verification of a deterministic draft.

    Position i of `logits` scores the token that follows verify-pass input i
    (inputs = [last_token, draft...]). Returns (y (B, T), n_new (B,)): row b
    emits y[b, :n_new[b]], its accepted draft prefix plus exactly one fresh
    token; entries past n_new[b] are unspecified.

    Speculative sampling with the deterministic drafter q = delta(d): accept
    d with probability p(d); on rejection emit a sample from p without d
    (renormalized); on full acceptance a bonus sample from the last
    position. Rows with temp <= 0 reduce to the greedy rule: accept iff
    d == argmax, emit argmax, exactly what per-step greedy decoding emits."""
    b, t, v = logits.shape
    gamma = t - 1
    draft = draft.long()
    f32 = logits.float()
    greedy = torch.argmax(f32, dim=-1)                        # (B, T)
    scaled = f32 / torch.clamp(temps.float(), min=1e-6)[:, None, None]
    is_greedy = (temps <= 0.0)[:, None]                       # (B, 1)

    # accept d_i with probability p_i(d_i): log u < log p_i(d_i)
    logz = torch.logsumexp(scaled[:, :gamma], dim=-1)         # (B, gamma)
    d_logit = torch.gather(scaled[:, :gamma], -1, draft[..., None])[..., 0]
    u = torch.rand((b, gamma), generator=generator, device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    accept = torch.where(is_greedy, greedy[:, :gamma] == draft,
                         torch.log(u) < d_logit - logz)
    ok = torch.cumprod(accept.long(), dim=1)
    n_new = 1 + ok.sum(dim=1)                                 # (B,) 1..T

    # the one fresh token: at a rejected position i a sample from p_i with
    # d_i removed; at the bonus position gamma a sample from p unmasked
    d_mask = torch.zeros((b, t, v), dtype=torch.bool, device=logits.device)
    d_mask[:, :gamma].scatter_(-1, draft[..., None], True)
    probs = torch.softmax(scaled.masked_fill(d_mask, float("-inf")), dim=-1)
    emit_sampled = torch.multinomial(probs.reshape(b * t, v), 1,
                                     generator=generator).reshape(b, t)
    emit = torch.where(is_greedy, greedy, emit_sampled)

    idx = torch.arange(t, device=logits.device)[None, :]
    draft_pad = torch.cat([draft, draft.new_zeros((b, 1))], dim=1)
    y = torch.where(idx < (n_new - 1)[:, None], draft_pad, emit)
    return y, n_new


def _apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering: mask tokens outside the smallest top-p mass set."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while the exclusive cumulative mass < top_p
    keep_sorted = (cum - probs) < top_p[:, None].float()
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full_like(sorted_logits, float("inf")))
    threshold = threshold.amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits,
                       torch.full_like(logits, float("-inf")))
