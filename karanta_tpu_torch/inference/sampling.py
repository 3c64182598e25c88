"""Token sampling: greedy / temperature / top-p (port of
``karanta_tpu/inference/sampling.py``). Temperature 0 is exact greedy
(argmax over float32 logits, first index on ties)."""

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
