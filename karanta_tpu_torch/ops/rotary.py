"""Rotary position embeddings (port of ``karanta_tpu/ops/rotary.py``).

1D RoPE, Qwen-VL 2D vision RoPE and M-RoPE with the HF Qwen2.5-VL semantics:
rotate-half convention, float32 rotation, mrope_section banding.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _inv_freq(half: int, denom: int, theta: float,
              device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) * 2.0 / denom))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 1e6):
    """Standard RoPE tables. positions (...,) -> cos/sin (..., head_dim)."""
    inv = _inv_freq(head_dim // 2, head_dim, theta, positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def mrope_cos_sin(positions_thw: torch.Tensor, head_dim: int,
                  mrope_section: Sequence[int], theta: float = 1e6):
    """M-RoPE tables: positions (3, seq) -> cos, sin (seq, head_dim) float32.

    The first mrope_section[0] frequency pairs rotate by the temporal
    position, the next by height, the last by width."""
    half = head_dim // 2
    if sum(mrope_section) != half:
        raise ValueError(f"mrope_section {tuple(mrope_section)} must sum to "
                         f"head_dim // 2 = {half}")
    inv = _inv_freq(half, head_dim, theta, positions_thw.device)
    freqs = positions_thw.float()[:, :, None] * inv[None, None, :]  # (3,S,half)
    band = torch.cat([torch.full((w,), i, dtype=torch.long)
                      for i, w in enumerate(mrope_section)]).to(freqs.device)
    sel = freqs[band, :, torch.arange(half, device=freqs.device)]  # (half,S)
    sel = sel.transpose(0, 1)
    emb = torch.cat([sel, sel], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def vision_rope_cos_sin(positions_hw: torch.Tensor, head_dim: int,
                        theta: float = 1e4):
    """Qwen-VL vision 2D RoPE: (seq, 2) (h, w) -> cos, sin (seq, head_dim)."""
    quarter = head_dim // 4
    inv = _inv_freq(quarter, head_dim // 2, theta, positions_hw.device)
    freqs = positions_hw.float()[:, :, None] * inv[None, None, :]
    freqs = freqs.reshape(freqs.shape[0], -1)  # [h bands | w bands]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor):
    """Rotate q, k (..., seq, heads, head_dim) by cos/sin broadcastable to
    (..., seq, 1, head_dim), in float32; results in the inputs' dtypes."""
    cos = cos.float()[..., :, None, :]
    sin = sin.float()[..., :, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
