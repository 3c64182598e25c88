"""Qwen2.5-VL composite model glue (port of
``karanta_tpu/models/qwen25_vl/model.py``): parameter assembly and the
multimodal embedding merge."""

from __future__ import annotations

from typing import Any

import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.models.qwen25_vl import vision as vis
from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig

Params = Any


def init_params(cfg: VLMConfig, seed: int = 0, dtype=torch.bfloat16,
                device: DeviceLike = None) -> Params:
    """Random parameters from a seeded ``torch.Generator`` on the device
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    gen_v = torch.Generator(device=device).manual_seed(2 * seed)
    gen_t = torch.Generator(device=device).manual_seed(2 * seed + 1)
    return {"visual": vis.init_vision_params(cfg.vision, gen_v, dtype, device),
            "text": dec.init_decoder_params(cfg.text, gen_t, dtype, device)}


def merge_image_embeddings(token_embeds: torch.Tensor,   # (S, hidden)
                           image_tokens: torch.Tensor,   # (N_pad, hidden)
                           positions: torch.Tensor,      # (N_pad,) int
                           ) -> torch.Tensor:
    """Scatter vision tokens into the text embedding at image-token
    positions; entries with positions >= S are dropped (padding)."""
    keep = positions < token_embeds.shape[0]
    out = token_embeds.clone()
    out[positions[keep].long()] = image_tokens[keep].to(out.dtype)
    return out
