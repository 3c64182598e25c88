"""Qwen2.5-VL composite model glue (port of
``karanta_tpu/models/qwen25_vl/model.py``): parameter assembly, the
multimodal embedding merge and the teacher-forced training forward."""

from __future__ import annotations

from typing import Any, Optional

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


def forward_train(params: Params, cfg: VLMConfig,
                  token_ids: torch.Tensor,        # (B, S)
                  positions: torch.Tensor,        # (3, B, S)
                  pixel_values: Optional[torch.Tensor] = None,  # (B, T_pad, 1176)
                  vis_perm: Optional[torch.Tensor] = None,      # (B, T_pad)
                  vis_valid: Optional[torch.Tensor] = None,     # (B, T_pad)
                  vis_pos_hw: Optional[torch.Tensor] = None,    # (B, T_pad, 2)
                  vis_extract: Optional[torch.Tensor] = None,   # (B, N_pad)
                  image_positions: Optional[torch.Tensor] = None,  # (B, N_pad)
                  attn_mask: Optional[torch.Tensor] = None,     # (B, S)
                  remat: bool = False,
                  return_hidden: bool = False,
                  ) -> torch.Tensor:
    """Teacher-forced forward over full sequences: logits (B, S, V), or the
    post-final-norm hidden states (B, S, H) with return_hidden=True (the
    chunked loss computes each chunk's logits itself).

    Each row's image is encoded with the differentiable window attention,
    its real tokens taken by ``vis_extract`` and scattered into the row's
    embeddings at ``image_positions``; then the causal decoder runs over the
    batch. remat=True checkpoints each vision block and each decoder layer.
    The window count follows from the shapes."""
    embeds = dec.embed_tokens(params["text"], token_ids)
    if pixel_values is not None:
        rows = []
        for i in range(token_ids.shape[0]):
            enc = vis.encode_image(params["visual"], cfg.vision,
                                   pixel_values[i].to(embeds.dtype),
                                   vis_perm[i], vis_valid[i], vis_pos_hw[i],
                                   trainable=True, remat=remat)
            tokens = enc[vis_extract[i].long()]
            rows.append(merge_image_embeddings(embeds[i], tokens,
                                               image_positions[i]))
        embeds = torch.stack(rows)
    hidden, _ = dec.prefill_forward(params["text"], cfg.text, embeds,
                                    positions, kv_mask=attn_mask,
                                    remat=remat)
    if return_hidden:
        return hidden
    return dec.logits_from_hidden(params["text"], cfg.text, hidden)
