"""Qwen2.5-VL vision encoder (port of ``karanta_tpu/models/qwen25_vl/vision.py``).

The sequence is window-ordered by the host layout planner (layout.py):
window layers are block-diagonal attention over 64-token windows with a
validity mask (the window kernel, rope fused in), full-attention layers
(``fullatt_block_indexes``) run flash attention over the whole padded image
with the same mask. The patch-embed Conv3D is one matmul (non-overlapping,
stride == kernel). Parameters are stacked per layer, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from karanta_tpu_torch.models.qwen25_vl.config import VisionConfig
from karanta_tpu_torch.models.qwen25_vl.layout import VisionLayout
from karanta_tpu_torch.ops.attention import (attention,
                                             window_attention_kernel_call)
from karanta_tpu_torch.ops.norms import rms_norm
from karanta_tpu_torch.ops.quantization import matmul_auto as amm
from karanta_tpu_torch.ops.rotary import apply_rope, vision_rope_cos_sin
from karanta_tpu_torch.utils.tree import layer_slice

Params = Any


def init_vision_params(cfg: VisionConfig, generator: Optional[torch.Generator],
                       dtype=torch.bfloat16, device=None) -> Params:
    """Random init with the JAX package's shapes (stacked on a depth axis).
    With device="meta" (and no generator) it only describes the shapes."""
    h, d, inter = cfg.hidden_size, cfg.depth, cfg.intermediate_size
    merged = h * cfg.merge_unit
    device = generator.device if device is None else device

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w / np.sqrt(fan_in)).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    if cfg.mlp_type == "gated":
        mlp = {"gate": dense((d, h, inter), h), "gate_b": zeros((d, inter)),
               "up": dense((d, h, inter), h), "up_b": zeros((d, inter)),
               "down": dense((d, inter, h), inter), "down_b": zeros((d, h))}
    else:
        mlp = {"fc1": dense((d, h, inter), h), "fc1_b": zeros((d, inter)),
               "fc2": dense((d, inter, h), inter), "fc2_b": zeros((d, h))}
    params = {
        "patch_embed": {"kernel": dense((cfg.patch_input_dim, h),
                                        cfg.patch_input_dim)},
        "blocks": {
            "norm1": ones((d, h)),
            "norm2": ones((d, h)),
            "attn": {"wq": dense((d, h, h), h), "bq": zeros((d, h)),
                     "wk": dense((d, h, h), h), "bk": zeros((d, h)),
                     "wv": dense((d, h, h), h), "bv": zeros((d, h)),
                     "wo": dense((d, h, h), h), "bo": zeros((d, h))},
            "mlp": mlp,
        },
        "merger": {
            "ln_q": ones((h,)),
            "w1": dense((merged, merged), merged),
            "b1": zeros((merged,)),
            "w2": dense((merged, cfg.out_hidden_size), merged),
            "b2": zeros((cfg.out_hidden_size,)),
        },
    }
    if cfg.norm_type == "layernorm":
        params["blocks"]["norm1_b"] = zeros((d, h))
        params["blocks"]["norm2_b"] = zeros((d, h))
        params["merger"]["ln_q_b"] = zeros((h,))
    return params


def _vnorm(cfg: VisionConfig, x, scale, bias=None):
    if cfg.norm_type == "layernorm":
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + cfg.rms_norm_eps)
        out = out * scale.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(x.dtype)
    return rms_norm(x, scale, cfg.rms_norm_eps)


def _activation(cfg: VisionConfig, x):
    if cfg.hidden_act == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if cfg.hidden_act == "gelu":
        return F.gelu(x, approximate="none")
    return F.silu(x)


def _attn_block(x, p, cos, sin, valid, cfg: VisionConfig, full: bool):
    """x: (pad_tokens, hidden) window-ordered -> attention output."""
    tokens = x.shape[0]
    nh, hd = cfg.num_heads, cfg.head_dim
    q = (amm(x, p["wq"]) + p["bq"]).reshape(1, tokens, nh, hd)
    k = (amm(x, p["wk"]) + p["bk"]).reshape(1, tokens, nh, hd)
    v = (amm(x, p["wv"]) + p["bv"]).reshape(1, tokens, nh, hd)
    cs = cos.reshape(1, tokens, hd)
    sn = sin.reshape(1, tokens, hd)
    mask = valid.reshape(1, tokens)
    if full:
        q, k = apply_rope(q, k, cs, sn)
        out = attention(q, k, v, kv_mask=mask, causal=False)
    else:
        # rope fused into the window kernel (cos/sin in float32, holding the
        # activation-dtype values the JAX encoder hands its kernel)
        out = window_attention_kernel_call(
            q, k, v, cfg.window_patches ** 2, kv_mask=mask,
            cos=cs.float().contiguous(), sin=sn.float().contiguous())
    out = out.reshape(tokens, nh * hd)
    return amm(out, p["wo"]) + p["bo"]


def _mlp(cfg: VisionConfig, x, p):
    if cfg.mlp_type == "plain":
        return amm(_activation(cfg, amm(x, p["fc1"]) + p["fc1_b"]),
                   p["fc2"]) + p["fc2_b"]
    gate = _activation(cfg, amm(x, p["gate"]) + p["gate_b"])
    up = amm(x, p["up"]) + p["up_b"]
    return amm(gate * up, p["down"]) + p["down_b"]


def encode_image(params: Params, cfg: VisionConfig,
                 pixel_values: torch.Tensor,  # (pad_tokens, patch_input_dim)
                 perm: torch.Tensor,          # (pad_tokens,) int
                 valid: torch.Tensor,         # (pad_tokens,) float32
                 pos_hw: torch.Tensor,        # (pad_tokens, 2) int
                 ) -> torch.Tensor:
    """Encode one padded image. Returns (pad_merged, out_hidden) in
    window-merged order; callers select real tokens with layout.extract.
    (The JAX function's static ``n_windows`` follows from the token count.)"""
    x = amm(pixel_values, params["patch_embed"]["kernel"])
    x = x[perm.long()]  # patchify order -> window order
    valid = valid.float()
    cos, sin = vision_rope_cos_sin(pos_hw, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)

    blocks = params["blocks"]
    full_idx = cfg.fullatt_block_indexes
    for i in range(cfg.depth):
        full = full_idx is None or i in full_idx
        lp = layer_slice(blocks, i)
        x = x + _attn_block(_vnorm(cfg, x, lp["norm1"], lp.get("norm1_b")),
                            lp["attn"], cos, sin, valid, cfg, full)
        x = x + _mlp(cfg, _vnorm(cfg, x, lp["norm2"], lp.get("norm2_b")),
                     lp["mlp"])

    # merger: norm per token, merge 2x2 units, 2-layer GELU MLP
    m = params["merger"]
    x = _vnorm(cfg, x, m["ln_q"], m.get("ln_q_b"))
    x = x.reshape(-1, cfg.merge_unit * cfg.hidden_size)
    x = F.gelu(amm(x, m["w1"]) + m["b1"], approximate="none")
    return amm(x, m["w2"]) + m["b2"]


def extract_image_tokens(encoded: torch.Tensor,
                         layout: VisionLayout) -> torch.Tensor:
    """(pad_merged, out) window order -> (num_merged, out) original order."""
    idx = torch.as_tensor(layout.extract, dtype=torch.long,
                          device=encoded.device)
    return encoded[idx]
