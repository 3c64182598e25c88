"""Qwen2.5-VL vision encoder (port of ``karanta_tpu/models/qwen25_vl/vision.py``).

The sequence is window-ordered by the host layout planner (layout.py):
window layers are block-diagonal attention over 64-token windows with a
validity mask (the window kernel, rope fused in), full-attention layers
(``fullatt_block_indexes``) run flash attention over the whole padded image
with the same mask. The patch-embed Conv3D is one matmul (non-overlapping,
stride == kernel). Parameters are stacked per layer, as in the JAX package.

Training (``trainable=True``) applies rope outside the window kernel and
calls the differentiable ``window_attention`` (the kernel's no-rope
instance), as the JAX encoder does; ``remat=True`` checkpoints each block.

Tensor parallelism (``group`` = the "model" process group): the blocks hold
this rank's heads and MLP columns (``vision_param_axes``). Their output
products (``wo``, the MLP's ``down``/``fc2``) are row-parallel when the
tower is int8 (W8A8: an exact sum, ``ops/quantization.py``). With bf16
weights every rank keeps them whole and multiplies the activations
gathered whole, so each product is one rank's to the bit: a row-parallel
bf16 sum, rounded once after another summation order, changes about 0.15%
of the roundings of each product, and the 32 random-weight blocks amplify
that to 1.5e-2 normwise in the tower's tokens (measured on an H100). The
patch embedding and the merger stay whole on every rank
(``model.serving_param_axes``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from karanta_tpu_torch.models.qwen25_vl.config import VisionConfig
from karanta_tpu_torch.models.qwen25_vl.layout import VisionLayout
from karanta_tpu_torch.ops.attention import (attention, window_attention,
                                             window_attention_kernel_call)
from karanta_tpu_torch.ops.norms import rms_norm
from karanta_tpu_torch.ops.quantization import is_quantized
from karanta_tpu_torch.ops.quantization import matmul_auto as amm
from karanta_tpu_torch.ops.rotary import apply_rope, vision_rope_cos_sin
from karanta_tpu_torch.parallel.sharding import (copy_to_group,
                                                 gather_from_group)
from karanta_tpu_torch.utils.tree import unbind_layers

Params = Any


def init_vision_params(cfg: VisionConfig, generator: Optional[torch.Generator],
                       dtype=torch.bfloat16, device=None,
                       leaf_fn=None) -> Params:
    """Random init with the JAX package's shapes (stacked on a depth axis).
    With device="meta" (and no generator) it only describes the shapes.
    `leaf_fn(path, tensor)` takes each leaf as it is drawn (see
    ``decoder.init_decoder_params``)."""
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

    def leaf(path, x):
        return leaf_fn(path, x) if leaf_fn is not None else x

    b, m, g = ("blocks",), ("blocks", "mlp"), ("merger",)
    if cfg.mlp_type == "gated":
        mlp = {"gate": leaf(m + ("gate",), dense((d, h, inter), h)),
               "gate_b": leaf(m + ("gate_b",), zeros((d, inter))),
               "up": leaf(m + ("up",), dense((d, h, inter), h)),
               "up_b": leaf(m + ("up_b",), zeros((d, inter))),
               "down": leaf(m + ("down",), dense((d, inter, h), inter)),
               "down_b": leaf(m + ("down_b",), zeros((d, h)))}
    else:
        mlp = {"fc1": leaf(m + ("fc1",), dense((d, h, inter), h)),
               "fc1_b": leaf(m + ("fc1_b",), zeros((d, inter))),
               "fc2": leaf(m + ("fc2",), dense((d, inter, h), inter)),
               "fc2_b": leaf(m + ("fc2_b",), zeros((d, h)))}
    # the draws keep the JAX-shaped tree's order: MLP, patch embedding,
    # attention, merger
    patch = leaf(("patch_embed", "kernel"),
                 dense((cfg.patch_input_dim, h), cfg.patch_input_dim))
    attn = {}
    for name in ("q", "k", "v", "o"):
        attn["w" + name] = leaf(b + ("attn", "w" + name), dense((d, h, h), h))
        attn["b" + name] = leaf(b + ("attn", "b" + name), zeros((d, h)))
    params = {
        "patch_embed": {"kernel": patch},
        "blocks": {
            "norm1": leaf(b + ("norm1",), ones((d, h))),
            "norm2": leaf(b + ("norm2",), ones((d, h))),
            "attn": attn,
            "mlp": mlp,
        },
        "merger": {
            "ln_q": leaf(g + ("ln_q",), ones((h,))),
            "w1": leaf(g + ("w1",), dense((merged, merged), merged)),
            "b1": leaf(g + ("b1",), zeros((merged,))),
            "w2": leaf(g + ("w2",), dense((merged, cfg.out_hidden_size),
                                          merged)),
            "b2": leaf(g + ("b2",), zeros((cfg.out_hidden_size,))),
        },
    }
    if cfg.norm_type == "layernorm":
        params["blocks"]["norm1_b"] = leaf(b + ("norm1_b",), zeros((d, h)))
        params["blocks"]["norm2_b"] = leaf(b + ("norm2_b",), zeros((d, h)))
        params["merger"]["ln_q_b"] = leaf(g + ("ln_q_b",), zeros((h,)))
    return params


def vision_param_axes(cfg: VisionConfig) -> Params:
    """Logical sharding axes matching init_vision_params structure (the JAX
    package's ``vision_param_axes``)."""
    if cfg.mlp_type == "gated":
        mlp = {
            "gate": ("layers", "vit_embed", "vit_mlp"),
            "gate_b": ("layers", "vit_mlp"),
            "up": ("layers", "vit_embed", "vit_mlp"),
            "up_b": ("layers", "vit_mlp"),
            "down": ("layers", "vit_mlp", "vit_embed"),
            "down_b": ("layers", "vit_embed"),
        }
    else:
        mlp = {
            "fc1": ("layers", "vit_embed", "vit_mlp"),
            "fc1_b": ("layers", "vit_mlp"),
            "fc2": ("layers", "vit_mlp", "vit_embed"),
            "fc2_b": ("layers", "vit_embed"),
        }
    axes = {
        "patch_embed": {"kernel": ("patch", "vit_embed")},
        "blocks": {
            "norm1": ("layers", "vit_embed"),
            "norm2": ("layers", "vit_embed"),
            "attn": {
                "wq": ("layers", "vit_embed", "vit_heads"),
                "bq": ("layers", "vit_heads"),
                "wk": ("layers", "vit_embed", "vit_heads"),
                "bk": ("layers", "vit_heads"),
                "wv": ("layers", "vit_embed", "vit_heads"),
                "bv": ("layers", "vit_heads"),
                "wo": ("layers", "vit_heads", "vit_embed"),
                "bo": ("layers", "vit_embed"),
            },
            "mlp": mlp,
        },
        "merger": {
            "ln_q": ("vit_embed",),
            "w1": ("vit_embed", "vit_mlp"),
            "b1": ("vit_mlp",),
            "w2": ("vit_embed", "vit_mlp"),
            "b2": ("vit_mlp",),
        },
    }
    if cfg.norm_type == "layernorm":
        axes["blocks"]["norm1_b"] = ("layers", "vit_embed")
        axes["blocks"]["norm2_b"] = ("layers", "vit_embed")
        axes["merger"]["ln_q_b"] = ("vit_embed",)
    return axes


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


def _attn_block(x, p, cos, sin, valid, cfg: VisionConfig, full: bool,
                trainable: bool = False, n_images: int = 1, group=None,
                rope32=None):
    """x: (pad_tokens, hidden) window-ordered -> attention output.

    With n_images > 1, x is the token-axis concatenation of that many
    same-shaped images: window layers run over the whole concatenation
    (no window straddles two images), full-attention layers take the image
    axis as the attention batch, so no image attends to another. rope32:
    cos/sin in float32, (pad_tokens, head_dim) contiguous, for the window
    kernel's fused rope (made once an encode)."""
    tokens = x.shape[0]
    hd = cfg.head_dim
    b = n_images if full else 1
    x = copy_to_group(x, group)  # column-parallel q/k/v (see decoder._layer)
    shape = (b, tokens // b, -1, hd)  # this rank's heads
    q = (amm(x, p["wq"]) + p["bq"]).reshape(shape)
    k = (amm(x, p["wk"]) + p["bk"]).reshape(shape)
    v = (amm(x, p["wv"]) + p["bv"]).reshape(shape)
    cs = cos.reshape(b, tokens // b, hd)
    sn = sin.reshape(b, tokens // b, hd)
    mask = valid.reshape(b, tokens // b)
    if full:
        q, k = apply_rope(q, k, cs, sn)
        out = attention(q, k, v, kv_mask=mask, causal=False)
    elif trainable:
        # the differentiable wrapper over the kernel's no-rope instance
        q, k = apply_rope(q, k, cs, sn)
        out = window_attention(q, k, v, cfg.window_patches ** 2,
                               kv_mask=mask)
    else:
        # rope fused into the window kernel (cos/sin in float32, holding the
        # activation-dtype values the JAX encoder hands its kernel)
        cs32, sn32 = rope32
        out = window_attention_kernel_call(
            q, k, v, cfg.window_patches ** 2, kv_mask=mask,
            cos=cs32.reshape(1, tokens, hd), sin=sn32.reshape(1, tokens, hd))
    out = out.reshape(tokens, -1)
    return _out_product(out, p["wo"], group) + p["bo"]


def _out_product(x, w, group):
    """A block's output product over this rank's columns of x: row-parallel
    for an int8 leaf, the whole bf16 leaf over x gathered whole otherwise
    (see the module docstring)."""
    if group is None or is_quantized(w):
        return amm(x, w, group)
    return amm(gather_from_group(x, group), w)


def _mlp(cfg: VisionConfig, x, p, group=None):
    x = copy_to_group(x, group)
    if cfg.mlp_type == "plain":
        return _out_product(_activation(cfg, amm(x, p["fc1"]) + p["fc1_b"]),
                            p["fc2"], group) + p["fc2_b"]
    gate = _activation(cfg, amm(x, p["gate"]) + p["gate_b"])
    up = amm(x, p["up"]) + p["up_b"]
    return _out_product(gate * up, p["down"], group) + p["down_b"]


def encode_image(params: Params, cfg: VisionConfig,
                 pixel_values: torch.Tensor,  # (pad_tokens, patch_input_dim)
                 perm: torch.Tensor,          # (pad_tokens,) int
                 valid: torch.Tensor,         # (pad_tokens,) float32
                 pos_hw: torch.Tensor,        # (pad_tokens, 2) int
                 trainable: bool = False,
                 remat: bool = False,
                 n_images: int = 1,
                 group=None,
                 ) -> torch.Tensor:
    """Encode one padded image, or with n_images > 1 the token-axis
    concatenation of that many same-shaped images (batched prefill).
    Returns (pad_merged, out_hidden) in window-merged order; callers select
    real tokens with layout.extract, offset by each image's pad_merged when
    batched. (The JAX function's static ``n_windows`` follows from the
    token count.)

    trainable=True takes the differentiable window attention (training);
    remat=True checkpoints each block, so the backward recomputes one
    block's internals at a time, kernels included. `group`: the blocks'
    tensor-parallel group (see the module docstring)."""
    x = amm(pixel_values, params["patch_embed"]["kernel"])
    x = x[perm.long()]  # patchify order -> window order
    valid = valid.float()
    cos, sin = vision_rope_cos_sin(pos_hw, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    # the window layers' fused rope takes float32 cos/sin: cast once here,
    # not in each of the window layers
    rope32 = (None if trainable
              else (cos.float().contiguous(), sin.float().contiguous()))

    full_idx = cfg.fullatt_block_indexes

    def block(x, lp, full):
        x = x + _attn_block(_vnorm(cfg, x, lp["norm1"], lp.get("norm1_b")),
                            lp["attn"], cos, sin, valid, cfg, full,
                            trainable, n_images, group, rope32)
        return x + _mlp(cfg, _vnorm(cfg, x, lp["norm2"], lp.get("norm2_b")),
                        lp["mlp"], group)

    for i, lp in enumerate(unbind_layers(params["blocks"], cfg.depth)):
        full = full_idx is None or i in full_idx
        if remat:
            x = checkpoint(block, x, lp, full, use_reentrant=False)
        else:
            x = block(x, lp, full)

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
