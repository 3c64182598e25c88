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


def param_axes(cfg: VLMConfig) -> Params:
    """Logical sharding axes of every parameter (the JAX package's)."""
    return {
        "visual": vis.vision_param_axes(cfg.vision),
        "text": dec.decoder_param_axes(cfg.text),
    }


def serving_param_axes(cfg: VLMConfig,
                       vision_quant: Optional[str] = None) -> Params:
    """param_axes as the sharded serving engine places the parameters. Some
    leaves stay whole on every rank, where the JAX package splits them: the
    input embedding (a lookup, no arithmetic whose order could differ), the
    patch embedding and the merger (two small products per page), and with
    a bf16 tower (`vision_quant` None) the blocks' output products ``wo``
    and ``down``/``fc2`` (``vision.py``: bit-equal products). The int8
    logits table of tied embeddings (``logits_head``, made by
    ``quantize_decoder_params``) is vocab-parallel, as ``lm_head`` is."""
    axes = param_axes(cfg)
    axes["text"]["embed"] = (None, "embed")
    axes["text"]["logits_head"] = ("embed", "vocab")
    visual = axes["visual"]
    visual["patch_embed"] = {"kernel": (None, None)}
    visual["merger"] = {k: (None,) * len(v)
                        for k, v in visual["merger"].items()}
    if vision_quant != "int8":
        blocks = visual["blocks"]
        blocks["attn"]["wo"] = (None, None, None)
        for name in ("down", "fc2"):
            if name in blocks["mlp"]:
                blocks["mlp"][name] = (None, None, None)
    return axes


def serving_leaf_fn(cfg: VLMConfig, mesh, dtype=None,
                    quantize: Optional[str] = None,
                    vision_quant: Optional[str] = None):
    """The sharded loaders' per-leaf step, `fn(path, tensor)` with path
    ("text" | "visual", ...): cast a float leaf to `dtype`, quantize it whole
    where the engine's quantize modes would, keep this rank's slice of it
    (``serving_param_axes``) on the rank's device. The whole leaf is then
    the caller's to drop. Build the Engine with quantize=None and
    vision_quant=None over the result."""
    from karanta_tpu_torch.ops.quantization import (DECODER_INT8, VISION_INT8,
                                                    quantize_weight)
    from karanta_tpu_torch.parallel.sharding import shard_params

    axes = serving_param_axes(cfg, vision_quant)

    def place(path: tuple, x):
        if (dtype is not None and torch.is_tensor(x)
                and x.is_floating_point()):
            x = x.to(dtype)
        part, rest = path[0], tuple(path[1:])
        if ((part == "text" and quantize == "int8" and rest in DECODER_INT8)
                or (part == "visual" and vision_quant == "int8"
                    and rest in VISION_INT8)):
            x = quantize_weight(x)
        node = axes
        for key in path:
            node = node[key]
        return shard_params(x, node, mesh, device=mesh.device,
                            path="/".join(path))

    return place


def init_params_sharded(cfg: VLMConfig, mesh, seed: int = 0,
                        dtype=torch.bfloat16, quantize: Optional[str] = None,
                        vision_quant: Optional[str] = None) -> Params:
    """This rank's shard of ``init_params(cfg, seed, dtype)`` on the rank's
    device, drawn leaf by leaf from the same seeded generators (the same
    values as one card's) and sharded as each is drawn (serving_leaf_fn),
    so no rank holds the whole tree."""
    device = mesh.device
    place = serving_leaf_fn(cfg, mesh, dtype, quantize, vision_quant)
    gen_v = torch.Generator(device=device).manual_seed(2 * seed)
    gen_t = torch.Generator(device=device).manual_seed(2 * seed + 1)
    visual = vis.init_vision_params(
        cfg.vision, gen_v, dtype, device,
        leaf_fn=lambda path, x: place(("visual",) + path, x))
    text = dec.init_decoder_params(
        cfg.text, gen_t, dtype, device,
        leaf_fn=lambda path, x: place(("text",) + path, x))
    params = {"visual": visual, "text": text}
    add_tied_logits_head(params, cfg, mesh, quantize)
    return params


def add_tied_logits_head(params: Params, cfg: VLMConfig, mesh,
                         quantize: Optional[str]) -> None:
    """The sharded loaders' int8 logits table of tied embeddings, made from
    the whole embedding (every rank keeps it whole) and sliced by
    vocabulary, as ``quantize_decoder_params`` makes it on one rank."""
    from karanta_tpu_torch.ops.quantization import quantize_weight

    if cfg.text.tie_word_embeddings and quantize == "int8":
        params["text"]["logits_head"] = serving_leaf_fn(cfg, mesh)(
            ("text", "logits_head"),
            quantize_weight(params["text"]["embed"].transpose(0, 1)))


def merge_image_embeddings(token_embeds: torch.Tensor,   # (S, hidden)
                           image_tokens: torch.Tensor,   # (N_pad, hidden)
                           positions: torch.Tensor,      # (N_pad,) int
                           ) -> torch.Tensor:
    """Scatter vision tokens into the text embedding at image-token
    positions; entries with positions outside [0, S) are dropped (padding,
    or another sequence-parallel rank's chunk)."""
    keep = (positions >= 0) & (positions < token_embeds.shape[0])
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
                  attn_impl=None,
                  pp_mesh=None,
                  pp_micro: int = 1,
                  group=None,
                  gather_layer=None,
                  seq_offset: int = 0,
                  ) -> torch.Tensor:
    """Teacher-forced forward over full sequences: logits (B, S, V), or the
    post-final-norm hidden states (B, S, H) with return_hidden=True (the
    chunked loss computes each chunk's logits itself).

    Each row's image is encoded with the differentiable window attention,
    its real tokens taken by ``vis_extract`` and scattered into the row's
    embeddings at ``image_positions``; then the causal decoder runs over the
    batch. remat=True checkpoints each vision block and each decoder layer.
    The window count follows from the shapes.

    Parallel training: `group` is the tensor-parallel ("model") group of
    the decoder and the tower; `gather_layer` gathers each decoder layer's
    FSDP slices before use; `attn_impl` is the sequence-parallel attention
    (``parallel/context.py``), with the text arrays this rank's chunk
    starting at global position `seq_offset` (``image_positions`` stay
    global: only the image tokens inside the chunk are merged); `pp_mesh`
    runs the decoder layers under the GPipe schedule with `pp_micro`
    microbatches (``decoder.pipeline_prefill_forward``)."""
    embeds = dec.embed_tokens(params["text"], token_ids)
    if pixel_values is not None:
        rows = []
        for i in range(token_ids.shape[0]):
            enc = vis.encode_image(params["visual"], cfg.vision,
                                   pixel_values[i].to(embeds.dtype),
                                   vis_perm[i], vis_valid[i], vis_pos_hw[i],
                                   trainable=True, remat=remat, group=group)
            tokens = enc[vis_extract[i].long()]
            rows.append(merge_image_embeddings(
                embeds[i], tokens, image_positions[i] - seq_offset))
        embeds = torch.stack(rows)
    if pp_mesh is not None:
        hidden = dec.pipeline_prefill_forward(
            params["text"], cfg.text, embeds, positions, pp_mesh,
            n_micro=pp_micro, kv_mask=attn_mask, remat=remat)
    else:
        hidden, _ = dec.prefill_forward(
            params["text"], cfg.text, embeds, positions, kv_mask=attn_mask,
            remat=remat, group=group, attn_impl=attn_impl,
            gather_layer=gather_layer)
    if return_hidden:
        return hidden
    return dec.logits_from_hidden(params["text"], cfg.text, hidden,
                                  group=group)
