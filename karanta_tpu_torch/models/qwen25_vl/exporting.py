"""Export the port's parameters to an HF-compatible checkpoint (port of
``karanta_tpu/models/qwen25_vl/exporting.py``).

Inverse of loading.convert_state_dict: unstacks the layer-stacked weights
and writes model.safetensors + config.json in the layout transformers and
vLLM read. Tensors keep their dtype (a bf16 model exports bf16); quantized
leaves are not exported.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig


def to_hf_state_dict(params: Any, cfg: VLMConfig) -> dict[str, torch.Tensor]:
    """The port's parameters -> HF-named CPU tensors (modern transformers
    naming), each contiguous in the parameter's dtype."""
    state: dict[str, torch.Tensor] = {}

    def put(key: str, value, transpose: bool = False):
        # transposed where the parameter lives (the card), then copied out
        # (a copy even on the CPU: the writer refuses tensors that share
        # storage, as slices of one stacked parameter do)
        t = value.detach()
        state[key] = (t.T if transpose else t).contiguous().to(
            "cpu", copy=True)

    v = cfg.vision
    visual = params["visual"]
    # (patch_input, hidden) -> Conv3d (hidden, C, T, P, P)
    put("model.visual.patch_embed.proj.weight",
        visual["patch_embed"]["kernel"].T.reshape(
            v.hidden_size, v.in_channels, v.temporal_patch_size,
            v.patch_size, v.patch_size))

    blocks = visual["blocks"]
    for i in range(v.depth):
        pre = f"model.visual.blocks.{i}."
        put(pre + "norm1.weight", blocks["norm1"][i])
        put(pre + "norm2.weight", blocks["norm2"][i])
        put(pre + "attn.qkv.weight", torch.cat([
            blocks["attn"][k][i].T for k in ("wq", "wk", "wv")], dim=0))
        put(pre + "attn.qkv.bias", torch.cat([
            blocks["attn"][b][i] for b in ("bq", "bk", "bv")]))
        put(pre + "attn.proj.weight", blocks["attn"]["wo"][i], transpose=True)
        put(pre + "attn.proj.bias", blocks["attn"]["bo"][i])
        if v.mlp_type == "gated":
            put(pre + "mlp.gate_proj.weight", blocks["mlp"]["gate"][i],
                transpose=True)
            put(pre + "mlp.gate_proj.bias", blocks["mlp"]["gate_b"][i])
            put(pre + "mlp.up_proj.weight", blocks["mlp"]["up"][i],
                transpose=True)
            put(pre + "mlp.up_proj.bias", blocks["mlp"]["up_b"][i])
            put(pre + "mlp.down_proj.weight", blocks["mlp"]["down"][i],
                transpose=True)
            put(pre + "mlp.down_proj.bias", blocks["mlp"]["down_b"][i])
        else:
            put(pre + "mlp.fc1.weight", blocks["mlp"]["fc1"][i], transpose=True)
            put(pre + "mlp.fc1.bias", blocks["mlp"]["fc1_b"][i])
            put(pre + "mlp.fc2.weight", blocks["mlp"]["fc2"][i], transpose=True)
            put(pre + "mlp.fc2.bias", blocks["mlp"]["fc2_b"][i])
        if v.norm_type == "layernorm":
            put(pre + "norm1.bias", blocks["norm1_b"][i])
            put(pre + "norm2.bias", blocks["norm2_b"][i])

    merger = visual["merger"]
    put("model.visual.merger.ln_q.weight", merger["ln_q"])
    if v.norm_type == "layernorm":
        put("model.visual.merger.ln_q.bias", merger["ln_q_b"])
    put("model.visual.merger.mlp.0.weight", merger["w1"], transpose=True)
    put("model.visual.merger.mlp.0.bias", merger["b1"])
    put("model.visual.merger.mlp.2.weight", merger["w2"], transpose=True)
    put("model.visual.merger.mlp.2.bias", merger["b2"])

    t = cfg.text
    text = params["text"]
    put("model.language_model.embed_tokens.weight", text["embed"])
    layers = text["layers"]
    for i in range(t.num_layers):
        pre = f"model.language_model.layers.{i}."
        put(pre + "input_layernorm.weight", layers["ln1"][i])
        put(pre + "post_attention_layernorm.weight", layers["ln2"][i])
        put(pre + "self_attn.q_proj.weight", layers["attn"]["wq"][i],
            transpose=True)
        put(pre + "self_attn.q_proj.bias", layers["attn"]["bq"][i])
        put(pre + "self_attn.k_proj.weight", layers["attn"]["wk"][i],
            transpose=True)
        put(pre + "self_attn.k_proj.bias", layers["attn"]["bk"][i])
        put(pre + "self_attn.v_proj.weight", layers["attn"]["wv"][i],
            transpose=True)
        put(pre + "self_attn.v_proj.bias", layers["attn"]["bv"][i])
        put(pre + "self_attn.o_proj.weight", layers["attn"]["wo"][i],
            transpose=True)
        put(pre + "mlp.gate_proj.weight", layers["mlp"]["gate"][i],
            transpose=True)
        put(pre + "mlp.up_proj.weight", layers["mlp"]["up"][i], transpose=True)
        put(pre + "mlp.down_proj.weight", layers["mlp"]["down"][i],
            transpose=True)
    put("model.language_model.norm.weight", text["final_norm"])
    if t.tie_word_embeddings:
        # HF materializes the tied head in the state dict
        put("lm_head.weight", text["embed"])
    else:
        put("lm_head.weight", text["lm_head"], transpose=True)
    return state


def hf_config_dict(cfg: VLMConfig) -> dict:
    return {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"],
        "model_type": "qwen2_5_vl",
        "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id,
        "text_config": {
            "model_type": "qwen2_5_vl_text",
            "vocab_size": cfg.text.vocab_size,
            "hidden_size": cfg.text.hidden_size,
            "num_hidden_layers": cfg.text.num_layers,
            "num_attention_heads": cfg.text.num_heads,
            "num_key_value_heads": cfg.text.num_kv_heads,
            "intermediate_size": cfg.text.intermediate_size,
            "rms_norm_eps": cfg.text.rms_norm_eps,
            "rope_theta": cfg.text.rope_theta,
            "tie_word_embeddings": cfg.text.tie_word_embeddings,
            "max_position_embeddings": cfg.text.max_position_embeddings,
            "rope_scaling": {"type": "mrope",
                             "mrope_section": list(cfg.text.mrope_section)},
        },
        "vision_config": {
            "model_type": "qwen2_5_vl",
            "depth": cfg.vision.depth,
            "hidden_size": cfg.vision.hidden_size,
            "num_heads": cfg.vision.num_heads,
            "intermediate_size": cfg.vision.intermediate_size,
            "out_hidden_size": cfg.vision.out_hidden_size,
            "patch_size": cfg.vision.patch_size,
            "spatial_merge_size": cfg.vision.spatial_merge_size,
            "temporal_patch_size": cfg.vision.temporal_patch_size,
            "window_size": cfg.vision.window_size,
            "fullatt_block_indexes": list(cfg.vision.fullatt_block_indexes),
        },
    }


def save_hf_checkpoint(params: Any, cfg: VLMConfig, output_dir: str) -> str:
    """Write model.safetensors + config.json under output_dir."""
    from safetensors.torch import save_file

    os.makedirs(output_dir, exist_ok=True)
    save_file(to_hf_state_dict(params, cfg),
              os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    return output_dir
