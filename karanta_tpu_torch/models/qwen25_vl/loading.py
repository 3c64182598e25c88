"""HF checkpoint loading: Qwen2.5-VL safetensors -> the port's parameters
(port of ``karanta_tpu/models/qwen25_vl/loading.py``).

Accepts both the modern transformers layout (model.visual.*,
model.language_model.*) and the original hub layout (visual.*, model.*).
Per-layer weights are stacked on a leading layer axis and stored (in, out),
the layout ``model.init_params`` gives; with ``quantize="int8"`` each
decoder matrix stack is quantized as it arrives on the device
(``ops/quantization.quantize_weight``: out-major int8 and float32 scales),
so a 7B load never holds the whole bf16 decoder on the card.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig
from karanta_tpu_torch.ops.quantization import quantize_weight


def _normalize_key(key: str) -> str:
    """Map any known naming scheme onto model.visual.* /
    model.language_model.*"""
    if key.startswith("visual."):
        return "model." + key
    if key.startswith("model.visual.") or key.startswith(
            "model.language_model."):
        return key
    if key == "lm_head.weight":
        return key
    if key.startswith("model."):
        return "model.language_model." + key[len("model."):]
    return key


def convert_state_dict(state: Mapping[str, Any], cfg: VLMConfig,
                       dtype: torch.dtype = torch.bfloat16,
                       quantize: Optional[str] = None,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """An HF state dict (torch tensors or numpy arrays; the mapping may read
    each tensor on lookup) -> the port's parameters on `device`.

    Each tensor is moved to the device as it is looked up and stacked
    there. quantize="int8" quantizes the decoder's matrix stacks (and the
    logits head) on arrival: the device holds one bf16 stack beside its
    int8 copy at a time. Callers then build the Engine with quantize=None.
    """
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = resolve_device(device)
    keys = {_normalize_key(k): k for k in state}

    def get(key: str) -> torch.Tensor:
        t = state[keys[key]]
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(t)
        return t.to(device)

    def lin(key: str) -> torch.Tensor:  # Linear weight (out, in) -> (in, out)
        return get(key).T

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype).contiguous()

    def q(t: torch.Tensor):
        t = cast(t)
        return quantize_weight(t) if quantize == "int8" else t

    v = cfg.vision
    t = cfg.text
    h = v.hidden_size

    def vstack(fn: Callable[[int], torch.Tensor]) -> torch.Tensor:
        return cast(torch.stack([fn(i) for i in range(v.depth)]))

    def tstack(fn: Callable[[int], torch.Tensor]) -> torch.Tensor:
        return cast(torch.stack([fn(i) for i in range(t.num_layers)]))

    def tstack_q(fn: Callable[[int], torch.Tensor]):
        """A decoder matrix stack, quantized on arrival when requested."""
        return q(torch.stack([fn(i) for i in range(t.num_layers)]))

    vb = "model.visual.blocks.{}."

    def qkv_w(i: int, part: int) -> torch.Tensor:
        w = get(vb.format(i) + "attn.qkv.weight")  # (3h, h)
        return w[part * h:(part + 1) * h].T

    def qkv_b(i: int, part: int) -> torch.Tensor:
        b = get(vb.format(i) + "attn.qkv.bias")
        return b[part * h:(part + 1) * h]

    if v.mlp_type == "gated":
        vision_mlp = {
            "gate": vstack(lambda i: lin(vb.format(i) + "mlp.gate_proj.weight")),
            "gate_b": vstack(lambda i: get(vb.format(i) + "mlp.gate_proj.bias")),
            "up": vstack(lambda i: lin(vb.format(i) + "mlp.up_proj.weight")),
            "up_b": vstack(lambda i: get(vb.format(i) + "mlp.up_proj.bias")),
            "down": vstack(lambda i: lin(vb.format(i) + "mlp.down_proj.weight")),
            "down_b": vstack(lambda i: get(vb.format(i) + "mlp.down_proj.bias")),
        }
    else:  # Qwen2-VL plain MLP
        vision_mlp = {
            "fc1": vstack(lambda i: lin(vb.format(i) + "mlp.fc1.weight")),
            "fc1_b": vstack(lambda i: get(vb.format(i) + "mlp.fc1.bias")),
            "fc2": vstack(lambda i: lin(vb.format(i) + "mlp.fc2.weight")),
            "fc2_b": vstack(lambda i: get(vb.format(i) + "mlp.fc2.bias")),
        }

    visual = {
        "patch_embed": {
            # Conv3d weight (out, C, T, P, P) -> (C*T*P*P, out); feature order
            # (C, T, P, P) matches ops/image_prep.patchify
            "kernel": cast(get("model.visual.patch_embed.proj.weight")
                           .reshape(h, -1).T),
        },
        "blocks": {
            "norm1": vstack(lambda i: get(vb.format(i) + "norm1.weight")),
            "norm2": vstack(lambda i: get(vb.format(i) + "norm2.weight")),
            "attn": {
                "wq": vstack(lambda i: qkv_w(i, 0)),
                "bq": vstack(lambda i: qkv_b(i, 0)),
                "wk": vstack(lambda i: qkv_w(i, 1)),
                "bk": vstack(lambda i: qkv_b(i, 1)),
                "wv": vstack(lambda i: qkv_w(i, 2)),
                "bv": vstack(lambda i: qkv_b(i, 2)),
                "wo": vstack(lambda i: lin(vb.format(i) + "attn.proj.weight")),
                "bo": vstack(lambda i: get(vb.format(i) + "attn.proj.bias")),
            },
            "mlp": vision_mlp,
        },
        "merger": {
            "ln_q": cast(get("model.visual.merger.ln_q.weight")),
            "w1": cast(lin("model.visual.merger.mlp.0.weight")),
            "b1": cast(get("model.visual.merger.mlp.0.bias")),
            "w2": cast(lin("model.visual.merger.mlp.2.weight")),
            "b2": cast(get("model.visual.merger.mlp.2.bias")),
        },
    }
    if v.norm_type == "layernorm":
        visual["blocks"]["norm1_b"] = vstack(
            lambda i: get(vb.format(i) + "norm1.bias"))
        visual["blocks"]["norm2_b"] = vstack(
            lambda i: get(vb.format(i) + "norm2.bias"))
        visual["merger"]["ln_q_b"] = cast(
            get("model.visual.merger.ln_q.bias"))

    tb = "model.language_model.layers.{}."
    text = {
        "embed": cast(get("model.language_model.embed_tokens.weight")),
        "layers": {
            "ln1": tstack(lambda i: get(tb.format(i)
                                        + "input_layernorm.weight")),
            "ln2": tstack(lambda i: get(tb.format(i)
                                        + "post_attention_layernorm.weight")),
            "attn": {
                "wq": tstack_q(lambda i: lin(tb.format(i)
                                             + "self_attn.q_proj.weight")),
                "bq": tstack(lambda i: get(tb.format(i)
                                           + "self_attn.q_proj.bias")),
                "wk": tstack_q(lambda i: lin(tb.format(i)
                                             + "self_attn.k_proj.weight")),
                "bk": tstack(lambda i: get(tb.format(i)
                                           + "self_attn.k_proj.bias")),
                "wv": tstack_q(lambda i: lin(tb.format(i)
                                             + "self_attn.v_proj.weight")),
                "bv": tstack(lambda i: get(tb.format(i)
                                           + "self_attn.v_proj.bias")),
                "wo": tstack_q(lambda i: lin(tb.format(i)
                                             + "self_attn.o_proj.weight")),
            },
            "mlp": {
                "gate": tstack_q(lambda i: lin(tb.format(i)
                                               + "mlp.gate_proj.weight")),
                "up": tstack_q(lambda i: lin(tb.format(i)
                                             + "mlp.up_proj.weight")),
                "down": tstack_q(lambda i: lin(tb.format(i)
                                               + "mlp.down_proj.weight")),
            },
        },
        "final_norm": cast(get("model.language_model.norm.weight")),
    }
    if not t.tie_word_embeddings:
        text["lm_head"] = q(lin("lm_head.weight"))
    elif quantize == "int8":
        # tied embeddings: the per-step logits product reads an int8 table
        # (hidden, vocab), the embedding transposed, as
        # quantize_decoder_params builds it
        text["logits_head"] = q(get(
            "model.language_model.embed_tokens.weight").T)
    return {"visual": visual, "text": text}


def load_hf_checkpoint(path: str, cfg: VLMConfig,
                       dtype: torch.dtype = torch.bfloat16,
                       quantize: Optional[str] = None,
                       device: DeviceLike = None):
    """Load every *.safetensors under `path` and convert (see
    convert_state_dict). Each tensor is read from its file when the
    conversion reaches it, as a torch tensor in its own dtype (bf16 never
    passes through numpy). quantize="int8": the decoder's matrices quantize
    on arrival; build the Engine with quantize=None then."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"No safetensors files under {path}")
    return convert_state_dict(_Shards(files), cfg, dtype, quantize=quantize,
                              device=device)


class _Shards(Mapping):
    """The tensors of a checkpoint's shards: name -> CPU tensor, read from
    its shard on each lookup."""

    def __init__(self, files: list):
        from safetensors import safe_open

        self._owner = {}
        for file in files:
            shard = safe_open(file, framework="pt", device="cpu")
            self._owner.update({key: shard for key in shard.keys()})

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._owner[key].get_tensor(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._owner)

    def __len__(self) -> int:
        return len(self._owner)
