"""Random serving weights for throughput runs (port of
``karanta_tpu/bench/randweights.py``).

Decode and prefill cost do not depend on the weights' values, so random
weights measure what a checkpoint would. With ``quantize="int8"`` the
decoder matrices are generated directly in quantized form, one layer of one
leaf at a time on the device, so the peak stays at one layer-slice's float32
temporaries instead of a full bf16 copy of the decoder beside the int8 one.
"""

from __future__ import annotations

import itertools

import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.qwen25_vl.model import init_params
from karanta_tpu_torch.models.qwen25_vl.vision import init_vision_params
from karanta_tpu_torch.ops.quantization import QUANT_KEY, quantize_weight
from karanta_tpu_torch.utils.tree import tree_map

_QUANTIZED = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("gate", "up", "down")}


def init_params_bench(cfg, dtype=torch.bfloat16, quantize=None,
                      device: DeviceLike = None, seed: int = 0):
    """Random serving params. Returns (params, engine_quantize_mode): with
    quantize='int8' the params come pre-quantized and the engine must not
    quantize again (mode None)."""
    device = resolve_device(device)
    if quantize != "int8":
        return init_params(cfg, seed, dtype=dtype, device=device), quantize
    seeds = itertools.count(1000 * seed + 1)
    t = cfg.text
    h, n_layers = t.hidden_size, t.num_layers
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    shapes = {"wq": (h, qd), "wk": (h, kvd), "wv": (h, kvd), "wo": (qd, h),
              "gate": (h, t.intermediate_size), "up": (h, t.intermediate_size),
              "down": (t.intermediate_size, h)}

    def randn(shape):
        gen = torch.Generator(device=device).manual_seed(next(seeds))
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * 0.02

    def gen(shape):
        return randn(shape).to(dtype)

    def gen_q(shape, layers=None):
        """A quantized leaf, generated and quantized one layer at a time."""
        if layers is None:
            return quantize_weight(randn(shape).to(dtype))
        q = torch.empty((layers, shape[1], shape[0]), dtype=torch.int8,
                        device=device).transpose(-1, -2)  # out_major
        scale = torch.empty((layers, 1, shape[1]), dtype=torch.float32,
                            device=device)
        for i in range(layers):
            leaf = quantize_weight(randn(shape).to(dtype))
            q[i], scale[i] = leaf[QUANT_KEY], leaf["scale"]
        return {QUANT_KEY: q, "scale": scale}

    layers = {"ln1": gen((n_layers, h)), "ln2": gen((n_layers, h))}
    layers["attn"] = {n: gen_q(shapes[n], n_layers) for n in _QUANTIZED["attn"]}
    layers["attn"].update(bq=gen((n_layers, qd)), bk=gen((n_layers, kvd)),
                          bv=gen((n_layers, kvd)))
    layers["mlp"] = {n: gen_q(shapes[n], n_layers) for n in _QUANTIZED["mlp"]}
    text = {"embed": gen((t.vocab_size, h)), "final_norm": gen((h,)),
            "layers": layers}
    if t.tie_word_embeddings:  # tied embeddings serve logits off an int8 table
        text["logits_head"] = gen_q((h, t.vocab_size))
    else:
        text["lm_head"] = gen_q((h, t.vocab_size))
    # every vision leaf (norms and biases included) is N(0, 0.02), as in
    # the JAX bench weights
    shapes_v = init_vision_params(cfg.vision, None, dtype, "meta")
    visual = tree_map(lambda leaf, _: gen(tuple(leaf.shape)), shapes_v)
    return {"visual": visual, "text": text}, None
