"""Weight bridge from the JAX package's parameters to the port's.

Both packages keep one layout: nested dicts, per-layer weights stacked on a
leading layer axis, weights ``(in, out)``, quantized leaves as
``{"int8_q": int8, "scale": float32}``. ``from_jax_params`` takes the JAX
params as a tree of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns torch tensors on the device, so both packages compute the same thing
from the same numbers.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig
from karanta_tpu_torch.ops.quantization import QUANT_KEY, out_major
from karanta_tpu_torch.utils.tree import tree_map


def _expected_shapes(cfg: VLMConfig) -> dict:
    t, v = cfg.text, cfg.vision
    return {
        ("text", "embed"): (t.vocab_size, t.hidden_size),
        ("text", "layers", "ln1"): (t.num_layers, t.hidden_size),
        ("text", "final_norm"): (t.hidden_size,),
        ("visual", "patch_embed", "kernel"): (v.patch_input_dim, v.hidden_size),
        ("visual", "blocks", "norm1"): (v.depth, v.hidden_size),
    }


def from_jax_params(np_params: Any, cfg: VLMConfig,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.bfloat16) -> Any:
    """JAX params (numpy leaves) -> port params (torch leaves on device).

    Float leaves become ``dtype``; int8 leaves stay int8 and the float32
    scales of quantized leaves stay float32. The leading shapes are checked
    against ``cfg``."""
    device = resolve_device(device)
    shapes = _expected_shapes(cfg)

    def convert(leaf, path):
        arr = np.asarray(leaf)
        want = shapes.get(path)
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(f"param {'/'.join(path)} has shape {arr.shape}, "
                             f"config {cfg.name} expects {want}")
        if arr.dtype == np.int8:
            return out_major(torch.from_numpy(arr.copy()).to(device))
        if path[-1] == "scale" and QUANT_KEY in _siblings(np_params, path):
            return torch.from_numpy(arr.astype(np.float32)).to(device)
        return torch.from_numpy(arr.astype(np.float32)).to(device, dtype)

    missing = [p for p in shapes if _lookup(np_params, p) is None]
    if missing:
        raise ValueError(f"params lack {['/'.join(p) for p in missing]}")
    return tree_map(convert, np_params)


def stream_params_from_jax(np_sp: dict, device: DeviceLike = None,
                           dtype: torch.dtype = torch.bfloat16) -> dict:
    """The JAX ``pack_stream_params`` dict (numpy leaves) -> the port's
    (``ops/decode_stream.pack_stream_params``): the same keys, shapes and
    values in the stream kernels' layout. ``wqkv``/``wo``/``wd`` go through
    ``out_major``; ``wg_t``/``wu_t`` are already (out, in) and stay
    contiguous; float32 scales stay float32; norms and biases become
    ``dtype``."""
    device = resolve_device(device)
    out = {}
    for key, leaf in np_sp.items():
        arr = np.asarray(leaf)
        if arr.dtype == np.int8:
            t = torch.from_numpy(arr.copy()).to(device)
            out[key] = out_major(t) if key in ("wqkv", "wo", "wd") else t
        elif key in ("qs", "os", "gs", "us", "ds"):
            out[key] = torch.from_numpy(arr.astype(np.float32)).to(device)
        else:
            out[key] = torch.from_numpy(arr.astype(np.float32)).to(device,
                                                                   dtype)
    return out


def _lookup(tree, path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _siblings(tree, path) -> dict:
    parent = _lookup(tree, path[:-1])
    return parent if isinstance(parent, dict) else {}
