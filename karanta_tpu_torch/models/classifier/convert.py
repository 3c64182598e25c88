"""The classifier archs' entry points, and the weight bridge from the JAX
package's classifier parameters to the port's.

Both packages keep one tree per arch: nested dicts and lists (stages,
blocks), dense kernels (in, out), conv kernels HWIO, the ViT's encoder
stacked on a leading layer axis. ``from_jax_params`` takes the JAX params as
a tree of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns
torch tensors on the device, so both packages compute the same thing from
the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.models.classifier import convnets, segformer, vit
from karanta_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Arch:
    """One classifier arch: its config class and tiny preset, init,
    forward, HF converter and HF config reader, and the head's input
    width for a config."""

    config: type
    tiny: Callable
    init: Callable
    forward: Callable
    convert_hf: Callable
    config_from_hf: Callable
    head_width: Callable


ARCHS = {
    "vit": Arch(vit.ViTConfig, vit.tiny_vit, vit.init_vit_params,
                vit.vit_forward, vit.convert_hf_vit, vit.vit_config_from_hf,
                lambda cfg: cfg.hidden_size),
    "segformer": Arch(segformer.SegFormerConfig, segformer.tiny_segformer,
                      segformer.init_segformer_params,
                      segformer.segformer_forward,
                      segformer.convert_hf_segformer,
                      segformer.segformer_config_from_hf,
                      lambda cfg: cfg.hidden_sizes[-1]),
    "convnextv2": Arch(convnets.ConvNeXtV2Config, convnets.tiny_convnextv2,
                       convnets.init_convnextv2_params,
                       convnets.convnextv2_forward,
                       convnets.convert_hf_convnextv2,
                       convnets.convnextv2_config_from_hf,
                       lambda cfg: cfg.hidden_sizes[-1]),
    "resnet": Arch(convnets.ResNetConfig, convnets.tiny_resnet,
                   convnets.init_resnet_params, convnets.resnet_forward,
                   convnets.convert_hf_resnet, convnets.resnet_config_from_hf,
                   lambda cfg: cfg.hidden_sizes[-1]),
}


def get_arch(arch: str) -> Arch:
    if arch not in ARCHS:
        raise ValueError(f"unknown classifier arch {arch!r}")
    return ARCHS[arch]


def from_jax_params(np_params: Any, arch: str, cfg: Any,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Any:
    """JAX classifier params (numpy leaves) -> the port's tree (torch
    leaves on `device`, the card unless the caller passes another).

    The head's shape and the depth (the ViT's stacked layers, the others'
    stages) are checked against ``cfg``."""
    device = resolve_device(device)
    spec = get_arch(arch)
    head = tuple(np.shape(np_params["head"]["kernel"]))
    want = (spec.head_width(cfg), cfg.num_classes)
    if head != want:
        raise ValueError(f"{arch} head kernel {head}, config expects {want}")
    if arch == "vit":
        depth, want_depth = len(np_params["layers"]["wq"]), cfg.num_layers
    else:
        depth, want_depth = len(np_params["stages"]), cfg.num_stages
    if depth != want_depth:
        raise ValueError(f"{arch} params have depth {depth}, config "
                         f"{want_depth}")
    return tree_map(
        lambda leaf, _: torch.from_numpy(np.asarray(leaf, np.float32).copy())
        .to(device, dtype), np_params)
