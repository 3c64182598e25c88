"""Checkpoint save and restore: step-numbered directories, keep-last-N,
COMPLETED markers, resume discovery (port of
``karanta_tpu/training/checkpoint.py``).

The same directory rules as the JAX package: checkpoints live under
``<output_dir>/step_<N>/``, a COMPLETED marker is written last (a crash
mid-save leaves no marker), and resume picks the newest completed step.
The format is the port's own (orbax needs JAX): the state's tensors in one
``state.safetensors``, keyed by their "/"-joined paths ("params/text/embed",
"opt_state/mu/text/embed", "step"), beside ``metadata.json``.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Optional


from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.utils.tree import flatten_tree, unflatten_tree

logger = logging.getLogger(__name__)

STEP_RE = re.compile(r"^(step|epoch)_(\d+)$")
COMPLETED = "COMPLETED"
STATE_FILE = "state.safetensors"


def checkpoint_dirs(output_dir: str) -> list[tuple[int, str]]:
    """Sorted (step, path) of checkpoint dirs under output_dir."""
    if not os.path.isdir(output_dir):
        return []
    found = []
    for name in os.listdir(output_dir):
        match = STEP_RE.match(name)
        if match:
            found.append((int(match.group(2)), os.path.join(output_dir, name)))
    return sorted(found)


def get_last_checkpoint(output_dir: str,
                        incomplete: bool = False) -> Optional[str]:
    """Newest checkpoint dir, requiring the COMPLETED marker unless
    incomplete=True."""
    for _, path in reversed(checkpoint_dirs(output_dir)):
        if incomplete or os.path.exists(os.path.join(path, COMPLETED)):
            return path
    return None


def clean_last_n_checkpoints(output_dir: str, keep_last: int = 2) -> None:
    dirs = checkpoint_dirs(output_dir)
    for _, path in dirs[:-keep_last] if keep_last > 0 else dirs:
        logger.info("removing old checkpoint %s", path)
        shutil.rmtree(path, ignore_errors=True)


def _as_tree(state: Any) -> dict:
    """A TrainState (or any dataclass of trees) as a dict of its fields."""
    if hasattr(state, "__dataclass_fields__"):
        return {name: getattr(state, name)
                for name in state.__dataclass_fields__}
    return state


def save_checkpoint(output_dir: str, step: int, state: Any,
                    metadata: Optional[dict] = None,
                    keep_last: int = 2, leaf_fn=None,
                    write: bool = True) -> str:
    """Save a state (a TrainState or a tree of tensors) to
    <output_dir>/step_<N>/, then the metadata, then the COMPLETED marker.

    Sharded states: `leaf_fn(key, tensor)` gives each leaf whole (the
    ranks gather it together, so every rank calls this), and only the rank
    with `write` writes; the checkpoint is the unsharded state, which
    restores at any mesh."""
    from safetensors.torch import save_file

    path = os.path.join(output_dir, f"step_{step}")
    tensors = {key: (leaf if leaf_fn is None else leaf_fn(key, leaf))
               .detach().to("cpu").contiguous()
               for key, leaf in flatten_tree(_as_tree(state)).items()}
    if not write:
        return path
    os.makedirs(output_dir, exist_ok=True)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    save_file(tensors, os.path.join(path, STATE_FILE))
    del tensors
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump({"step": step, **(metadata or {})}, f)
    with open(os.path.join(path, COMPLETED), "w") as f:
        f.write("done\n")
    if keep_last:
        clean_last_n_checkpoints(output_dir, keep_last)
    logger.info("saved checkpoint %s", path)
    return path


def _state_file(path: str) -> str:
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"no checkpoint state at {file}")
    return file


def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore_params(path: str, device: DeviceLike = None, leaf_fn=None
                   ) -> tuple[Any, dict]:
    """Only the model parameters of a TrainState checkpoint, on `device`
    (the card unless the caller passes another); the optimizer state is
    not read. `leaf_fn(path, tensor)`, when given, takes each tensor as it
    is read (path: the key tuple, "text"/"visual" first) and returns what
    the tree keeps. Returns (params, metadata)."""
    from safetensors import safe_open

    device = resolve_device(device)
    flat = {}
    with safe_open(_state_file(path), framework="pt",
                   device="cpu") as f:
        for key in f.keys():
            if key.startswith("params/"):
                name = key[len("params/"):]
                t = f.get_tensor(key).to(device)
                flat[name] = (leaf_fn(tuple(name.split("/")), t)
                              if leaf_fn is not None else t)
    if not flat:
        raise ValueError(f"{path} holds no params/ tensors")
    return unflatten_tree(flat), _metadata(path)


def restore_checkpoint(path: str, target: Any, leaf_fn=None
                       ) -> tuple[Any, dict]:
    """Restore a state saved by save_checkpoint into the structure of
    `target` (an example state: same keys, shapes and dtypes); each tensor
    lands on the device of the target's leaf. `leaf_fn(key, tensor)`, when
    given, cuts each saved (whole) tensor to this rank's slice first.
    Returns (state, metadata)."""
    from safetensors import safe_open

    with safe_open(_state_file(path), framework="pt",
                   device="cpu") as f:
        saved = set(f.keys())

        def load(leaf, key):
            if key not in saved:
                raise KeyError(f"checkpoint {path} lacks {key}")
            t = f.get_tensor(key)
            if leaf_fn is not None:
                part = leaf_fn(key, t)
                t = part.clone() if part.numel() < t.numel() else part
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(f"{key}: checkpoint {tuple(t.shape)} "
                                 f"{t.dtype}, target {tuple(leaf.shape)} "
                                 f"{leaf.dtype}")
            return t.to(leaf.device)

        tree = _as_tree(target)
        restored = {key: _restore(value, key, load)
                    for key, value in tree.items()}
    if tree is not target:
        restored = type(target)(**restored)
    return restored, _metadata(path)


def _restore(tree: Any, prefix: str, load) -> Any:
    """The target's structure with every tensor leaf loaded by its path."""
    if isinstance(tree, dict):
        return {k: _restore(v, f"{prefix}/{k}", load) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_restore(v, f"{prefix}/{i}", load) for i, v in enumerate(tree)]
    return load(tree, prefix)
