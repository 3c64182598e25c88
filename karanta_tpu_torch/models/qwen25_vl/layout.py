"""Host-side layout planning for the vision encoder and M-RoPE (numpy copy of
karanta_tpu/models/qwen25_vl/layout.py).

TPU-first design decision: all data-dependent index logic (window ordering,
rope position ids, validity masks, merger un-permutation — what HF computes on
device with argsort/gather, modeling_qwen2_5_vl.py get_window_index) is planned
on the host in numpy, per static grid bucket. The device then runs pure dense
compute with static shapes: window attention is just a batched attention over
(n_windows, 64, hidden) with a validity mask — no gather, no dynamic shapes,
nothing the XLA scheduler can't tile.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from karanta_tpu_torch.models.qwen25_vl.config import VisionConfig
from karanta_tpu_torch.ops.image_prep import ImagePlan


@dataclasses.dataclass(frozen=True)
class VisionLayout:
    """Static per-bucket plan + per-image index arrays for one image."""

    n_windows: int                 # padded windows (static per bucket)
    tokens_per_window: int         # 64 for window_size 112 / patch 14
    perm: np.ndarray               # (pad_tokens,) window-order -> patchify-order idx
    valid: np.ndarray              # (pad_tokens,) float32 1=real token (window order)
    pos_hw: np.ndarray             # (pad_tokens, 2) int32 pre-merge (h, w) (window order)
    extract: np.ndarray            # (num_merged,) int32: window-merged idx of each
    #                                original-order merged unit
    num_merged: int                # real merged tokens (== LLM image tokens)


@functools.lru_cache(maxsize=256)
def _build_layout_cached(grid_h: int, grid_w: int, pad_h: int, pad_w: int,
                         window_patches: int, merge: int) -> VisionLayout:
    assert pad_h % window_patches == 0 and pad_w % window_patches == 0
    win_merged = window_patches // merge            # 4 merged units per window side
    nwh, nww = pad_h // window_patches, pad_w // window_patches
    n_windows = nwh * nww
    tokens_per_window = window_patches * window_patches

    pad_tokens = pad_h * pad_w
    perm = np.zeros((pad_tokens,), dtype=np.int32)
    valid = np.zeros((pad_tokens,), dtype=np.float32)
    pos_hw = np.zeros((pad_tokens, 2), dtype=np.int32)

    merged_cols = pad_w // merge

    i = 0
    for wh in range(nwh):
        for ww in range(nww):
            for mh in range(win_merged):
                for mw in range(win_merged):
                    unit_h = wh * win_merged + mh   # merged coords
                    unit_w = ww * win_merged + mw
                    for ph in range(merge):
                        for pw in range(merge):
                            h = unit_h * merge + ph  # pre-merge coords
                            w = unit_w * merge + pw
                            group = (h // merge) * merged_cols + (w // merge)
                            within = (h % merge) * merge + (w % merge)
                            perm[i] = group * (merge * merge) + within
                            if h < grid_h and w < grid_w:
                                valid[i] = 1.0
                                pos_hw[i] = (h, w)
                            i += 1

    # original-order merged units -> their position in the window-ordered
    # merged sequence (for un-permuting the merger output)
    num_merged = (grid_h // merge) * (grid_w // merge)
    extract = np.zeros((num_merged,), dtype=np.int32)
    units_per_window = win_merged * win_merged
    j = 0
    for uh in range(grid_h // merge):
        for uw in range(grid_w // merge):
            wh, ww = uh // win_merged, uw // win_merged
            mh, mw = uh % win_merged, uw % win_merged
            widx = wh * nww + ww
            extract[j] = widx * units_per_window + mh * win_merged + mw
            j += 1

    return VisionLayout(
        n_windows=n_windows, tokens_per_window=tokens_per_window,
        perm=perm, valid=valid, pos_hw=pos_hw, extract=extract,
        num_merged=num_merged)


def build_vision_layout(plan: ImagePlan, cfg: VisionConfig) -> VisionLayout:
    return _build_layout_cached(
        plan.grid_h, plan.grid_w, plan.pad_grid_h, plan.pad_grid_w,
        cfg.window_patches, cfg.spatial_merge_size)


def mrope_positions(token_ids: np.ndarray, image_grids: list[tuple[int, int, int]],
                    image_token_id: int, merge: int = 2) -> np.ndarray:
    """M-RoPE (3, seq) position ids for a token sequence with image spans.

    Matches Qwen2.5-VL get_rope_index semantics: text tokens advance all three
    streams together; inside an image span of llm-grid (t, h/merge, w/merge)
    the temporal/height/width streams carry grid coordinates offset by the
    running position; after each segment the running position jumps to
    max(previous positions) + 1.
    """
    ids = np.asarray(token_ids)
    seq = len(ids)
    out = np.zeros((3, seq), dtype=np.int32)
    pos = 0  # next position value
    img_iter = iter(image_grids)
    i = 0
    while i < seq:
        if ids[i] == image_token_id:
            t, gh, gw = next(img_iter)
            lh, lw = gh // merge, gw // merge
            span = t * lh * lw
            tt = np.repeat(np.arange(t), lh * lw)
            hh = np.tile(np.repeat(np.arange(lh), lw), t)
            ww = np.tile(np.tile(np.arange(lw), lh), t)
            out[0, i:i + span] = pos + tt
            out[1, i:i + span] = pos + hh
            out[2, i:i + span] = pos + ww
            pos = pos + max(t, lh, lw)
            i += span
        else:
            out[:, i] = pos
            pos += 1
            i += 1
    return out
