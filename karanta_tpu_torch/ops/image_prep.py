"""Page-image preprocessing (port of ``karanta_tpu/ops/image_prep.py``).

- ``smart_resize`` / ``plan_image`` reproduce Qwen-VL's resizing rule (sides
  divisible by 28, pixel budget clamped) so token counts match.
- ``patchify`` rescales, CLIP-normalizes and reshapes a resized page into the
  Qwen-VL ``pixel_values`` layout, zero-padded to a static grid bucket.
- ``resize_patchify`` is the engine's default path: the decoded page goes to
  the device and the PIL-equivalent bicubic resize runs as two float32
  resampling matmuls (TF32 must be off for the float32 products to be exact
  enough; the caller's ``torch.backends`` flags decide that).

Feature layout matches the HF Qwen2-VL image processor: sequence order
(t, h_block, w_block, merge_h, merge_w), feature order (C, T, patch, patch).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# OpenAI CLIP normalization constants (HF image processor defaults).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

PATCH_SIZE = 14
MERGE_SIZE = 2
TEMPORAL_PATCH_SIZE = 2
FACTOR = PATCH_SIZE * MERGE_SIZE  # 28
MIN_PIXELS = 56 * 56
MAX_PIXELS = 14 * 14 * 4 * 1280

# Grid buckets in pre-merge patches per side (multiples of the 8-patch window)
GRID_BUCKETS = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)

# Source-pixel buckets for the on-device resize path
SRC_PX_BUCKETS = (448, 896, 1344, 1792, 2240, 2688, 3136, 3584, 4032)


def smart_resize(height: int, width: int, factor: int = FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Qwen-VL resize rule: dims divisible by factor, pixel budget respected."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def bucket_side(patches: int) -> int:
    for b in GRID_BUCKETS:
        if patches <= b:
            return b
    raise ValueError(f"Image grid side {patches} exceeds largest bucket")


@dataclasses.dataclass(frozen=True)
class ImagePlan:
    """Host-side layout plan for one image."""

    resized_h: int          # pixels after smart_resize
    resized_w: int
    grid_h: int             # pre-merge patches
    grid_w: int
    pad_grid_h: int         # bucketed (static) grid
    pad_grid_w: int

    @property
    def grid_thw(self) -> tuple[int, int, int]:
        return (1, self.grid_h, self.grid_w)

    @property
    def num_tokens(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def num_merged_tokens(self) -> int:
        return (self.grid_h // MERGE_SIZE) * (self.grid_w // MERGE_SIZE)

    @property
    def pad_tokens(self) -> int:
        return self.pad_grid_h * self.pad_grid_w


def plan_image(height: int, width: int,
               min_pixels: int = MIN_PIXELS,
               max_pixels: int = MAX_PIXELS) -> ImagePlan:
    rh, rw = smart_resize(height, width, FACTOR, min_pixels, max_pixels)
    gh, gw = rh // PATCH_SIZE, rw // PATCH_SIZE
    return ImagePlan(rh, rw, gh, gw, bucket_side(gh), bucket_side(gw))


def src_px_bucket(px: int) -> "int | None":
    for b in SRC_PX_BUCKETS:
        if px <= b:
            return b
    return None


def patchify(image_u8: torch.Tensor, *, grid_h: int, grid_w: int,
             pad_grid_h: int, pad_grid_w: int, grayscale: bool = False,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 (grid_h*14, grid_w*14, 3) -> pixel_values (pad_seq, 1176).

    Padded tokens (beyond grid_h/grid_w) are zero; callers mask them."""
    x = image_u8.float() / 255.0
    ph, pw = pad_grid_h * PATCH_SIZE, pad_grid_w * PATCH_SIZE
    x = torch.nn.functional.pad(x, (0, 0, 0, pw - x.shape[1],
                                    0, ph - x.shape[0]))
    return _patchify_core(x, valid_h=grid_h * PATCH_SIZE,
                          valid_w=grid_w * PATCH_SIZE,
                          pad_grid_h=pad_grid_h, pad_grid_w=pad_grid_w,
                          grayscale=grayscale, out_dtype=out_dtype)


def _patchify_core(x: torch.Tensor, *, valid_h: int, valid_w: int,
                   pad_grid_h: int, pad_grid_w: int,
                   grayscale: bool, out_dtype) -> torch.Tensor:
    """float [0,1] pixels (pad_grid_h*14, pad_grid_w*14, 3) -> (pad_seq, 1176).

    Pixels at/beyond (valid_h, valid_w) are forced to exactly zero after
    normalization (the zero-padded-feature contract for masked tokens)."""
    if grayscale:
        luma = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
        x = torch.stack([luma, luma, luma], dim=-1)
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    if valid_h < x.shape[0] or valid_w < x.shape[1]:
        x = x.clone()
        x[valid_h:] = 0.0
        x[:, valid_w:] = 0.0
    # HWC -> (C, gh//2, 2, 14, gw//2, 2, 14)
    x = x.permute(2, 0, 1).reshape(
        3, pad_grid_h // MERGE_SIZE, MERGE_SIZE, PATCH_SIZE,
        pad_grid_w // MERGE_SIZE, MERGE_SIZE, PATCH_SIZE)
    # -> (gh//2, gw//2, merge_h, merge_w, C, patch_h, patch_w)
    x = x.permute(1, 4, 2, 5, 0, 3, 6).reshape(
        pad_grid_h * pad_grid_w, 3 * PATCH_SIZE * PATCH_SIZE)
    # temporal duplication (T=2 for still images), feature order (C, T, P, P)
    seq = x.shape[0]
    x = x.reshape(seq, 3, 1, PATCH_SIZE, PATCH_SIZE).expand(
        seq, 3, TEMPORAL_PATCH_SIZE, PATCH_SIZE, PATCH_SIZE)
    x = x.reshape(seq, 3 * TEMPORAL_PATCH_SIZE * PATCH_SIZE * PATCH_SIZE)
    return x.to(out_dtype)


def _cubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """Keys bicubic, a = -0.5 (PIL's BICUBIC filter)."""
    ax = torch.abs(x)
    near = (1.5 * ax - 2.5) * ax * ax + 1.0
    far = ((-0.5 * ax + 2.5) * ax - 4.0) * ax + 2.0
    return torch.where(ax < 1.0, near,
                       torch.where(ax < 2.0, far, torch.zeros_like(ax)))


def _resample_matrix(n_src: int, n_dst: int, src_valid: int, dst_valid: int,
                     device) -> torch.Tensor:
    """(n_src, n_dst) f32 resampling matrix: column j holds the taps of
    output pixel j. PIL's scheme: antialiased support on downscale, taps
    clipped to the valid source range and renormalized."""
    scale = torch.tensor(src_valid, dtype=torch.float32,
                         device=device) / dst_valid
    fscale = torch.clamp(scale, min=1.0)
    centers = (torch.arange(n_dst, dtype=torch.float32, device=device)
               + 0.5) * scale - 0.5
    i = torch.arange(n_src, dtype=torch.float32, device=device)
    w = _cubic_kernel((i[:, None] - centers[None, :]) / fscale)
    w = torch.where(i[:, None] < src_valid, w, torch.zeros_like(w))
    return w / torch.clamp(torch.abs(w.sum(0, keepdim=True)), min=1e-6)


def resize_patchify(src_u8: torch.Tensor, src_h: int, src_w: int, *,
                    grid_h: int, grid_w: int, pad_grid_h: int,
                    pad_grid_w: int, grayscale: bool = False,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Decoded page zero-padded to (src_bucket_h, src_bucket_w, 3) uint8 ->
    pixel_values, on the tensor's device.

    PIL resamples horizontally first and stores the intermediate as uint8;
    both the pass order and the rounding between passes are reproduced."""
    x = src_u8.float()
    dev = x.device
    rh, rw = grid_h * PATCH_SIZE, grid_w * PATCH_SIZE
    wh = _resample_matrix(x.shape[0], pad_grid_h * PATCH_SIZE, src_h, rh, dev)
    ww = _resample_matrix(x.shape[1], pad_grid_w * PATCH_SIZE, src_w, rw, dev)
    # "wt,swc->stc": (s, c, w) @ (w, t) -> (s, c, t)
    y = torch.matmul(x.permute(0, 2, 1), ww).permute(0, 2, 1)
    y = torch.clamp(torch.round(y), 0.0, 255.0)
    # "sd,swc->dwc": (d, s) @ (s, w*c)
    s, w, c = y.shape
    y = torch.matmul(wh.t(), y.reshape(s, w * c)).reshape(-1, w, c)
    y = torch.clamp(torch.round(y), 0.0, 255.0) / 255.0
    return _patchify_core(y, valid_h=rh, valid_w=rw, pad_grid_h=pad_grid_h,
                          pad_grid_w=pad_grid_w, grayscale=grayscale,
                          out_dtype=out_dtype)


def preprocess_host(image: "np.ndarray | object",
                    min_pixels: int = MIN_PIXELS,
                    max_pixels: int = MAX_PIXELS) -> tuple[np.ndarray, ImagePlan]:
    """Resize a decoded image (np array or PIL.Image) per the plan on the
    host with PIL bicubic. Returns (uint8 (resized_h, resized_w, 3), plan).

    Only the ``device_resize=False`` engine path uses this; PIL is imported
    here so the default path does not need it."""
    from PIL import Image

    pil = Image.fromarray(image) if isinstance(image, np.ndarray) else image
    if pil.mode != "RGB":
        pil = pil.convert("RGB")
    plan = plan_image(pil.height, pil.width, min_pixels, max_pixels)
    resized = pil.resize((plan.resized_w, plan.resized_h),
                         Image.Resampling.BICUBIC)
    return np.asarray(resized, dtype=np.uint8), plan
