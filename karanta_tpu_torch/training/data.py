"""Training data pipeline (the port's copy of ``karanta_tpu/training/data.py``):
composable steps, dataset pairing and caching, and a collator that pads
batches to static buckets.

The steps keep the reference's registry and semantics, so configs that list
steps by name keep working. The Tokenizer step emits the engine's tensor
bundle (ids, masked labels, M-RoPE positions, the resized page and its plan);
the collator pads a batch to one sequence bucket and one image grid bucket
and adds the vision layout arrays. Everything stays numpy on the host; the
trainer moves a batch to the device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Any, Optional

import numpy as np

from karanta_tpu_torch.inference.chat import (
    IM_END, IM_START, IMAGE_PAD, VISION_END, VISION_START, expand_image_pads,
)
from karanta_tpu_torch.inference.tokenizer import Tokenizer as TokenizerProto
from karanta_tpu_torch.models.qwen25_vl.config import VisionConfig
from karanta_tpu_torch.models.qwen25_vl.layout import (build_vision_layout,
                                                       mrope_positions)
from karanta_tpu_torch.ops.image_prep import ImagePlan, bucket_side
from karanta_tpu_torch.pdf.anchor import get_anchor_text
from karanta_tpu_torch.pdf.primitives import render_pdf_to_base64png
from karanta_tpu_torch.prompts.templates import load_prompt_template

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100


@dataclasses.dataclass
class SingleDatapoint:
    """One training example flowing through the pipeline steps
    (reference karanta/training/utils.py:44-54)."""

    pdf_path: Optional[str] = None
    json_path: Optional[str] = None
    image: Any = None                      # PIL.Image
    page_data: Any = None                  # list of page dicts
    anchor_text: Optional[str] = None
    instruction_prompt: Optional[str] = None
    user_messages: Any = None
    response: Optional[str] = None
    tensors: Optional[dict] = None         # final model-ready arrays


class PDF2ImageStep:
    """Render page 1 of the sample PDF (reference pipeline_steps.py:32-52)."""

    def __init__(self, target_longest_image_dim: int):
        self.target_longest_image_dim = target_longest_image_dim

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        import base64
        import io

        from PIL import Image

        b64 = render_pdf_to_base64png(
            str(sample.pdf_path), 1,
            target_longest_image_dim=self.target_longest_image_dim)
        sample.image = Image.open(io.BytesIO(base64.b64decode(b64)))
        return sample


class FetchPageData:
    """Ground-truth JSON: {"result": {"text": "<json list>"}}
    (reference pipeline_steps.py:78-87)."""

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        with open(sample.json_path, "r", encoding="utf-8") as f:
            sample.page_data = json.loads(json.loads(f.read())["result"]["text"])
        if isinstance(sample.page_data, dict):
            sample.page_data = [sample.page_data]
        return sample


class FetchMultipageData:
    """Ground-truth JSON: {"generation": {"pages": [...]}}
    (reference pipeline_steps.py:90-99)."""

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        with open(sample.json_path, "r", encoding="utf-8") as f:
            sample.page_data = json.loads(f.read())["generation"]["pages"]
        return sample


class JSONOutputFormat:
    """Target = JSON list of page dicts (reference pipeline_steps.py:55-75)."""

    FIELDS = ("primary_language", "is_rotation_valid", "rotation_correction",
              "is_table", "is_diagram", "natural_text")

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        sample.response = json.dumps(
            [{k: page.get(k) for k in self.FIELDS} for page in sample.page_data],
            ensure_ascii=False)
        return sample


class PlainTextFormat:
    """Target = the page's natural_text only (no JSON envelope). Pages join
    with double newlines. Checkpoints trained this way run end to end
    through the pipeline with --accept_raw_text (runner.parse_model_content
    then wraps the completion as natural_text); the reference always trains
    the JSON envelope (pipeline_steps.py:55-75) — this is the lighter
    variant for small models / plain-text fine-tunes."""

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        sample.response = "\n\n".join(
            (page.get("natural_text") or "") for page in sample.page_data)
        return sample


class StaticLengthDocumentAnchoring:
    """Budgeted anchor text (reference pipeline_steps.py:102-116)."""

    def __init__(self, target_anchor_text_len: int):
        self.target_anchor_text_len = target_anchor_text_len

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        sample.anchor_text = get_anchor_text(
            str(sample.pdf_path), 1, "pdfreport", self.target_anchor_text_len)
        return sample


class FinetuningPrompt:
    """Anchor-aware prompt choice: pages with a usable text layer (>10 anchor
    lines) get the anchored prompt, image-only pages the no-anchor prompt
    (reference pipeline_steps.py:119-148)."""

    def __init__(self, prompt_path: Optional[str] = None):
        self.prompt_path = prompt_path

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        has_anchor = bool(sample.anchor_text
                          and len(sample.anchor_text.split("\n")) > 10)
        if has_anchor:
            template = load_prompt_template("olmo_ocr_system_prompt",
                                            self.prompt_path)
            sample.instruction_prompt = template.render(
                {"base_text": sample.anchor_text})
        else:
            template = load_prompt_template("olmo_ocr_system_prompt_no_anchor",
                                            self.prompt_path)
            sample.instruction_prompt = template.render()
        return sample


class InstructUserMessages:
    """Assemble the user message; image-first by default
    (reference pipeline_steps.py:151-178)."""

    def __init__(self, prompt_first: bool = False):
        self.prompt_first = prompt_first

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        text = {"type": "text", "text": sample.instruction_prompt}
        image = {"type": "image", "image": sample.image}
        content = [text, image] if self.prompt_first else [image, text]
        sample.user_messages = {"role": "user", "content": content}
        return sample


class Tokenizer:
    """ChatML render + tokenize + instruction masking + vision planning.

    Output tensors (all numpy, unpadded seq; collator buckets them):
      input_ids, labels (prompt masked to -100, response + <|im_end|> kept),
      positions (3, S), image_u8 + ImagePlan (when an image is present).
    (reference pipeline_steps.py:181-373 does this through the HF processor.)
    """

    def __init__(self, tokenizer: TokenizerProto,
                 vision_cfg: Optional[VisionConfig] = None,
                 max_length: int = 8192,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280):
        self.tok = tokenizer
        self.vision_cfg = vision_cfg or VisionConfig()
        self.max_length = max_length
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels

    def __call__(self, sample: SingleDatapoint) -> SingleDatapoint:
        from karanta_tpu_torch.inference.chat import DEFAULT_SYSTEM
        from karanta_tpu_torch.ops.image_prep import preprocess_host

        # Same ChatML the serving engine renders (chat.parse_openai_messages),
        # INCLUDING the default system block — Qwen's chat template inserts it
        # when no system message is given, so both the reference's HF-processor
        # training path and our server see it. Omitting it here would train a
        # prompt distribution the server never serves (found by the closed-loop
        # demo: greedy decode garbled the memorized response scaffold).
        parts = [f"{IM_START}system\n{DEFAULT_SYSTEM}{IM_END}\n",
                 f"{IM_START}user\n"]
        image_arr = None
        plan: Optional[ImagePlan] = None
        for item in sample.user_messages["content"]:
            if item["type"] == "text":
                parts.append(item["text"])
            elif item["type"] == "image":
                image_arr, plan = preprocess_host(
                    item["image"], self.min_pixels, self.max_pixels)
                parts.append(f"{VISION_START}{IMAGE_PAD}{VISION_END}")
        parts.append(f"{IM_END}\n{IM_START}assistant\n")
        prompt_text = "".join(parts)

        prompt_ids = self.tok.encode(prompt_text)
        if plan is not None:
            prompt_ids = expand_image_pads(
                prompt_ids, self.tok.image_pad_id, [plan.num_merged_tokens])
        response_ids = self.tok.encode(sample.response or "")
        response_ids = response_ids + [self.tok.eos_token_id]

        ids = (prompt_ids + response_ids)[: self.max_length]
        labels = ([IGNORE_INDEX] * len(prompt_ids) + response_ids)[: self.max_length]

        grids = [plan.grid_thw] if plan is not None else []
        positions = mrope_positions(np.asarray(ids), grids,
                                    self.tok.image_pad_id,
                                    self.vision_cfg.spatial_merge_size)
        tensors = {
            "input_ids": np.asarray(ids, np.int32),
            "labels": np.asarray(labels, np.int32),
            "positions": positions,
            "plan": plan,
        }
        if image_arr is not None:
            tensors["image_u8"] = image_arr
            if self.tok.image_pad_id in prompt_ids:
                tensors["image_start"] = np.asarray(
                    prompt_ids.index(self.tok.image_pad_id), np.int32)
        sample.tensors = tensors
        return sample


str2PipelineStep = {
    "PDF2ImageStep": PDF2ImageStep,
    "JSONOutputFormat": JSONOutputFormat,
    "PlainTextFormat": PlainTextFormat,
    "FetchPageData": FetchPageData,
    "FetchMultipageData": FetchMultipageData,
    "StaticLengthDocumentAnchoring": StaticLengthDocumentAnchoring,
    "FinetuningPrompt": FinetuningPrompt,
    "InstructUserMessages": InstructUserMessages,
    "Tokenizer": Tokenizer,
}


def build_pipeline(step_specs: list, **shared_kwargs) -> list:
    """Instantiate steps from config: [{"name": ..., **kwargs}, ...] or
    ["StepName", ...]. `shared_kwargs` supplies objects (tokenizer, vision
    config) that YAML can't express."""
    steps = []
    for spec in step_specs:
        if isinstance(spec, str):
            name, kwargs = spec, {}
        else:
            spec = dict(spec)
            name = spec.pop("name")
            kwargs = spec
        cls = str2PipelineStep[name]
        import inspect

        accepted = set(inspect.signature(cls.__init__).parameters)
        extra = {k: v for k, v in shared_kwargs.items() if k in accepted}
        steps.append(cls(**kwargs, **extra))
    return steps


def pair_pdf_json(pdf_dir: str | Path, json_dir: str | Path
                  ) -> list[tuple[str, str]]:
    """Pair <stem>.pdf with <stem>.json (reference data.py:55-73)."""
    pdf_dir, json_dir = Path(pdf_dir), Path(json_dir)
    pairs = []
    for json_file in sorted(json_dir.glob("*.json")):
        pdf_file = pdf_dir / (json_file.stem + ".pdf")
        if pdf_file.exists():
            pairs.append((str(pdf_file), str(json_file)))
    return pairs


def pipeline_fingerprint(step_specs: list, extra: dict | None = None) -> str:
    """md5 of the pipeline config — the dataset cache key
    (reference data.py:101-105)."""
    blob = json.dumps({"steps": step_specs, "extra": extra or {}},
                      sort_keys=True, default=str)
    return hashlib.md5(blob.encode()).hexdigest()


class LocalDataset:
    """Processed local dataset of (pdf, json) pairs with on-disk caching."""

    def __init__(self, root_dir: str, pdf_dir_name: str = "pdfs",
                 json_dir_name: str = "json", pipeline_steps: list = (),
                 cache_dir: Optional[str] = None,
                 tokenizer: Optional[TokenizerProto] = None,
                 vision_cfg: Optional[VisionConfig] = None,
                 max_length: int = 8192):
        self.root = Path(root_dir)
        self.pairs = pair_pdf_json(self.root / pdf_dir_name,
                                   self.root / json_dir_name)
        self.step_specs = list(pipeline_steps)
        self.steps = build_pipeline(
            self.step_specs, tokenizer=tokenizer, vision_cfg=vision_cfg,
            max_length=max_length)
        self.cache_dir = cache_dir
        self._samples: Optional[list[dict]] = None

    def _cache_path(self) -> Optional[Path]:
        if not self.cache_dir:
            return None
        fp = pipeline_fingerprint(self.step_specs, {"n": len(self.pairs)})
        return Path(self.cache_dir) / f"dataset_{fp}.npz.d"

    def _process_pair(self, pair: tuple[str, str]) -> Optional[dict]:
        pdf_path, json_path = pair
        sample = SingleDatapoint(pdf_path=pdf_path, json_path=json_path)
        try:
            for step in self.steps:
                sample = step(sample)
        except Exception:
            logger.exception("sample failed: %s", pdf_path)
            return None
        return sample.tensors

    def build(self, num_workers: int = 4) -> list[dict]:
        """Process all pairs (thread-parallel: rendering/PIL dominate and
        release the GIL — the reference maps with num_proc=4,
        data.py:168-176)."""
        if self._samples is not None:
            return self._samples
        cache = self._cache_path()
        if cache and cache.exists():
            logger.info("loading dataset cache %s", cache)
            self._samples = _load_cache(cache)
            return self._samples

        if num_workers > 1 and len(self.pairs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_workers) as pool:
                results = list(pool.map(self._process_pair, self.pairs))
        else:
            results = [self._process_pair(pair) for pair in self.pairs]
        samples = [r for r in results if r is not None]
        self._samples = samples
        if cache:
            _save_cache(cache, samples)
        return samples

    def __len__(self) -> int:
        return len(self.pairs)


def _save_cache(path: Path, samples: list[dict]) -> None:
    path.mkdir(parents=True, exist_ok=True)
    meta = []
    for i, s in enumerate(samples):
        arrays = {k: v for k, v in s.items()
                  if isinstance(v, np.ndarray)}
        np.savez_compressed(path / f"sample_{i}.npz", **arrays)
        meta.append({"plan": dataclasses.asdict(s["plan"]) if s.get("plan")
                     else None})
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f)


def _load_cache(path: Path) -> list[dict]:
    with open(path / "meta.json") as f:
        meta = json.load(f)
    samples = []
    for i, m in enumerate(meta):
        data = dict(np.load(path / f"sample_{i}.npz"))
        data["plan"] = ImagePlan(**m["plan"]) if m["plan"] else None
        samples.append(data)
    return samples


# 512-step ladder to 4096, 1024-step above: a training run pins ONE bucket
# (fit_buckets/fixed_seq), so ladder granularity sets the padding waste —
# a 2540-token dataset pads 1.3% to 2560 vs 61% to a power-of-two 4096.
# the flash kernel takes any S, so every rung is kernel-legal.
SEQ_BUCKETS = (128, 256, 384, 512, 1024, 1536, 2048, 2560, 3072, 3584, 4096,
               5120, 6144, 7168, 8192)


class DataCollator:
    """Pad a list of sample tensors into one static-bucket batch
    (reference data.py:201-283, re-shaped for our model's inputs)."""

    def __init__(self, vision_cfg: Optional[VisionConfig] = None,
                 seq_buckets: tuple[int, ...] = SEQ_BUCKETS,
                 pad_token_id: int = 0,
                 fixed_grid: Optional[tuple[int, int]] = None,
                 fixed_seq: Optional[int] = None):
        """fixed_grid/fixed_seq pin the batch buckets for a whole training run
        (one compiled step; n_windows stays static across batches)."""
        self.vision_cfg = vision_cfg or VisionConfig()
        self.seq_buckets = seq_buckets
        self.pad_token_id = pad_token_id
        self.fixed_grid = fixed_grid
        self.fixed_seq = fixed_seq

    @staticmethod
    def fit_buckets(samples: list[dict],
                    seq_buckets=SEQ_BUCKETS
                    ) -> tuple[tuple[int, int], int]:
        """(grid bucket, seq bucket) covering every sample in a dataset."""
        gh = gw = 0
        max_len = 1
        for s in samples:
            plan = s.get("plan")
            if plan is not None:
                gh = max(gh, bucket_side(plan.grid_h))
                gw = max(gw, bucket_side(plan.grid_w))
            max_len = max(max_len, len(s["input_ids"]))
        seq = next(b for b in seq_buckets if b >= max_len)
        return (gh, gw), seq

    def __call__(self, samples: list[dict]) -> dict:
        import torch

        from karanta_tpu_torch.ops.image_prep import patchify

        batch = len(samples)
        max_len = max(len(s["input_ids"]) for s in samples)
        seq = self.fixed_seq or next(b for b in self.seq_buckets if b >= max_len)

        ids = np.full((batch, seq), self.pad_token_id, np.int32)
        labels = np.full((batch, seq), IGNORE_INDEX, np.int32)
        positions = np.zeros((3, batch, seq), np.int32)
        attn_mask = np.zeros((batch, seq), np.float32)
        for i, s in enumerate(samples):
            n = len(s["input_ids"])
            ids[i, :n] = s["input_ids"]
            labels[i, :n] = s["labels"]
            positions[:, i, :n] = s["positions"]
            attn_mask[i, :n] = 1.0

        out = {"token_ids": ids, "labels": labels, "positions": positions,
               "attn_mask": attn_mask}

        plans = [s.get("plan") for s in samples]
        if any(p is not None for p in plans):
            # common static grid bucket across the batch (or run-wide pin)
            if self.fixed_grid:
                gh, gw = self.fixed_grid
            else:
                gh = max(bucket_side(p.grid_h) for p in plans if p)
                gw = max(bucket_side(p.grid_w) for p in plans if p)
            merge = self.vision_cfg.spatial_merge_size
            n_img_bucket = (gh // merge) * (gw // merge)
            pix = np.zeros(
                (batch, gh * gw, self.vision_cfg.patch_input_dim), np.float32)
            perm = np.zeros((batch, gh * gw), np.int32)
            valid = np.zeros((batch, gh * gw), np.float32)
            pos_hw = np.zeros((batch, gh * gw, 2), np.int32)
            extract = np.zeros((batch, n_img_bucket), np.int32)
            img_positions = np.full((batch, n_img_bucket), seq, np.int32)
            n_windows = ((gh // self.vision_cfg.window_patches)
                         * (gw // self.vision_cfg.window_patches))

            for i, (s, plan) in enumerate(zip(samples, plans)):
                if plan is None:
                    continue
                padded_plan = ImagePlan(plan.resized_h, plan.resized_w,
                                        plan.grid_h, plan.grid_w, gh, gw)
                layout = build_vision_layout(padded_plan, self.vision_cfg)
                pv = patchify(torch.from_numpy(np.array(s["image_u8"])),
                              grid_h=plan.grid_h, grid_w=plan.grid_w,
                              pad_grid_h=gh, pad_grid_w=gw,
                              out_dtype=torch.float32)
                pix[i] = pv.numpy()
                perm[i] = layout.perm
                valid[i] = layout.valid
                pos_hw[i] = layout.pos_hw
                n_merged = layout.num_merged
                extract[i, :n_merged] = layout.extract
                start = s.get("image_start")
                if start is None:
                    continue
                start = int(start)
                img_positions[i, :n_merged] = np.arange(start, start + n_merged)

            out.update({
                "pixel_values": pix, "vis_perm": perm, "vis_valid": valid,
                "vis_pos_hw": pos_hw, "vis_extract": extract,
                "image_positions": img_positions,
            })
            out["n_windows"] = n_windows
        return out
