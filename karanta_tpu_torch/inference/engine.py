"""Serving engine: multimodal prefill + slot-based batched decode (port of
``karanta_tpu/inference/engine.py``, the page-OCR path).

- A fixed batch of decode slots (continuous batching). Each request is
  prefilled on its own (vision encoder, embedding merge, causal prefill,
  first token) and its KV rows are quantized into a free slot of the int8
  cache; all active slots then decode together, ``decode_chunk`` steps per
  host round trip. Finished slots keep cycling harmlessly inside a chunk.
- Prompt lengths and image token counts are padded to the same buckets as
  the JAX engine, so both run the same shapes and produce the same tokens.
- Temperature 0 is exact greedy.

Features of the JAX engine that this slice does not port raise
``NotImplementedError`` when requested: n-gram speculation, prefix caching,
the int4 and bf16 KV caches, teacher forcing, batched prefill, vision
quantization, guided decoding and logprobs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.inference import chat
from karanta_tpu_torch.inference.sampling import sample_tokens
from karanta_tpu_torch.inference.tokenizer import Tokenizer
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.models.qwen25_vl import vision as vis
from karanta_tpu_torch.models.qwen25_vl.config import VLMConfig
from karanta_tpu_torch.models.qwen25_vl.layout import (build_vision_layout,
                                                       mrope_positions)
from karanta_tpu_torch.models.qwen25_vl.model import merge_image_embeddings
from karanta_tpu_torch.ops.image_prep import (patchify, plan_image,
                                              preprocess_host,
                                              resize_patchify, src_px_bucket)
from karanta_tpu_torch.ops.png import decode_png_rgb
from karanta_tpu_torch.ops.quantization import (is_quantized,
                                                quantize_decoder_params)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch_size: int = 8
    max_seq_len: int = 8192              # KV cache length per slot
    decode_chunk: int = 32               # decode steps per host round trip
    prefill_buckets: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192)
    image_token_buckets: tuple[int, ...] = (256, 512, 1024, 2048)
    max_output_tokens: int = 4000
    min_pixels: int = 56 * 56
    max_pixels: int = 14 * 14 * 4 * 1280
    dtype: Any = torch.bfloat16
    quantize: Optional[str] = None       # None | "int8" (decoder weights)
    kv_quantize: Optional[str] = None    # only "int8" is ported
    act_quant: Optional[str] = None      # None | "int8": W8A8 prefill + head
    vision_quant: Optional[str] = None   # not ported
    prefix_cache: bool = False           # not ported
    prefix_min_tokens: int = 256
    prefix_cache_entries: int = 4
    prefill_batch: int = 1               # only 1 is ported
    device_resize: bool = True           # resize pages on the device
    speculative_ngram: int = 0           # not ported
    teacher_force: bool = False          # not ported


@dataclasses.dataclass
class GenRequest:
    messages: list[dict]                 # OpenAI chat format
    max_tokens: int = 4000
    temperature: float = 0.0
    top_p: float = 1.0
    request_id: str = ""
    guided_regex: Optional[str] = None   # not ported: raises
    logprobs: bool = False               # not ported: raises
    top_logprobs: int = 0
    speculative: Optional[bool] = None
    raw_images: Optional[list] = None
    forced_output: Optional[str] = None


@dataclasses.dataclass
class GenResult:
    request_id: str
    text: str
    token_ids: list[int]
    finish_reason: str                   # "stop" | "length"
    prompt_tokens: int
    completion_tokens: int
    latency_s: float = 0.0
    logprobs: Optional[list] = None


@dataclasses.dataclass
class _Prepared:
    ids: np.ndarray                      # (S,) int32 prompt token ids
    positions: np.ndarray                # (3, S) int32 mrope positions
    image_feeds: list[dict]              # per image: pixels + layout
    img_token_counts: list[int]
    max_tokens: int
    temperature: float
    top_p: float
    request_id: str


class ContextLengthError(ValueError):
    """Prompt does not fit the engine's context window."""


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def _reject_unported(ecfg: EngineConfig) -> None:
    if ecfg.quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {ecfg.quantize!r}")
    if ecfg.act_quant not in (None, "int8"):
        raise ValueError(f"unknown act_quant {ecfg.act_quant!r}")
    unported = []
    if ecfg.speculative_ngram > 0:
        unported.append("speculative_ngram > 0 (needs the "
                        "paged_decode_append_multi_quant kernel)")
    if ecfg.prefix_cache:
        unported.append("prefix_cache")
    if ecfg.kv_quantize != "int8":
        unported.append(f"kv_quantize={ecfg.kv_quantize!r} (only the int8 "
                        f"KV cache is ported)")
    if ecfg.teacher_force:
        unported.append("teacher_force")
    if ecfg.prefill_batch > 1:
        unported.append("prefill_batch > 1")
    if ecfg.vision_quant:
        unported.append("vision_quant")
    if unported:
        raise NotImplementedError("not ported yet: " + "; ".join(unported))


class Engine:
    """Single-card serving engine over the port's kernels."""

    def __init__(self, params: Any, cfg: VLMConfig, tokenizer: Tokenizer,
                 engine_cfg: EngineConfig = EngineConfig(), rng_seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        _reject_unported(engine_cfg)
        if self.device.type == "cuda":
            # float32 products (the page resize) must not round to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if engine_cfg.quantize == "int8":
            params = {**params,
                      "text": quantize_decoder_params(params["text"])}
        if engine_cfg.act_quant and not is_quantized(
                params["text"]["layers"]["attn"]["wq"]):
            raise ValueError("act_quant requires int8 decoder weights (set "
                             "quantize='int8' or pass pre-quantized params)")
        self._act_quant = bool(engine_cfg.act_quant)
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        # prefill buckets must fit the KV cache; the full context is a bucket
        engine_cfg = dataclasses.replace(
            engine_cfg,
            prefill_buckets=tuple(sorted(
                {b for b in engine_cfg.prefill_buckets
                 if b <= engine_cfg.max_seq_len} | {engine_cfg.max_seq_len})),
            image_token_buckets=tuple(sorted(
                {b for b in engine_cfg.image_token_buckets
                 if b <= engine_cfg.max_seq_len} | {engine_cfg.max_seq_len})))
        self.ecfg = engine_cfg

        b, m = engine_cfg.max_batch_size, engine_cfg.max_seq_len
        dev = self.device
        self.cache = dec.QuantKVCache.zeros(cfg.text, b, m, engine_cfg.dtype,
                                            dev)
        self.cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.next_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.last_token = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.slot_free = [True] * b
        self._slot_temp = [0.0] * b
        self._slot_top_p = [1.0] * b
        self._gen = torch.Generator(device=dev).manual_seed(rng_seed)

    # ------------------------------------------------------------------

    def _decode_image(self, raw: bytes) -> np.ndarray:
        """Image bytes -> RGB uint8. PNG goes through the port's own decoder;
        other formats need PIL on the host."""
        if raw[:8] == b"\x89PNG\r\n\x1a\n":
            return decode_png_rgb(raw)
        import io

        from PIL import Image

        pil = Image.open(io.BytesIO(raw))
        return np.asarray(pil.convert("RGB"), np.uint8)

    def prepare(self, request: GenRequest) -> _Prepared:
        """Host-side request preparation: chat template, image decode and
        on-device resize/patchify, layout planning, token ids, positions."""
        if request.guided_regex:
            raise NotImplementedError("guided decoding is not ported yet")
        if request.logprobs or request.top_logprobs:
            raise NotImplementedError("logprobs are not ported yet")
        parsed = chat.parse_openai_messages(request.messages,
                                            raw_images=request.raw_images)
        dtype = self.ecfg.dtype
        image_feeds, img_token_counts, grids = [], [], []
        for raw in parsed.images:
            rgb = self._decode_image(raw)
            img_h, img_w = rgb.shape[:2]
            sbh = src_px_bucket(img_h) if self.ecfg.device_resize else None
            sbw = src_px_bucket(img_w) if self.ecfg.device_resize else None
            if sbh is not None and sbw is not None:
                plan = plan_image(img_h, img_w, self.ecfg.min_pixels,
                                  self.ecfg.max_pixels)
                src = np.zeros((sbh, sbw, 3), np.uint8)
                src[:img_h, :img_w] = rgb
                pix = resize_patchify(
                    torch.from_numpy(src).to(self.device), img_h, img_w,
                    grid_h=plan.grid_h, grid_w=plan.grid_w,
                    pad_grid_h=plan.pad_grid_h, pad_grid_w=plan.pad_grid_w,
                    out_dtype=dtype)
            else:
                arr, plan = preprocess_host(rgb, self.ecfg.min_pixels,
                                            self.ecfg.max_pixels)
                pix = patchify(torch.tensor(arr, device=self.device),
                               grid_h=plan.grid_h, grid_w=plan.grid_w,
                               pad_grid_h=plan.pad_grid_h,
                               pad_grid_w=plan.pad_grid_w, out_dtype=dtype)
            layout = build_vision_layout(plan, self.cfg.vision)
            n_pad = _bucket(layout.num_merged, self.ecfg.image_token_buckets)
            extract = np.zeros((n_pad,), np.int64)
            extract[: layout.num_merged] = layout.extract
            image_feeds.append(dict(plan=plan, layout=layout, n_pad=n_pad,
                                    extract=extract, pix_dev=pix))
            img_token_counts.append(layout.num_merged)
            grids.append(plan.grid_thw)

        ids = self.tok.encode(parsed.text)
        ids = chat.expand_image_pads(ids, self.tok.image_pad_id,
                                     img_token_counts)
        ids = np.asarray(ids, np.int32)
        positions = mrope_positions(ids, grids, self.tok.image_pad_id,
                                    self.cfg.vision.spatial_merge_size)
        if len(ids) >= self.ecfg.max_seq_len:
            raise ContextLengthError(
                f"prompt is {len(ids)} tokens but the maximum context length "
                f"is {self.ecfg.max_seq_len} (>=1 output token required)")
        return _Prepared(ids=ids, positions=positions, image_feeds=image_feeds,
                         img_token_counts=img_token_counts,
                         max_tokens=request.max_tokens,
                         temperature=request.temperature, top_p=request.top_p,
                         request_id=request.request_id)

    def prefill(self, prepared: _Prepared):
        """Vision encode + embedding merge + causal prefill of one request.
        Returns (last-position logits (V,), the prompt's KV rows padded to
        its prefill bucket)."""
        dev, text = self.device, self.params["text"]
        s = len(prepared.ids)
        s_pad = _bucket(s, self.ecfg.prefill_buckets)
        ids = torch.zeros((s_pad,), dtype=torch.int64)
        ids[:s] = torch.from_numpy(prepared.ids.astype(np.int64))
        positions = torch.zeros((3, s_pad), dtype=torch.int32)
        positions[:, :s] = torch.from_numpy(prepared.positions)
        kv_mask = torch.zeros((s_pad,), dtype=torch.float32)
        kv_mask[:s] = 1.0

        emb = dec.embed_tokens(text, ids.to(dev))
        img_pos_all = np.flatnonzero(prepared.ids == self.tok.image_pad_id)
        offset = 0
        for feed in prepared.image_feeds:
            layout = feed["layout"]
            encoded = vis.encode_image(
                self.params["visual"], self.cfg.vision, feed["pix_dev"],
                torch.from_numpy(layout.perm).to(dev),
                torch.from_numpy(layout.valid).to(dev),
                torch.from_numpy(layout.pos_hw).to(dev))
            tokens = encoded[torch.from_numpy(feed["extract"]).to(dev)]
            pos = np.full((feed["n_pad"],), s_pad, np.int64)
            pos[: layout.num_merged] = img_pos_all[
                offset:offset + layout.num_merged]
            emb = merge_image_embeddings(emb, tokens,
                                         torch.from_numpy(pos).to(dev))
            offset += layout.num_merged

        hidden, pcache = dec.prefill_forward(
            text, self.cfg.text, emb[None], positions[:, None, :].to(dev),
            kv_mask=kv_mask[None].to(dev), act_quant=self._act_quant)
        logits = dec.logits_from_hidden(text, self.cfg.text, hidden[0, s - 1],
                                        act_quant=self._act_quant)
        return logits, pcache

    def prefill_insert(self, slot: int, prepared: _Prepared) -> torch.Tensor:
        """Prefill a request, pick its first token, and quantize its KV rows
        into `slot` of the int8 cache (in place). Returns the first token as
        a device scalar."""
        dev = self.device
        s = len(prepared.ids)
        logits, pcache = self.prefill(prepared)
        for feed in prepared.image_feeds:
            feed["pix_dev"] = None  # the page's pixels are no longer needed
        s_pad = pcache.k.shape[3]
        if prepared.temperature <= 0.0:
            first = torch.argmax(logits.float(), dim=-1)
        else:
            first = sample_tokens(
                logits[None], self._gen,
                torch.tensor([prepared.temperature], device=dev),
                torch.tensor([prepared.top_p], device=dev))[0]

        kq, ksc = dec.quantize_kv_rows(pcache.k[:, 0])
        vq, vsc = dec.quantize_kv_rows(pcache.v[:, 0])
        c = self.cache
        c.k[:, slot, :, :s_pad] = kq
        c.v[:, slot, :, :s_pad] = vq
        c.ks[:, slot, :, :s_pad] = ksc.to(c.ks.dtype)
        c.vs[:, slot, :, :s_pad] = vsc.to(c.vs.dtype)
        self.cache_len[slot] = s
        self.next_pos[slot] = int(prepared.positions.max()) + 1 if s else 0
        self.last_token[slot] = first
        self.temps[slot] = float(prepared.temperature)
        self.top_ps[slot] = float(prepared.top_p)
        self.slot_free[slot] = False
        self._slot_temp[slot] = float(prepared.temperature)
        self._slot_top_p[slot] = float(prepared.top_p)
        return first

    def decode_chunk(self, steps: Optional[int] = None,
                     logits_out: Optional[list] = None) -> np.ndarray:
        """K decode steps for every slot; returns (K, B) tokens on the host.
        With `logits_out`, each step's (B, V) logits are appended to it."""
        steps = steps or self.ecfg.decode_chunk
        m = self.ecfg.max_seq_len
        active = [i for i, free in enumerate(self.slot_free) if not free]
        use_sampling = any(self._slot_temp[i] > 0.0 for i in active)
        use_top_p = use_sampling and any(self._slot_top_p[i] < 1.0
                                         for i in active)
        text = self.params["text"]
        out = []
        for _ in range(steps):
            emb = dec.embed_tokens(text, self.last_token)[:, None]
            pos = self.next_pos[None, :].expand(3, -1)
            hidden, self.cache = dec.decode_step(
                text, self.cfg.text, emb, pos, self.cache,
                torch.clamp(self.cache_len, max=m - 1))
            logits = dec.logits_from_hidden(text, self.cfg.text, hidden[:, 0],
                                            act_quant=self._act_quant)
            if logits_out is not None:
                logits_out.append(logits)
            tokens = sample_tokens(logits, self._gen,
                                   self.temps if use_sampling else None,
                                   self.top_ps if use_top_p else None)
            self.cache_len = torch.clamp(self.cache_len + 1, max=m - 1)
            self.next_pos = self.next_pos + 1
            self.last_token = tokens
            out.append(tokens)
        return torch.stack(out).cpu().numpy()

    def free_slot(self, slot: int) -> None:
        self.slot_free[slot] = True

    # ------------------------------------------------------------------

    def generate(self, requests: list[GenRequest]) -> list[GenResult]:
        """Synchronous batch generation over the decode slots."""
        results: dict[int, GenResult] = {}
        pending = list(enumerate(requests))
        active: dict[int, list] = {}  # slot -> [req_idx, prepared, tokens, t0]
        while pending or active:
            wave = []
            while pending and any(self.slot_free):
                req_idx, request = pending.pop(0)
                start = time.time()
                prepared = self.prepare(request)
                # keep prompt + completion within the cache
                prepared.max_tokens = min(
                    prepared.max_tokens,
                    max(1, self.ecfg.max_seq_len - len(prepared.ids) - 1))
                slot = self.slot_free.index(True)
                first = self.prefill_insert(slot, prepared)
                wave.append((req_idx, prepared, slot, start, first))
            for req_idx, prepared, slot, start, first in wave:
                first_host = int(first)
                collected = [first_host]
                if (first_host == self.tok.eos_token_id
                        or prepared.max_tokens <= 1):
                    reason = ("stop" if first_host == self.tok.eos_token_id
                              else "length")
                    results[req_idx] = self._finish(prepared, collected,
                                                    reason, start)
                    self.free_slot(slot)
                else:
                    active[slot] = [req_idx, prepared, collected, start]
            if not active:
                continue
            toks = self.decode_chunk()
            for slot in list(active):
                req_idx, prepared, collected, start = active[slot]
                finished = None
                for token in toks[:, slot]:
                    collected.append(int(token))
                    if token == self.tok.eos_token_id:
                        finished = "stop"
                        break
                    if len(collected) >= prepared.max_tokens:
                        finished = "length"
                        break
                if finished:
                    results[req_idx] = self._finish(prepared, collected,
                                                    finished, start)
                    del active[slot]
                    self.free_slot(slot)
        return [results[i] for i in range(len(requests))]

    def _finish(self, prepared: _Prepared, collected: list[int], reason: str,
                start: float) -> GenResult:
        out_ids = [t for t in collected if t != self.tok.eos_token_id]
        return GenResult(request_id=prepared.request_id,
                         text=self.tok.decode(out_ids), token_ids=out_ids,
                         finish_reason=reason,
                         prompt_tokens=int(len(prepared.ids)),
                         completion_tokens=len(collected),
                         latency_s=time.time() - start)
