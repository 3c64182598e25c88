"""Serving engine: multimodal prefill + slot-based batched decode (port of
``karanta_tpu/inference/engine.py``).

- A fixed batch of decode slots (continuous batching). Each request is
  prefilled on its own (vision encoder, embedding merge, causal prefill,
  first token) and its KV rows go into a free slot of the KV cache: int8
  rows with per-row scales (``kv_quantize="int8"``), nibble-packed int4 rows
  (``kv_quantize="int4"``, the capacity point: half the int8 cache's memory)
  or rows in the activations' dtype (``kv_quantize=None``, the bf16 cache on
  the card).
  All active slots then decode together, ``decode_chunk`` steps per host
  round trip. Finished slots keep cycling harmlessly inside a chunk.
- n-gram speculation (``speculative_ngram`` = gamma > 0): each verify pass
  drafts gamma tokens per slot from the slot's own history and checks them
  with one T = gamma + 1 token forward (``decoder.decode_multi``). Exact for
  greedy rows; sampled rows verify by rejection sampling. A wave speculates
  when most of its requests vote for it (``GenRequest.speculative``).
- Prefix caching (``prefix_cache``): prompts that share a long instruction
  head reuse its KV rows, built once; prefill then runs only the suffix.
- Prompt lengths and image token counts are padded to the same buckets as
  the JAX engine, so both run the same shapes and produce the same tokens.
- Temperature 0 is exact greedy.
- Guided decoding (``GenRequest.guided_regex``): each regex compiles on the
  host (``guided.py``) into a token automaton whose ``allowed`` and
  ``next_state`` tables live on the device in one state arena shared by
  every resident regex (row 0 is the FREE state of unguided slots); each
  decode step masks the logits by ``allowed[dfa_state]`` and advances
  ``dfa_state`` through ``next_state``.
- Logprobs (``GenRequest.logprobs``, ``top_logprobs`` up to 5): the chosen
  token's log-softmax and the top-k alternatives per emitted token.
- Teacher forcing (``EngineConfig.teacher_force``, bench-only): a request's
  ``forced_output`` overrides the token the model emitted at each position,
  while every step still runs the full decode or verify compute.

Features of the JAX engine that the port does not have yet raise
``NotImplementedError`` when requested: batched prefill and vision
quantization.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Optional, Sequence

import numpy as np
import torch

from karanta_tpu_torch.device import DeviceLike, resolve_device
from karanta_tpu_torch.inference import chat
from karanta_tpu_torch.inference.guided import (build_token_automaton,
                                                closed_free_states,
                                                token_bytes_from_tokenizer)
from karanta_tpu_torch.inference.sampling import (sample_tokens,
                                                  spec_verify_sampled)
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
    kv_quantize: Optional[str] = None    # None (cache in dtype) | "int8"
    #                                      | "int4" (nibble-packed)
    act_quant: Optional[str] = None      # None | "int8": W8A8 prefill, head
    #                                      and speculative verify pass
    vision_quant: Optional[str] = None   # not ported
    prefix_cache: bool = False           # reuse a shared prompt head's KV
    prefix_min_tokens: int = 256         # LCP gate of the prefix cache
    prefix_cache_entries: int = 4
    prefill_batch: int = 1               # only 1 is ported
    device_resize: bool = True           # resize pages on the device
    speculative_ngram: int = 0           # drafted tokens per verify pass
    # bench-only hook: honour GenRequest.forced_output. Each step still runs
    # the full decode or verify compute; the emitted token is replaced on
    # the device by the request's forced stream at that position, so page
    # throughput and speculative acceptance can be measured under real
    # output-text statistics with random weights
    teacher_force: bool = False


@dataclasses.dataclass
class GenRequest:
    messages: list[dict]                 # OpenAI chat format
    max_tokens: int = 4000
    temperature: float = 0.0
    top_p: float = 1.0
    request_id: str = ""
    guided_regex: Optional[str] = None
    logprobs: bool = False               # return per-token logprobs
    top_logprobs: int = 0                # 0..5 alternatives per position
    speculative: Optional[bool] = None   # per-request speculation vote
    raw_images: Optional[list] = None
    # teacher forcing (EngineConfig.teacher_force): the completion text this
    # request must emit; ignored unless the engine enables the hook
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
    # when requested: per emitted token, (logprob, [(alt_id, alt_lp) x k])
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
    prefix_len: int = 0                  # shared-prefix tokens (0 = no reuse)
    speculative: Optional[bool] = None   # per-request speculation vote
    guide: Optional[int] = None          # DFA start state, bound at prefill
    guide_regex: Optional[str] = None    # requested constraint (unbound)
    logprobs: bool = False
    top_logprobs: int = 0
    forced_tokens: Optional[np.ndarray] = None  # teacher-forcing stream


class ContextLengthError(ValueError):
    """Prompt does not fit the engine's context window."""


class GuidedRegexBusy(RuntimeError):
    """The state arena is full of other regexes with live slots. Callers hold
    the request until one drains; the constraint is never dropped."""


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
    if ecfg.kv_quantize not in (None, "int8", "int4"):
        raise ValueError(f"unknown kv_quantize {ecfg.kv_quantize!r}")
    unported = []
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
        if engine_cfg.kv_quantize == "int8":
            self.cache = dec.QuantKVCache.zeros(cfg.text, b, m,
                                                engine_cfg.dtype, dev)
        elif engine_cfg.kv_quantize == "int4":
            # the JAX engine's limits (its engine.py:283-297), so that both
            # engines take the same configurations
            if engine_cfg.speculative_ngram > 0 and m < 128:
                raise ValueError(
                    "kv_quantize='int4' speculation needs max_seq_len >= 128 "
                    "(the multi-token kernel's slab spans two 64-token "
                    "windows)")
            if m >= 256 and m % 256:
                # a TPU tile rule of the JAX kernels (a scale slab is 128
                # packed rows); the CUDA kernels need only whole windows,
                # but the port keeps the rule so both engines agree
                raise ValueError(
                    f"kv_quantize='int4' needs max_seq_len % 256 == 0 "
                    f"(nibble packing: 128 packed rows per scale tile), "
                    f"got {m}; round up to {-(-m // 256) * 256}")
            self.cache = dec.Q4KVCache.zeros(cfg.text, b, m,
                                             engine_cfg.dtype, dev)
        else:
            self.cache = dec.KVCache.zeros(cfg.text, b, m, engine_cfg.dtype,
                                           dev)
        self.cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.next_pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.last_token = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.slot_free = [True] * b
        self._slot_temp = [0.0] * b
        self._slot_top_p = [1.0] * b
        # per-slot speculation votes (a None hint counts as yes)
        self._slot_spec = [True] * b
        # host mirror of each slot's cache_len: the lookahead's headroom
        self._slot_len = [0] * b
        self._gen = torch.Generator(device=dev).manual_seed(rng_seed)

        # guided decoding: the token automatons of every resident regex in
        # one state arena on the device. Row 0 is FREE (unguided slots: all
        # tokens, self-loop); automaton a occupies rows [offset_a, offset_a
        # + n_a) with its next-state values pre-offset, so a slot's
        # dfa_state indexes the arena directly and slots with different
        # regexes decode in one wave
        vocab = cfg.text.vocab_size
        self.dfa_state = torch.zeros((b,), dtype=torch.int64, device=dev)
        self._allowed = torch.ones((1, vocab), dtype=torch.bool, device=dev)
        self._next_state = torch.zeros((1, vocab), dtype=torch.int32,
                                       device=dev)
        # arena rows where masking is a no-op forever (speculation-safe)
        self._free_state_mask = np.ones((1,), bool)
        self._arena: "OrderedDict[str, dict]" = OrderedDict()
        self._arena_used = 1               # row 0 is the shared FREE state
        self._automaton_cache: "OrderedDict[str, Any]" = OrderedDict()
        self._token_bytes: Optional[list] = None  # lazy: a walk of the vocab
        self._automaton_lock = threading.Lock()
        self._slot_regex: list = [None] * b
        # host mirror of which slots are guided: gates the per-step mask
        self._slot_guided = [False] * b
        # logprobs: each slot's top-k when it asked for logprobs (None when
        # not), the last collected chunk's (chosen, top values, top ids),
        # and each request's first token's
        self._slot_lp_k: list = [None] * b
        self._last_logprobs = None
        self._first_logprob: dict = {}
        # teacher forcing (bench-only): per-slot forced streams indexed by
        # history position (prompt at 0..len-1, first emitted token at len);
        # -1 = unforced (the model's own token stands)
        self.forced = (torch.full((b, m), -1, dtype=torch.int32, device=dev)
                       if engine_cfg.teacher_force else None)
        if engine_cfg.speculative_ngram > 0:
            # each slot's token history (prompt + emitted) on the device,
            # the n-gram drafter's source
            self.token_hist = torch.zeros((b, m), dtype=torch.int64,
                                          device=dev)
            # verify passes run / tokens emitted, counted from what the host
            # keeps (tokens per pass = 1 + mean accepted drafts)
            self.spec_passes = 0
            self.spec_tokens = 0
        # prefix KV cache: prefix-id bytes -> KVCache (L, 1, KVH, P, D); the
        # running shared prompt head for LCP detection (prepare() runs in
        # threads under the server, hence the lock)
        self._prefix_kv: "OrderedDict[bytes, dec.KVCache]" = OrderedDict()
        self._prompt_head: Optional[np.ndarray] = None
        self._prefix_miss = 0
        self._prefix_lock = threading.Lock()

    # ------------------------------------------------------------------

    def _decode_image(self, raw: bytes) -> np.ndarray:
        """Image bytes -> RGB uint8. The port's own decoder takes the 8-bit
        PNGs; any PNG it refuses (palette, 16-bit, 1/2/4-bit, interlaced)
        and every other format go through PIL on the host, as in the JAX
        engine."""
        if raw[:8] == b"\x89PNG\r\n\x1a\n":
            try:
                return decode_png_rgb(raw)
            except ValueError:
                pass  # a PNG variant the decoder does not take: PIL
        import io

        from PIL import Image

        pil = Image.open(io.BytesIO(raw))
        return np.asarray(pil.convert("RGB"), np.uint8)

    def staging_headroom(self, pending_pages: int) -> bool:
        """True when the card has room to stage one more prepared page: the
        free device memory (the allocator's unused reserve included), less
        the pages still being prepared, leaves 8% of the card for transient
        buffers. Always True on the CPU."""
        if self.device.type != "cuda":
            return True
        free, total = torch.cuda.mem_get_info(self.device)
        free += (torch.cuda.memory_reserved(self.device)
                 - torch.cuda.memory_allocated(self.device))
        page = int(self.ecfg.max_pixels * 3
                   * (torch.finfo(self.ecfg.dtype).bits // 8 + 1) * 1.3)
        return free - (pending_pages + 1) * page >= int(total * 0.08)

    def prepare(self, request: GenRequest) -> _Prepared:
        """Host-side request preparation: chat template, image decode and
        on-device resize/patchify, layout planning, token ids, positions,
        the shared-prefix length when prefix caching is on, and the forced
        stream under teacher forcing. A guided request's automaton is bound
        at prefill, not here: prepare() runs in threads, and an arena change
        between a request's prepare and its insert would move its start
        state."""
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
        prefix_len = self._prefix_len(ids) if self.ecfg.prefix_cache else 0
        prepared = _Prepared(
            ids=ids, positions=positions, image_feeds=image_feeds,
            img_token_counts=img_token_counts, max_tokens=request.max_tokens,
            temperature=request.temperature, top_p=request.top_p,
            request_id=request.request_id, prefix_len=prefix_len,
            speculative=request.speculative,
            guide_regex=request.guided_regex or None,
            logprobs=bool(request.logprobs),
            top_logprobs=min(int(request.top_logprobs or 0), 5))
        if self.ecfg.teacher_force and request.forced_output:
            if request.guided_regex:
                # a forced token the automaton forbids would corrupt the DFA
                # state: refuse the combination
                raise ValueError("teacher forcing does not compose with "
                                 "guided decoding (forced tokens bypass the "
                                 "automaton)")
            f = np.asarray(self.tok.encode(request.forced_output), np.int32)
            # fit the completion budget and the slot, less the verify pass's
            # headroom (its end-of-cache clamp would rewind the forcing
            # index); EOS-terminated, so a forced completion finishes with
            # reason "stop" as a real one does
            budget = min(int(request.max_tokens),
                         self.ecfg.max_seq_len - len(ids) - 2
                         - self.ecfg.speculative_ngram)
            f = f[:max(0, budget - 1)]
            prepared.forced_tokens = np.concatenate(
                [f, [self.tok.eos_token_id]]).astype(np.int32)
        return prepared

    # ------------------------------------------------------------------
    # guided decoding: the state arena
    # ------------------------------------------------------------------

    _ARENA_BUCKETS = (64, 256, 1024, 4096)
    ARENA_MAX_ROWS = 4096

    def guided_available(self, regex: str) -> bool:
        """Can a request with this regex be admitted now? True when it is
        resident in the arena, fits beside the resident automatons, or
        every resident automaton has drained (the arena then resets at
        bind time). The server holds back a request refused here and offers
        it again each admission round."""
        with self._automaton_lock:
            if regex in self._arena:
                return True
            try:
                n = self._compile_automaton_locked(regex).allowed.shape[0] - 1
            except ValueError:
                return True  # the bind at prefill fails this request alone
            if self._arena_used + n <= self.ARENA_MAX_ROWS:
                return True
            return not self._live_regexes_locked()

    def _live_regexes_locked(self) -> set:
        return {r for r, free in zip(self._slot_regex, self.slot_free)
                if r is not None and not free}

    def _compile_automaton_locked(self, regex: str):
        """Regex -> token automaton on the host, LRU-cached (the walk over
        the vocabulary is the expensive part; arena resets reuse it)."""
        hit = self._automaton_cache.get(regex)
        if hit is not None:
            self._automaton_cache.move_to_end(regex)
            return hit
        if self._token_bytes is None:
            self._token_bytes = token_bytes_from_tokenizer(
                self.tok, self.cfg.text.vocab_size)
        automaton = build_token_automaton(regex, self._token_bytes,
                                          self.tok.eos_token_id)
        self._automaton_cache[regex] = automaton
        while len(self._automaton_cache) > 8:
            self._automaton_cache.popitem(last=False)
        return automaton

    def _ensure_automaton(self, regex: str) -> int:
        """Make `regex` resident in the arena; returns the arena's start
        state for a new slot. Raises GuidedRegexBusy when the arena is full
        of other regexes with live slots, ValueError when the regex alone
        needs more states than the arena holds."""
        with self._automaton_lock:
            entry = self._arena.get(regex)
            if entry is not None:
                self._arena.move_to_end(regex)
                return entry["start"]
            automaton = self._compile_automaton_locked(regex)
            n = automaton.allowed.shape[0] - 1  # its rows less its FREE row
            if 1 + n > self.ARENA_MAX_ROWS:
                raise ValueError(
                    f"guided regex needs {n} token-automaton states; the "
                    f"arena holds at most {self.ARENA_MAX_ROWS - 1}")
            if self._arena_used + n > self.ARENA_MAX_ROWS:
                if self._live_regexes_locked():
                    raise GuidedRegexBusy(
                        "guided state arena is full with live automatons; "
                        "retry when one drains")
                # nothing live: drop every resident automaton (the host
                # compiles stay cached, so this is a table rebuild)
                self._arena.clear()
                self._arena_used = 1
            offset = self._arena_used
            start = offset + (automaton.start - 1)
            self._arena[regex] = {"offset": offset, "n": n, "start": start}
            self._arena_used += n
            self._upload_arena_locked()
            return start

    def _upload_arena_locked(self) -> None:
        """Rebuild and upload the flattened tables. Row 0 is FREE; automaton
        a's local states 1..n_a sit at rows offset_a.. with next states
        pre-offset. The row count is padded to a bucket, as in the JAX
        engine (there a new bucket compiles a new decode executable)."""
        vocab = self.cfg.text.vocab_size
        bucket = next(b for b in self._ARENA_BUCKETS
                      if b >= self._arena_used)
        allowed = np.zeros((bucket, vocab), bool)
        nxt = np.zeros((bucket, vocab), np.int32)  # default: fall to FREE
        free_mask = np.zeros((bucket,), bool)
        allowed[0] = True
        free_mask[0] = True
        eos = self.tok.eos_token_id
        if 0 <= eos < vocab:
            allowed[1:, eos] = True  # unoccupied (unreachable) rows
        # speculation-safe states: once a guided slot's DFA enters the
        # closed free set (the [\s\S]+ tail of the pipeline's regex),
        # masking is a no-op forever and the slot may speculate. Byte-less
        # tokens are exempt from the check (they self-loop and add no
        # text), EOS never is (an early EOS cuts the match short)
        zero_len = np.array([len(t) == 0 for t in self._token_bytes], bool)
        if 0 <= eos < len(zero_len):
            zero_len[eos] = False
        for regex, entry in self._arena.items():
            automaton = self._compile_automaton_locked(regex)
            o, n = entry["offset"], entry["n"]
            allowed[o:o + n] = automaton.allowed[1:]
            # local states 1..n map to rows o..o+n-1 (no local row beyond
            # FREE ever moves to local 0, so + o - 1 is exact)
            nxt[o:o + n] = automaton.next_state[1:] + (o - 1)
            local_free = closed_free_states(
                automaton.allowed, automaton.next_state, zero_len)
            free_mask[o:o + n] = local_free[1:]
        self._allowed = torch.from_numpy(allowed).to(self.device)
        self._next_state = torch.from_numpy(nxt).to(self.device)
        self._free_state_mask = free_mask

    def _prefix_len(self, ids: np.ndarray) -> int:
        """Shared-prefix length of a prompt: its longest common prefix with
        the running prompt head, the part before the first image (the OCR
        prompts are [instruction .. anchor .. image]). The first request
        seeds the head and prefills whole; the head then shrinks to the
        common prefix of the prompts seen. Below prefix_min_tokens the cache
        stays off, and after 4 such misses in a row the head is re-seeded,
        so an outlier first request cannot turn caching off for good."""
        img_idx = np.flatnonzero(ids == self.tok.image_pad_id)
        limit = int(img_idx[0]) if len(img_idx) else len(ids) - 1
        head = ids[:limit]
        prefix_len = 0
        with self._prefix_lock:
            stored = self._prompt_head
            if stored is None:
                self._prompt_head = head.copy()
                self._prefix_miss = 0
            else:
                n = min(len(stored), len(head))
                neq = np.flatnonzero(stored[:n] != head[:n])
                lcp = int(neq[0]) if len(neq) else n
                if lcp < self.ecfg.prefix_min_tokens:
                    self._prefix_miss += 1
                    if self._prefix_miss >= 4:
                        self._prompt_head = head.copy()
                        self._prefix_miss = 0
                else:
                    self._prefix_miss = 0
                    if lcp < len(stored):
                        self._prompt_head = stored[:lcp].copy()
                    # whole 128-token granules, so the prefix (one cache
                    # entry each) stays put under small LCP jitter
                    prefix_len = lcp if lcp < 128 else (lcp // 128) * 128
        if prefix_len and prefix_len + _bucket(
                len(ids) - prefix_len,
                self.ecfg.prefill_buckets) > self.ecfg.max_seq_len:
            # prefix rows + the padded suffix bucket must fit the slot
            prefix_len = 0
        return prefix_len

    def _prompt_embeds(self, prepared: _Prepared, start: int,
                       s_pad: int) -> torch.Tensor:
        """Embeddings of prompt tokens [start, S), padded to s_pad rows, with
        each image's encoded tokens merged at its positions (vision encoder
        on the device)."""
        dev, text = self.device, self.params["text"]
        n = len(prepared.ids) - start
        ids = torch.zeros((s_pad,), dtype=torch.int64)
        ids[:n] = torch.from_numpy(prepared.ids[start:].astype(np.int64))
        emb = dec.embed_tokens(text, ids.to(dev))
        img_pos_all = np.flatnonzero(
            prepared.ids == self.tok.image_pad_id) - start
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
        return emb

    def _padded_prompt(self, positions: np.ndarray):
        """A prompt span's positions (3, n), padded to its prefill bucket:
        returns positions (3, 1, s_pad) and kv_mask (1, s_pad) on the
        device, and s_pad."""
        n = positions.shape[1]
        s_pad = _bucket(n, self.ecfg.prefill_buckets)
        pos = torch.zeros((3, s_pad), dtype=torch.int32)
        pos[:, :n] = torch.from_numpy(positions)
        kv_mask = torch.zeros((s_pad,), dtype=torch.float32)
        kv_mask[:n] = 1.0
        return (pos[:, None, :].to(self.device),
                kv_mask[None].to(self.device), s_pad)

    def _get_prefix_cache(self, prefix_ids: np.ndarray) -> dec.KVCache:
        """KV rows of a shared text prefix, built once and LRU-cached."""
        key = prefix_ids.tobytes()
        hit = self._prefix_kv.get(key)
        if hit is not None:
            self._prefix_kv.move_to_end(key)
            return hit
        p = len(prefix_ids)
        text = self.params["text"]
        positions = mrope_positions(prefix_ids, [], self.tok.image_pad_id)
        pos, kv_mask, s_pad = self._padded_prompt(positions)
        ids = torch.zeros((s_pad,), dtype=torch.int64)
        ids[:p] = torch.from_numpy(prefix_ids.astype(np.int64))
        emb = dec.embed_tokens(text, ids.to(self.device))
        _, cache = dec.prefill_forward(text, self.cfg.text, emb[None], pos,
                                       kv_mask=kv_mask,
                                       act_quant=self._act_quant)
        trimmed = dec.KVCache(cache.k[:, :, :, :p].contiguous(),
                              cache.v[:, :, :, :p].contiguous())
        self._prefix_kv[key] = trimmed
        while len(self._prefix_kv) > self.ecfg.prefix_cache_entries:
            self._prefix_kv.popitem(last=False)
        return trimmed

    def prefill(self, prepared: _Prepared):
        """Vision encode + embedding merge + causal prefill of one request,
        over the suffix only when it shares a cached prefix. Returns
        (last-position logits (V,), the prompt's KV rows: the prefix's rows,
        then the rest padded to its prefill bucket). A guided request's
        automaton is bound here (GuidedRegexBusy while the arena is full of
        other live regexes)."""
        if prepared.guide_regex and prepared.guide is None:
            prepared.guide = self._ensure_automaton(prepared.guide_regex)
        text = self.params["text"]
        p = prepared.prefix_len
        n = len(prepared.ids) - p
        pos, kv_mask, s_pad = self._padded_prompt(prepared.positions[:, p:])
        emb = self._prompt_embeds(prepared, p, s_pad)
        if p:
            prefix = self._get_prefix_cache(prepared.ids[:p])
            hidden, pcache = dec.prefill_with_prefix(
                text, self.cfg.text, emb[None], pos, prefix,
                torch.ones((1, p), device=self.device), kv_mask=kv_mask,
                act_quant=self._act_quant)
        else:
            hidden, pcache = dec.prefill_forward(
                text, self.cfg.text, emb[None], pos, kv_mask=kv_mask,
                act_quant=self._act_quant)
        logits = dec.logits_from_hidden(text, self.cfg.text, hidden[0, n - 1],
                                        act_quant=self._act_quant)
        return logits, pcache

    def _sample_first(self, prepared: _Prepared, logits: torch.Tensor):
        """The first token from the prefill's logits (V,): the guided mask of
        the start state, greedy or sampled, and the first token's logprobs
        when requested. Returns (first token, DFA state after it) as device
        scalars."""
        guide = prepared.guide
        if guide is not None:
            logits = torch.where(self._allowed[guide], logits.float(),
                                 float("-inf"))
        if prepared.temperature <= 0.0:
            first = torch.argmax(logits.float(), dim=-1)
        else:
            first = sample_tokens(
                logits[None], self._gen,
                torch.tensor([prepared.temperature], device=self.device),
                torch.tensor([prepared.top_p], device=self.device))[0]
        dfa_after = (self._next_state[guide, first].long()
                     if guide is not None else 0)
        if prepared.logprobs:
            logp = torch.log_softmax(logits.float(), dim=-1)
            top_vals, top_ids = top_logprobs(logp, prepared.top_logprobs)
            self._first_logprob[prepared.request_id] = (
                float(logp[first]),
                list(zip(top_ids.tolist(), top_vals.double().tolist())))
        return first, dfa_after

    def prefill_insert(self, slot: int, prepared: _Prepared):
        """Prefill a request, pick its first token, and write its KV rows
        into `slot` of the cache (in place; quantized for the int8 cache,
        quantized and nibble-packed for the int4 cache).
        Returns the first token: a device scalar, or under teacher forcing
        the forced stream's first token."""
        dev = self.device
        s = len(prepared.ids)
        logits, pcache = self.prefill(prepared)
        for feed in prepared.image_feeds:
            feed["pix_dev"] = None  # the page's pixels are no longer needed
        rows = pcache.k.shape[3]
        first, dfa_after = self._sample_first(prepared, logits)

        c = self.cache
        if isinstance(c, dec.Q4KVCache):
            # ceil64(rows) / 2 packed rows; the pad's nibbles lie past the
            # prompt, where cache_len masks them
            k4, v4, ks4, vs4 = dec.q4_pack_prefill(pcache.k[:, 0],
                                                   pcache.v[:, 0])
            ps = k4.shape[-2]
            c.k[:, slot, :, :ps] = k4
            c.v[:, slot, :, :ps] = v4
            c.ks[:, slot, :, :ps] = ks4.to(c.ks.dtype)
            c.vs[:, slot, :, :ps] = vs4.to(c.vs.dtype)
        elif isinstance(c, dec.QuantKVCache):
            kq, ksc = dec.quantize_kv_rows(pcache.k[:, 0])
            vq, vsc = dec.quantize_kv_rows(pcache.v[:, 0])
            c.k[:, slot, :, :rows] = kq
            c.v[:, slot, :, :rows] = vq
            c.ks[:, slot, :, :rows] = ksc.to(c.ks.dtype)
            c.vs[:, slot, :, :rows] = vsc.to(c.vs.dtype)
        else:
            c.k[:, slot, :, :rows] = pcache.k[:, 0].to(c.k.dtype)
            c.v[:, slot, :, :rows] = pcache.v[:, 0].to(c.v.dtype)
        self.cache_len[slot] = s
        self.next_pos[slot] = int(prepared.positions.max()) + 1 if s else 0
        self.last_token[slot] = first
        self.temps[slot] = float(prepared.temperature)
        self.top_ps[slot] = float(prepared.top_p)
        self.dfa_state[slot] = dfa_after
        self.slot_free[slot] = False
        self._slot_temp[slot] = float(prepared.temperature)
        self._slot_top_p[slot] = float(prepared.top_p)
        self._slot_len[slot] = s
        self._slot_spec[slot] = prepared.speculative is not False
        self._slot_guided[slot] = prepared.guide is not None
        self._slot_regex[slot] = (prepared.guide_regex
                                  if prepared.guide is not None else None)
        self._slot_lp_k[slot] = (prepared.top_logprobs if prepared.logprobs
                                 else None)
        if self.ecfg.speculative_ngram > 0:
            hist = np.zeros((self.ecfg.max_seq_len,), np.int64)
            hist[:s] = prepared.ids
            self.token_hist[slot] = torch.from_numpy(hist).to(dev)
            self.token_hist[slot, s] = first
        if self.ecfg.teacher_force:
            return self._apply_teacher(slot, prepared, first)
        return first

    def _apply_teacher(self, slot: int, prepared: _Prepared, first):
        """Upload the slot's forced stream (a cleared row for an unforced
        request, so a reused slot never inherits a stale one) and make the
        forced stream's first token the pending one. Returns the first
        emitted token."""
        m = self.ecfg.max_seq_len
        s = len(prepared.ids)
        row = np.full((m,), -1, np.int32)
        ft = prepared.forced_tokens
        if ft is not None and len(ft):
            n = min(len(ft), m - s)
            row[s:s + n] = ft[:n]
            first = int(ft[0])
            self.last_token[slot] = first
            if self.ecfg.speculative_ngram > 0:
                self.token_hist[slot, s] = first
        self.forced[slot] = torch.from_numpy(row).to(self.device)
        return first

    def decode_chunk(self, steps: Optional[int] = None,
                     logits_out: Optional[list] = None) -> np.ndarray:
        """K decode steps for every slot; returns (K, B) tokens on the host.
        With `logits_out`, each step's (B, V) logits are appended to it."""
        return self.decode_chunk_async(steps, logits_out)()

    def decode_chunk_async(self, steps: Optional[int] = None,
                           logits_out: Optional[list] = None):
        """Launch K decode steps for every slot without waiting for them.
        Kernel launches are asynchronous on the card, so the next chunk can
        be launched before this one's tokens are read. Returns the collector:
        a zero-argument callable that copies the (K, B) tokens to the host
        (the only device-to-host sync of a chunk), and with them the
        chunk's logprobs when a slot asked for them (``_last_logprobs``)."""
        steps = steps or self.ecfg.decode_chunk
        m = self.ecfg.max_seq_len
        active = [i for i, free in enumerate(self.slot_free) if not free]
        use_sampling = any(self._slot_temp[i] > 0.0 for i in active)
        use_top_p = use_sampling and any(self._slot_top_p[i] < 1.0
                                         for i in active)
        # the mask gather and where cost a (B, V) pass a step: only when a
        # live slot is guided; likewise the log-softmax and top-k
        use_guided = any(self._slot_guided[i] for i in active)
        lp_ks = [self._slot_lp_k[i] for i in active
                 if self._slot_lp_k[i] is not None]
        use_logprobs = bool(lp_ks)
        top_k = max(lp_ks, default=0)
        forced = self.forced
        for i in active:
            self._slot_len[i] = min(self._slot_len[i] + steps, m - 1)
        text = self.params["text"]
        out, lps = [], []
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
            if use_guided:
                logits = torch.where(self._allowed[self.dfa_state],
                                     logits.float(), float("-inf"))
            tokens = sample_tokens(logits, self._gen,
                                   self.temps if use_sampling else None,
                                   self.top_ps if use_top_p else None)
            if forced is not None:
                # the new token lands at history position cache_len + 1
                fpos = torch.clamp(self.cache_len.long() + 1, max=m - 1)
                frow = forced.gather(1, fpos[:, None])[:, 0].long()
                tokens = torch.where(frow >= 0, frow, tokens)
            if use_guided:
                self.dfa_state = self._next_state[self.dfa_state,
                                                  tokens].long()
            if use_logprobs:
                logp = torch.log_softmax(logits.float(), dim=-1)
                chosen = logp.gather(1, tokens[:, None])[:, 0]
                top_vals, top_ids = top_logprobs(logp, top_k)
                lps.append((chosen, top_vals, top_ids))
            self.cache_len = torch.clamp(self.cache_len + 1, max=m - 1)
            self.next_pos = self.next_pos + 1
            self.last_token = tokens
            out.append(tokens)
        toks = torch.stack(out)
        if not use_logprobs:
            def collect():
                self._last_logprobs = None
                return toks.cpu().numpy()
            return collect
        chosen, top_vals, top_ids = (torch.stack(x) for x in zip(*lps))

        def collect_lp():
            # (K, B), (K, B, k), (K, B, k)
            self._last_logprobs = (chosen.cpu().numpy(),
                                   top_vals.cpu().numpy(),
                                   top_ids.cpu().numpy())
            return toks.cpu().numpy()
        return collect_lp

    def decode_headroom(self, steps: int) -> bool:
        """True if every active slot can absorb `steps` more cache rows: the
        bound for launching a lookahead chunk."""
        active = [i for i, free in enumerate(self.slot_free) if not free]
        top = max((self._slot_len[i] for i in active), default=0)
        return top + steps + 1 < self.ecfg.max_seq_len

    # ------------------------------------------------------------------
    # n-gram speculation
    # ------------------------------------------------------------------

    def _spec_step(self, gamma: int, use_sampling: bool, logits_out=None):
        """One verify pass for every slot: draft gamma tokens from the slot's
        history (the tokens after the most recent earlier occurrence of its
        trailing bigram), run [last_token, draft] through decode_multi and
        accept the longest agreeing prefix plus one fresh token. Rejected
        rows stay past cache_len. Returns (y (B, T), n_new (B,))."""
        m = self.ecfg.max_seq_len
        t = gamma + 1
        text, dev = self.params["text"], self.device
        hist = self.token_hist
        b = hist.shape[0]
        bidx = torch.arange(b, device=dev)
        # the multi-token kernel's bound: cache_len + T <= M - 1
        cache_len = torch.clamp(self.cache_len, max=m - t - 1)
        ntok = cache_len.long() + 1       # history entries incl. pending token
        t0 = hist[bidx, torch.clamp(ntok - 2, min=0)]
        t1 = hist[bidx, ntok - 1]
        pos = torch.arange(m - 1, device=dev)[None, :]
        match = ((hist[:, :-1] == t0[:, None]) & (hist[:, 1:] == t1[:, None])
                 & (pos < (ntok - 2)[:, None]))
        start = torch.where(match, pos, -1).amax(dim=1) + 2
        start = torch.clamp(start, 0, m - gamma - 1)
        draft = hist[bidx[:, None],
                     start[:, None] + torch.arange(gamma, device=dev)]

        feed = torch.cat([self.last_token[:, None], draft], dim=1)  # (B, T)
        emb = dec.embed_tokens(text, feed)
        p1 = self.next_pos[:, None] + torch.arange(t, device=dev)[None]
        positions = p1[None].expand(3, b, t)
        hidden, self.cache = dec.decode_multi(text, self.cfg.text, emb,
                                              positions, self.cache,
                                              cache_len,
                                              act_quant=self._act_quant)
        logits = dec.logits_from_hidden(text, self.cfg.text, hidden,
                                        act_quant=self._act_quant)
        if logits_out is not None:
            logits_out.append(logits)
        # output positions of the T candidates (also the forcing index)
        wpos = torch.clamp(ntok[:, None] + torch.arange(t, device=dev),
                           max=m - 1)
        if use_sampling:
            y, n_new = spec_verify_sampled(logits, draft, self.temps,
                                           self._gen)
        else:
            y = torch.argmax(logits.float(), dim=-1)              # (B, T)
            if self.forced is not None:
                # teacher forcing: the forced stream stands in for the
                # model's output; the drafts are held to it by the same
                # exact-prefix rule, after the full verify compute
                fr = self.forced.gather(1, wpos).long()
                y = torch.where(fr >= 0, fr, y)
            ok = torch.cumprod((y[:, :gamma] == draft).long(), dim=1)
            n_new = 1 + ok.sum(dim=1)
        # record all T candidates; rejected ones are overwritten later
        hist[bidx[:, None], wpos] = y
        self.last_token = y[bidx, n_new - 1]
        self.cache_len = cache_len + n_new.to(torch.int32)
        self.next_pos = self.next_pos + n_new.to(torch.int32)
        return y, n_new

    def decode_chunk_spec(self, steps: Optional[int] = None,
                          logits_out: Optional[list] = None):
        """Speculative chunk. Returns (toks (S, B, gamma + 1), counts (S, B))
        on the host: verify pass s emitted counts[s, b] tokens, the first
        counts[s, b] entries of toks[s, b]."""
        gamma = self.ecfg.speculative_ngram
        t = gamma + 1
        steps = steps or max(1, self.ecfg.decode_chunk // t)
        m = self.ecfg.max_seq_len
        active = [i for i, free in enumerate(self.slot_free) if not free]
        # under teacher forcing the outputs are the forced streams, so
        # verification is the exact-prefix rule whatever the temperature
        use_sampling = (any(self._slot_temp[i] > 0.0 for i in active)
                        and not self.ecfg.teacher_force)
        ys, ns = [], []
        for _ in range(steps):
            y, n_new = self._spec_step(gamma, use_sampling, logits_out)
            ys.append(y)
            ns.append(n_new)
        toks = torch.stack(ys).cpu().numpy()
        counts = torch.stack(ns).cpu().numpy()
        for i in active:  # replay the device's length update on the mirror
            n = self._slot_len[i]
            for st in range(steps):
                n = min(n, m - t - 1) + int(counts[st, i])
            self._slot_len[i] = n
        return toks, counts

    def spec_emissions(self, spec_toks: np.ndarray, spec_counts: np.ndarray,
                       budgets: dict) -> dict:
        """Cut a speculative chunk's emissions per slot at EOS or its token
        budget (`budgets`: slot -> tokens still wanted) and count acceptance
        from what the host keeps: passes after EOS and their tokens do not
        count. Returns slot -> kept tokens. Shared by generate and the
        server's engine loop."""
        emitted: dict = {}
        for slot, budget in budgets.items():
            toks_list: list = []
            passes = 0
            done = False
            for st in range(spec_toks.shape[0]):
                if done or len(toks_list) >= budget:
                    break
                passes += 1
                for tok in spec_toks[st, slot, :spec_counts[st, slot]]:
                    toks_list.append(int(tok))
                    if (int(tok) == self.tok.eos_token_id
                            or len(toks_list) >= budget):
                        done = True
                        break
            self.spec_passes += passes
            self.spec_tokens += len(toks_list)
            emitted[slot] = toks_list
        return emitted

    def _spec_ok(self) -> bool:
        """Speculate when it is enabled, every active slot samples plainly
        (no nucleus filtering, no logprobs: both need the per-step path), the
        slots that vote for speculation are the majority of the wave, and
        every guided slot's DFA state lies in the closed free set (every
        token allowed forever), so skipping the mask changes no output.
        Verification is exact either way."""
        if self.ecfg.speculative_ngram <= 0:
            return False
        active = [i for i, free in enumerate(self.slot_free) if not free]
        if not active:
            return False
        if any(self._slot_top_p[i] < 1.0 for i in active):
            return False
        if any(self._slot_lp_k[i] is not None for i in active):
            return False
        if 2 * sum(self._slot_spec[i] for i in active) <= len(active):
            return False
        guided = [i for i in active if self._slot_guided[i]]
        if not guided:
            return True  # unguided slots sit in FREE
        states = self.dfa_state.cpu().numpy()
        return bool(self._free_state_mask[states[guided]].all())

    def free_slot(self, slot: int) -> None:
        self.slot_free[slot] = True
        self._slot_spec[slot] = True
        self._slot_guided[slot] = False
        self._slot_regex[slot] = None
        self._slot_lp_k[slot] = None

    # ------------------------------------------------------------------

    def generate(self, requests: list[GenRequest]) -> list[GenResult]:
        """Synchronous batch generation over the decode slots."""
        results: dict[int, GenResult] = {}
        pending = list(enumerate(requests))
        # slot -> [req_idx, prepared, tokens, t0, logprobs or None]
        active: dict[int, list] = {}
        # collector of a decode chunk launched before the previous chunk's
        # tokens were read; no admission while it runs (an insert would race
        # the chunk's writes to the cache)
        inflight = None
        while pending or active:
            wave = []
            deferred = []
            free_count = sum(self.slot_free) if inflight is None else 0
            while pending and free_count > 0:
                req_idx, request = pending.pop(0)
                if (request.guided_regex
                        and not self.guided_available(request.guided_regex)):
                    # another regex fills the arena with live slots: hold
                    # this request until they drain
                    deferred.append((req_idx, request))
                    continue
                start = time.time()
                prepared = self.prepare(request)
                # keep prompt + completion within the cache
                prepared.max_tokens = min(
                    prepared.max_tokens,
                    max(1, self.ecfg.max_seq_len - len(prepared.ids) - 1))
                slot = self.slot_free.index(True)
                first = self.prefill_insert(slot, prepared)
                wave.append((req_idx, prepared, slot, start, first))
                free_count -= 1
            pending = deferred + pending
            for req_idx, prepared, slot, start, first in wave:
                first_host = int(first)
                collected = [first_host]
                lp = ([self._first_logprob.pop(prepared.request_id, None)]
                      if prepared.logprobs else None)
                if (first_host == self.tok.eos_token_id
                        or prepared.max_tokens <= 1):
                    reason = ("stop" if first_host == self.tok.eos_token_id
                              else "length")
                    results[req_idx] = self._finish(prepared, collected,
                                                    reason, start, lp)
                    self.free_slot(slot)
                else:
                    active[slot] = [req_idx, prepared, collected, start, lp]
            if not active:
                if inflight is not None:
                    inflight()  # every slot finished: drain and discard
                    inflight = None
                continue
            if inflight is not None and self._spec_ok():
                # the slot mix changed under the inflight chunk: drain it
                # before switching to speculation
                toks = inflight()
                inflight = None
                emitted = {slot: [int(t) for t in toks[:, slot]]
                           for slot in active}
            elif self._spec_ok():
                spec_toks, spec_counts = self.decode_chunk_spec()
                emitted = self.spec_emissions(spec_toks, spec_counts, {
                    slot: st[1].max_tokens - len(st[2])
                    for slot, st in active.items()})
            else:
                steps = self.ecfg.decode_chunk
                collect = (inflight if inflight is not None
                           else self.decode_chunk_async())
                inflight = None
                # launch the next chunk before reading this one when every
                # slot needs more than a chunk anyway and the cache has room
                min_remaining = min(st[1].max_tokens - len(st[2])
                                    for st in active.values())
                if min_remaining > steps and self.decode_headroom(steps):
                    inflight = self.decode_chunk_async()
                toks = collect()
                emitted = {slot: [int(t) for t in toks[:, slot]]
                           for slot in active}
            lp_data = self._last_logprobs
            for slot in list(active):
                req_idx, prepared, collected, start, lp = active[slot]
                finished = None
                for j, token in enumerate(emitted[slot]):
                    collected.append(token)
                    if lp is not None and lp_data is not None:
                        lp.append(chunk_logprob(lp_data, j, slot,
                                                prepared.top_logprobs))
                    if token == self.tok.eos_token_id:
                        finished = "stop"
                        break
                    if len(collected) >= prepared.max_tokens:
                        finished = "length"
                        break
                if finished:
                    results[req_idx] = self._finish(prepared, collected,
                                                    finished, start, lp)
                    del active[slot]
                    self.free_slot(slot)
        if inflight is not None:
            inflight()
        return [results[i] for i in range(len(requests))]

    def _finish(self, prepared: _Prepared, collected: list[int], reason: str,
                start: float, logprobs: Optional[list] = None) -> GenResult:
        out_ids = [t for t in collected if t != self.tok.eos_token_id]
        if logprobs is not None:
            logprobs = [x for t, x in zip(collected, logprobs)
                        if t != self.tok.eos_token_id][: len(out_ids)]
        return GenResult(request_id=prepared.request_id,
                         text=self.tok.decode(out_ids), token_ids=out_ids,
                         finish_reason=reason,
                         prompt_tokens=int(len(prepared.ids)),
                         completion_tokens=len(collected),
                         latency_s=time.time() - start, logprobs=logprobs)


def top_logprobs(logp: torch.Tensor, k: int):
    """The max(1, k) largest log-probabilities on the last axis and their
    ids, ties in id order (as jax.lax.top_k orders them: a guided mask
    leaves many tokens tied at -inf)."""
    vals, ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    k = max(1, k)
    return vals[..., :k], ids[..., :k]


def chunk_logprob(lp_data, step: int, slot: int, k: int) -> tuple:
    """One emitted token's (logprob, [(alt_id, alt_logprob) x k]) from a
    collected chunk's (chosen, top values, top ids)."""
    chosen, top_vals, top_ids = lp_data
    return (float(chosen[step, slot]),
            list(zip(top_ids[step, slot, :k].tolist(),
                     top_vals[step, slot, :k].tolist())))
