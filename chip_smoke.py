"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # and torch.profiler stage breakdowns

Phases (any failed check raises and the script exits non-zero):

1. card: name, power limit, TF32 off for float32 products;
2. build: nvcc builds the nine kernel sources from
   karanta_tpu_torch/kernels/csrc, one process per source, all at once,
   and beside them the decode streams' instrumented copy that phase 3
   traces (bench/stream_trace.py);
3. kernels vs plain: each of the eleven kernels against its plain PyTorch
   version at the Qwen2.5-VL-7B shapes of the paths below and at small
   ragged shapes (the int4 kernels at lengths on the 32-row and 64-token
   window boundaries); every cache a kernel writes is bit-equal to the plain
   version's; times of the kernel, the plain version and one library call
   where there is one (a yardstick the port never uses); flash attention's
   TFLOP/s on the live pairs and share of its bound at the decoder-prefill,
   vision-full and prefix shapes, window attention's TFLOP/s and the read-
   only decode kernels' GB/s of live bytes, each with its share of the
   bound and its ratio to SDPA's time, and the registers, shared memory and
   blocks per SM of these three kernels' tensor-core instances; the int8
   and int4 verify kernels, the int8 decode kernel and the bf16 append
   kernel likewise (GB/s of live bytes, share of the bound, resources; the
   int8 verify kernel also at B = 32 with ragged lengths, the int4 verify
   and decode kernels at the served int4 point's B = 8 with ragged lengths,
   the int8 decode and verify kernels at the decode A/B point, B = 80 with
   every slot filled to 1,650 of 1,920 rows, each checked against its plain
   version;
   beside the append kernel, SDPA over the bucket with the new row
   scattered, for context); the split decode kernels' and window
   attention's device time (and SDPA's beside #1's) without the host's
   launch overhead, from a CUDA graph of 20 calls; kernels #10 and
   #11, the decode weight streams, at full 7B width and depth: checked at
   B = 4 over ragged lengths, timed at the JAX package's decode A/B point
   (B = 80, 1920-row bucket filled to 1650), their device time at both
   batches by CUDA events over 20 chained calls, and traced phase by phase
   at both batches on an instrumented copy (bench/stream_trace.py: ms per
   step of the products, the attention, the row phases and the barriers);
   decode-stream A/B: the megakernel step, the split decode_step and
   dense_stream, each chained 20 times at a fixed cache_len, at B = 80 and
   B = 4 (ms/step, GB/s of the bytes bound, peak memory, one launch of #11
   per step and none of #3, 28 of #3 per split step), and a probe of the
   grid barriers' cost;
4. engine path: the port's Engine on qwen2.5-vl-7b at full width and depth
   (random int8 weights, W8A8 prefill, int8 KV cache, per-step decode)
   serves synthetic 1288x994 pages; launch counts prove the path ran
   through the window, flash and int8 decode kernels;
5. served path, int8 point: the port's OpenAI server in process on
   127.0.0.1, built by its CLI (--quantize int8 --kv-quantize int8
   --act-quant int8, 4 slots, chunk 8, speculation and prefix caching at
   their defaults), answers concurrent page requests over HTTP, one as an
   SSE stream; every verify pass goes through the multi-token int8 kernel;
6. served path, int4 point: the server built by its CLI with --quantize
   int8 --kv-quantize int4 --act-quant int8, 8 slots, chunk 8, context 4096,
   speculation and prefix caching on: a wave that opts out of speculation
   decodes per step through the int4 append kernel, a default wave verifies
   through the multi-token int4 kernel, and no other decode kernel runs;
7. served path, CLI defaults: the server built from the CLI with nothing but
   the preset (bf16 weights and KV cache, 32 slots, context 4096, chunk 64,
   speculation and prefix caching on): a wave that opts out of speculation
   decodes per step through the bf16 append kernel, the same wave under
   KARANTA_PAGED_DECODE=stacked through a scatter and the read-only stacked
   kernel, and a default wave runs the bf16 verify pass;
8. the same engine code on the tiny config on the card and on the CPU, with
   the int8 and the int4 cache: the logits of the prefill, of three decode
   steps and of three verify passes agree, and so do the greedy tokens, with
   and without speculation; the stacked mode gives the append kernel's
   tokens on the card;
9. the OCR pipeline: `python -m karanta_tpu_torch.pipeline ... --serve-inproc
   --preset qwen2.5-vl-7b` as a subprocess over 6 synthetic PDFs (7 pages,
   three under a text layer, one of two pages): it spawns the port's server
   at its CLI defaults, exits 0, every page gets its one attempt answered,
   every work group is done, and the Dolma documents follow the runner's
   rules; then the port's pipeline bench in process (7B, int8 weights, W8A8,
   int8 KV, 1920 rows, 8 slots, 8 text-layer pages x 32 tokens), whose
   window and flash launches match the pages prefilled, warm-up included,
   and whose decode or verify kernel launched; then the bench again with
   --teacher-force (14-line pages, 512 tokens a page, 2816 rows): every
   page finishes on its first attempt and its Dolma text is its forced
   transcript cut to the budget (the pipeline's success path), with
   pages/s, tokens a page and tokens a verify pass;
10. weight loading: a random 7B checkpoint (bf16, full depth) written by
   the port's exporter, loaded with int8 on transfer: every tensor
   bit-equal to quantize_decoder_params of the weights in memory, greedy
   tokens of an engine on each equal over one page x 32 tokens, the load's
   seconds and GB/s; then the server CLI with --model-path beside a BPE
   tokenizer trained here answers a page (where tokenizers and
   transformers are installed);
11. guided decoding and logprobs at the int8 server point: one wave of a
   page under the pipeline's guided regex (its completion must match),
   one with logprobs (top 5: each chosen logprob is its top-1 and within
   1e-3 of a float32 log_softmax of the logits captured at that step) and
   a plain one; guided and unguided slots decode side by side;
12. training (karanta_tpu_torch.training): three runs of the trainer's
   main() at configs/training/ocr/karanta_qwen25_3b.yaml (Qwen2.5-VL-3B at
   full width and depth, bf16, remat, batch 1 x grad-accum 4, warmup 0)
   from a random 3B checkpoint written by the port's exporter beside a BPE
   tokenizer, on 5 synthetic 1288x994 pages under a 14-line text layer:
   AdamW 3 steps (its checkpoint read back bit-equal), QLoRA rank 16 2 steps
   (the NF4 base unchanged), Muon 2 steps; each with a finite loss and
   grad_norm, changed parameters, ms/step, tokens/s, the share of 989
   TFLOP/s, peak memory and #1/#2 launches a step; the server CLI with
   --native-checkpoint over the AdamW run answers a page over HTTP (with
   --profile, one more AdamW run traces its second step under the
   trainer's --is_profile). Then kernels #1 and #2 under autograd with the
   masks of the first row the AdamW run trained (the decoder's causal
   flash attention, 16 query heads over 2 kv heads, d = 128, the row's pad
   mask; the vision full layers; the window kernel's no-rope instance):
   the forward at the bf16 limit, dq/dk/dv of the kernel's forward and the
   plain backward normwise within 1e-2 of float32 autograd through the
   dense plain versions, two calls bit-equal; the tiny config in float32,
   card against CPU: the loss and every gradient leaf of one step, every
   parameter after 3 AdamW steps, and #1/#2 launched in the forward and
   again in the remat recompute;
13. the document classifiers (karanta_tpu_torch.models.classifier): kernel
   #2's float32 instance at their shapes (the SegFormer's four stages at
   mit-b0, 512 px, B = 16, queries over 256 sequence-reduced keys; the ViT
   of segment_vit.yaml, (32, 197, 6, 64)) against its plain version, two
   calls bit-equal, its times by events and by a CUDA graph, its bound at
   164.9 TFLOP/s (3xTF32 on the tensor cores, the instance's products) and,
   for continuity, at 67 TFLOP/s (CUDA-core float32), SDPA's float32 time
   and the factor
   against it, and the instance's registers, spills, shared memory and
   blocks per SM at each head dim; LayoutClassifier serving a
   batch of synthetic pages per arch (SegFormer, ViT, ConvNeXt V2-tiny,
   ResNet-50 at their presets; 8, 12, 0 and 0 flash launches a batch;
   logits within 1e-4 x max|logit| of the CPU's on the same weights,
   labels equal; images/s, peak memory); classifier_train.main() at
   segment_segformer.yaml (3 steps) and segment_vit.yaml (2 steps) on an
   image folder that the port's data/convert_pdf_2_image.py renders from
   synthetic PDFs (finite loss, changed parameters, 8 or 12 flash launches
   a step, the final checkpoint read back bit-equal, `auto` resuming it;
   ms/step, images/s, the card's busy share of a profiled step, peak
   memory), the plain attention backward beside the kernel's forward; the
   tiny SegFormer and ViT in float32, card against CPU: the loss and
   every gradient of one step, every parameter after 3 AdamW steps;
14. batched prefill (EngineConfig.prefill_batch) and the W8A8 vision tower
   at qwen2.5-vl-7b (int8 weights, W8A8, int8 KV, 8 slots, 1,920 rows, 8
   distinct pages x 24 tokens): per-page prefill (A: #1 224, #2 256
   launches) against prefill_batch=4 (B: 56 and 64; per page, the
   batched encode's vision tokens within 2^-8 normwise of the single
   encode's, the decoder on equal tokens bit-equal at batch 4 and 1, the
   noise floor of half an ulp on the vision tokens, the prefill logits
   within 3e-2 normwise of A's, greedy first tokens equal where the top-2
   margin exceeds twice the difference), B with the W8A8 tower (C:
   its logits' distance from B's, the encode's ms a page in bf16 and W8A8,
   peak memory) and B with speculation (D: #4 launched); prefill+insert ms
   a page at K = 1, 2 and 4 (host clock and torch.profiler); pages/s of A
   and B; prepare ms a page in the pool against the main thread's wait;
   then `python -m karanta_tpu_torch.inference.single_page` at 7B and
   `python -m karanta_tpu_torch.bench.convert karanta_engine:preset=tiny`
   over two PDFs, as subprocesses on the card, the harness's outputs scored
   by bench/scoring.py. Kernels #1 and #2 are also held against their plain
   versions at the batched shapes in phase 3: #1 over four pages'
   concatenation, #2 at (4, 5120, 16, 80) with four masks and at (4, 1408,
   28/4, 128) causal with kv lengths 1390, 700, 1408 and 1.

15. parallel serving (karanta_tpu_torch.parallel): ranks spawned from this
   process share the card and talk over gloo (NCCL refuses two ranks on one
   device). The tiny config at model=2 and at data=2 x model=2 against one
   rank on the card (int8, int4 and bf16 caches, without and with
   speculation: greedy tokens equal, the logits of the prefill, 3 decode
   steps and 3 verify passes within phase 8's bound); qwen2.5-vl-7b at
   full width and depth on model=2 against one rank on the same seeded
   weights: the W8A8 decoder's hidden state after a page's prefill
   bit-equal on equal vision tokens, the first-token logits bit-equal with
   the W8A8 tower and within 3e-2 normwise with the bf16 tower, #1/#2
   launched on both ranks, prefill+insert ms a page, decode ms a step and
   the share of host time in collectives; the 7B int8 point with
   speculation at data=2 x model=2 through generate, at full width cut to
   7 of 28 decoder layers and 8 of 32 vision blocks (four pages, #1, #2
   and #4 on every rank); the server CLI at --tensor-parallel-size 2
   (this process rank 0) answering four pages over HTTP, one as an SSE
   stream, each rank's #1-#4 launches gathered to rank 0. Phase 3 also
   holds kernels #1-#7 and #9 at one rank's shapes of tp = 2 and 4 against
   their plain versions (kernel, device, plain and library ms, share of
   the bound).
16. parallel training (``phase_parallel_training``): the trainer's entry
   point as two processes at data = 2 (tiny, float32, 3 steps: equal losses
   on the ranks and against one process on the same global batch, one
   COMPLETED checkpoint, a resume at fsdp = 2 to step 4); one spawn of two
   ranks that builds each mesh in turn: the tiny float32 step at data = 2
   (grad-accum 2, rows of unequal token counts), fsdp = 2 (AdamW, Muon),
   model = 2, seq = 2 and pipe = 2 (4 layers, 2 microbatches) against one
   rank on the card (loss within 1e-5, every gradient and parameter within
   2e-4), and qwen2.5-vl-3b at full width cut to 6 of 36 decoder layers
   and 8 of 32 vision blocks (bf16, remat, two 3,072-token rows of phase
   12's synthetic pages) at data, fsdp, seq and model = 2 against its
   one-rank step (loss within 1e-2, grad norm within 2e-2, the ranks'
   losses equal; ms a step, collectives' host seconds, share and calls,
   peak card memory and #1/#2 launches per rank). Before it, #2 at a
   sequence-parallel rank's shape (1,536 queries at q_offset 0 and 1,536
   over 3,072 gathered keys, 16/2 and 8/1 heads) against its plain version
   and under autograd (``kernel_flash_sp``).
17. the last modules (``phase_last_modules``): (a) the trainer's entry
   point with use_lora as two processes at fsdp = 2 beside one process on
   the same global batch (tiny, float32, 3 steps: the ranks' losses equal
   and within 1e-5 of one process's); one spawn of two ranks that runs
   LoRA and QLoRA at fsdp = 2 and at model = 2 (the base as each rank's
   slices, the factors whole): the tiny float32 steps against one rank on
   the card (loss within 1e-5, factors within 2e-4 after AdamW) and
   qwen2.5-vl-3b cut as in phase 16 with rank-16 adapters (loss within
   1e-2, grad norm within 2e-2, the ranks' losses equal; ms a step,
   collectives' share and calls, peak card memory and #1/#2 launches per
   rank); (b) the server CLI's engine at the int8 point (phase 5's flags)
   in process, and the port's bulk CLI over it and a port on which nothing
   listens, with vLLM-format requests that data/create_batch_data_prompts
   builds from phase 9's PDFs (7 pages, 32 tokens a page): every task
   completed on the live server, a second run makes no request, #1/#2
   launches match the pages prefilled, a decode or verify kernel ran;
   pages/s through the router and the median task latency; (c)
   data/test_prompts and bench/create_tests through get_client("openai",
   base_url=...) against the same server, one page each; (d) `python -m
   karanta_tpu_torch.bench.closed_loop` with tests/test_closed_loop.py's
   arguments on the card: 8 pages read back, mean CER <= 0.15, at least 6
   exact matches; training seconds and steps/s. (d)'s process starts before
   phase 16 and runs beside phases 16 and 17: its 500 tiny steps are
   host-bound.

KARANTA_IMG_CACHE_MB is 0 throughout: every page pays its image decode.
Each path's launch counts are set to 0 just before it runs and read just
after. The last two lines are the kernels summary and the result line.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import contextlib
import gc
import glob
import http.client
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.bench.pages import make_page_png, page_messages
from karanta_tpu_torch.bench.randweights import init_params_bench
from karanta_tpu_torch.bench.flash_ab import (BATCHED_PREFILL_LIVE,
                                              BATCHED_VISION_LIVE, PREFIX_LEN,
                                              SP_K, SP_LIVE, SP_Q,
                                              SUFFIX_BUCKET, SUFFIX_LEN,
                                              flash_work)
from karanta_tpu_torch.bench.stream_trace import (AB_BUCKET, AB_FILL,
                                                  STREAM_CHECK_LENS,
                                                  stream_inputs, stream_work)
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.server import (InferenceServer,
                                                build_engine_from_args,
                                                make_arg_parser)
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.kernels.build import build_all
from karanta_tpu_torch.models.qwen25_vl.config import (get_config,
                                                       tiny_config)
from karanta_tpu_torch.models.qwen25_vl.decoder import (Q4KVCache,
                                                        q4_pack_prefill,
                                                        quantize_kv_rows,
                                                        quantize_kv_rows_q4,
                                                        unpack_q4_rows)
from karanta_tpu_torch.models.qwen25_vl.layout import build_vision_layout
from karanta_tpu_torch.models.qwen25_vl.model import init_params
from karanta_tpu_torch.ops import attention as A
from karanta_tpu_torch.ops import decode_attention as DA
from karanta_tpu_torch.ops.image_prep import plan_image
from karanta_tpu_torch.ops.png import encode_png_rgb
from karanta_tpu_torch.ops.rotary import vision_rope_cos_sin
from karanta_tpu_torch.parallel.launch import in_turns, run_ranks
from karanta_tpu_torch.utils.tree import tree_map

# H100 SXM data-sheet peaks: dense bf16 tensor rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# bf16 kernels vs their plain versions: both accumulate in float32 and round
# each output once to bf16, so an element may differ by one bf16 ulp, between
# 2^-8 and 2^-7 of its size. The limit per element is |got - want| <=
# BF16_REL * |want| + BF16_FLOOR * max|want|: one ulp of the element at most,
# plus a floor of a quarter to half an ulp of the largest output, for elements
# near zero.
BF16_REL = 2.0 ** -7
BF16_FLOOR = 2.0 ** -9
F32_ATOL = 1e-4    # float32 kernels vs float32 plain: summation order only
TINY_LOGIT_TOL = 2e-3  # relative to max |logit|: W8A8 rounding may flip

# the engine path's operating point: pages served, decode slots, greedy
# tokens per page, decode steps per host round trip
PAGES = 6
BATCH = 4
MAX_TOKENS = 24
CHUNK = 8
# the served paths: pages of the int8 server, pages per wave of the CLI
# default server, greedy tokens per request
SERVED_PAGES = 6
DEFAULT_WAVE = 4
SERVED_TOKENS = 32
# one fixed instruction of >= 300 bytes before every page: its ~400 tokens
# clear the server's 256-token prefix-cache gate from the second page on
INSTRUCTION = (
    "Below is the image of one page of a document. Return the plain text "
    "representation of this document as if you were reading it naturally. "
    "Keep headings, paragraphs and lists in reading order, render tables as "
    "markdown and equations as LaTeX, and leave out running headers, footers "
    "and page numbers. Do not add text that is not on the page, and keep "
    "every diacritic and special character exactly as printed.\n")


class NoStopTokenizer(ByteTokenizer):
    """Fixed-length decode: eos never fires (bench.py's tokenizer)."""

    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


class CountingTokenizer(NoStopTokenizer):
    """Fixed-length decode whose text spells out every token id as "<id>",
    so the text of a response, or of an SSE stream put together, gives back
    its token count (the byte tokenizer's text drops the 7B vocabulary's ids
    above 271)."""

    def decode(self, ids) -> str:
        return "".join(f"<{int(i)}>" for i in ids)


def n_tokens(text: str) -> int:
    return len(re.findall(r"<\d+>", text))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, in CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call without the host's launch overhead: fn()
    captured `calls` times in a CUDA graph, the graph replayed `replays`
    times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check(name: str, err: float, tol: float) -> None:
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    log(f"  {name}: max abs err {err:.3e} (tol {tol:g}) ok")


def max_err(a: torch.Tensor, b: torch.Tensor, rows=None) -> float:
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max())


def check_bf16(name: str, got: torch.Tensor, want: torch.Tensor,
               rows=None) -> float:
    """Per-element bf16 limit scaled to the reference (see BF16_REL);
    returns the max abs error."""
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    d = (got - want).abs()
    limit = BF16_REL * want.abs() + BF16_FLOOR * float(want.abs().max())
    err, worst = float(d.max()), float((d / limit).max())
    rms = float(want.square().mean().sqrt())
    if not math.isfinite(err) or not worst <= 1.0:
        raise AssertionError(f"{name}: |err| up to {worst:.3g}x its limit "
                             f"(max abs err {err}, reference rms {rms:.3e})")
    log(f"  {name}: max abs err {err:.3e}, worst err/limit {worst:.3f} "
        f"(reference rms {rms:.3e}, max {float(want.abs().max()):.3e}) ok")
    return err


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the "
                         "GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[card] {kind}; count {torch.cuda.device_count()}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return kind


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from karanta_tpu_torch.bench import stream_trace as ST

    t0 = time.perf_counter()
    # the decode streams' instrumented copy (phase 3) compiles beside the
    # sources: it is as long a build as decode_stream.cu, and after them it
    # would run alone
    with ThreadPoolExecutor(1) as pool:
        traced = pool.submit(ST.build_traced)
        secs = build_all()
        traced.result()
    log(f"[build] {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())}, "
        f"with the traced decode streams; wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def _page_layout(cfg):
    plan = plan_image(1288, 994)
    return plan, build_vision_layout(plan, cfg.vision)


def kernel_window(cfg, dev, gen) -> dict:
    """Vision window layer: (1, S, 16, 80) bf16 with the page's rope/mask."""
    _, layout = _page_layout(cfg)
    vc = cfg.vision
    s, h, d, w = len(layout.valid), vc.num_heads, vc.head_dim, \
        vc.window_patches ** 2
    mask = torch.from_numpy(layout.valid).to(dev)[None]
    cos, sin = vision_rope_cos_sin(torch.from_numpy(layout.pos_hw).to(dev), d)
    cos = cos.to(torch.bfloat16).float()[None].contiguous()
    sin = sin.to(torch.bfloat16).float()[None].contiguous()
    q, k, v = (torch.randn((1, s, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    live = mask.reshape(1, s // w, w).amax(-1) > 0
    rows = live.repeat_interleave(w, dim=1)  # rows whose window has a key

    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    err = check_bf16("window_attention 7B (1,5120,16,80) bf16", got, want,
                     rows)
    # small ragged case in float32: 3 windows, a window with no live key
    qs, ks_, vs_ = (torch.randn((2, 192, 3, 16), generator=gen, device=dev)
                    for _ in range(3))
    ms = (torch.rand((2, 192), generator=gen, device=dev) > 0.2).float()
    ms[1, 64:128] = 0.0
    pos = torch.randint(0, 30, (192, 2), generator=gen, device=dev)
    cs, sn = vision_rope_cos_sin(pos, 16)
    cs, sn = cs[None].expand(2, -1, -1).contiguous(), \
        sn[None].expand(2, -1, -1).contiguous()
    rs = (ms.reshape(2, 3, 64).amax(-1) > 0).repeat_interleave(64, dim=1)
    for c, sn_ in ((cs, sn), (None, None)):
        g2 = A.window_attention_kernel_call(qs, ks_, vs_, 64, ms, cos=c,
                                            sin=sn_)
        torch.cuda.synchronize()
        w2 = A.window_attention_plain(qs, ks_, vs_, 64, ms, cos=c, sin=sn_)
        check(f"window_attention ragged f32 rope={c is not None}",
              max_err(g2, w2, rs), F32_ATOL)

    # library yardstick: SDPA over the windows as a batch, key-padding mask
    # (rope applied beforehand: the library call has no fused rope)
    from karanta_tpu_torch.ops.rotary import apply_rope

    qr, kr = apply_rope(q, k, cos, sin)
    nw = s // w

    def windows(x):
        return x.reshape(nw, w, h, d).transpose(1, 2).contiguous()

    qw, kw, vw = windows(qr), windows(kr), windows(v)
    mw = (mask.reshape(nw, 1, 1, w) > 0)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qw, kw, vw, attn_mask=mw)

    def kernel():
        return A.window_attention_kernel_call(q, k, v, w, mask, cos=cos,
                                              sin=sin)

    t_k = cuda_ms(kernel, 20)
    t_dev = graph_ms(kernel)
    t_p = cuda_ms(lambda: A.window_attention_plain(q, k, v, w, mask, cos=cos,
                                                   sin=sin), 5)
    t_l = cuda_ms(lib, 20)
    t_ldev = graph_ms(lib)
    n_bytes = 4 * s * h * d * 2 + 2 * s * d * 4 + s * 4
    flops = 4.0 * w * d * s * h
    b, by = bound_ms(n_bytes, flops)
    # the bf16 instance's device time (a CUDA graph: the wrapper's host time
    # left out), rate, share of the bound and resources
    rates = {"device_ms": t_dev, "library_device_ms": t_ldev,
             "tflops": flops / t_dev * 1e-9, "bound_share": b / t_dev,
             "sdpa_ratio": t_dev / t_ldev,
             "resources": A.window_attention_info(d, w)}
    log(f"  window: kernel {t_k:.4f} ms ({t_dev:.4f} ms of device time), "
        f"{rates['tflops']:.1f} TFLOP/s, {100 * rates['bound_share']:.1f}% "
        f"of the bound {b:.4f} ms; {rates['sdpa_ratio']:.2f}x SDPA's "
        f"{t_ldev:.4f} ms of device time ({t_l:.4f} ms by events); bf16 "
        f"instance {rates['resources']}")
    rates["concat4"] = window_concat(layout, dev, gen, BATCHED_PAGES)
    return dict(name="window_attention", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/window_attention.cu",
                replaces="karanta_tpu/ops/attention.py:403",
                max_abs_err=max(err, rates["concat4"]["max_abs_err"]),
                ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
                library_ms=t_l, **rates)


# batched prefill: pages a group (phase 14's prefill_batch)
BATCHED_PAGES = 4


def window_concat(layout, dev, gen, n: int) -> dict:
    """#1 over n pages' concatenated window-ordered tokens, (1, n x 5120,
    16, 80), each page with its valid mask and rope (batched prefill):
    checked against the plain version on rows whose window has a live key,
    timed beside SDPA over the windows."""
    from karanta_tpu_torch.ops.rotary import apply_rope

    h, d, w = 16, 80, 64
    s = n * len(layout.valid)
    mask = torch.from_numpy(np.concatenate([layout.valid] * n)).to(dev)
    pos = torch.from_numpy(np.concatenate([layout.pos_hw] * n)).to(dev)
    cos, sin = vision_rope_cos_sin(pos, d)
    cos = cos.to(torch.bfloat16).float()[None].contiguous()
    sin = sin.to(torch.bfloat16).float()[None].contiguous()
    mask = mask.float()[None].contiguous()
    q, k, v = (torch.randn((1, s, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    rows = (mask.reshape(1, s // w, w).amax(-1) > 0).repeat_interleave(w, 1)
    got = A.window_attention_kernel_call(q, k, v, w, mask, cos=cos, sin=sin)
    torch.cuda.synchronize()
    want = A.window_attention_plain(q, k, v, w, mask, cos=cos, sin=sin)
    err = check_bf16(f"window_attention batched ({n} pages) "
                     f"{tuple(q.shape)} bf16", got, want, rows)
    qr, kr = apply_rope(q, k, cos, sin)
    qw, kw, vw = (x.reshape(s // w, w, h, d).transpose(1, 2).contiguous()
                  for x in (qr, kr, v))
    mw = mask.reshape(s // w, 1, 1, w) > 0
    def kernel():
        return A.window_attention_kernel_call(q, k, v, w, mask, cos=cos,
                                              sin=sin)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            qw, kw, vw, attn_mask=mw)

    t_k = cuda_ms(kernel, 20)
    t_dev = graph_ms(kernel)
    t_p = cuda_ms(lambda: A.window_attention_plain(q, k, v, w, mask,
                                                   cos=cos, sin=sin), 3)
    t_l = cuda_ms(lib, 20)
    t_ldev = graph_ms(lib)
    b, by = bound_ms(4 * s * h * d * 2 + 2 * s * d * 4 + s * 4,
                     4.0 * w * d * s * h)
    log(f"  window batched ({n} pages): kernel {t_k:.4f} ms ({t_dev:.4f} "
        f"device, {t_dev / n:.4f} a page), {100 * b / t_dev:.1f}% of the "
        f"bound {b:.4f} ms ({by}); plain {t_p:.4f} ms; {t_dev / t_ldev:.2f}x "
        f"SDPA's {t_ldev:.4f} ms of device time ({t_l:.4f} by events)")
    return dict(shape=list(q.shape), max_abs_err=err, ms=t_k, plain_ms=t_p,
                library_ms=t_l, device_ms=t_dev, library_device_ms=t_ldev,
                bound_ms=b, bound_by=by, bound_share=b / t_dev,
                sdpa_ratio=t_dev / t_ldev)


def _flash_case(dev, gen, b, sq, sk, h, kvh, d, dtype, live_len):
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=gen, device=dev).to(dtype)
    mask = torch.zeros((b, sk), device=dev)
    mask[:, :live_len] = 1.0
    return q, k, v, mask


def _sdpa_mask(sq, sk, live_len, causal, dev, q_offset=0):
    m = torch.zeros((sq, sk), dtype=torch.bool, device=dev)
    m[:, :live_len] = True
    if causal:
        m &= torch.ones((sq, sk), dtype=torch.bool,
                        device=dev).tril(diagonal=q_offset)
    return m[None, None]


def kernel_flash(cfg, dev, gen) -> dict:
    """Decoder prefill (1, 1408, 28/4, 128) causal, the vision full layers
    (1, 5120, 16, 80), and the prefix continuation (queries over the 2048
    suffix bucket, keys 384 + 2048, q_offset 384), bf16, with the bench
    page's masks."""
    t, vc = cfg.text, cfg.vision
    _, layout = _page_layout(cfg)
    s_vis = len(layout.valid)
    cases = {
        "prefill": (1, 1408, 1408, t.num_heads, t.num_kv_heads, t.head_dim,
                    1390, True, 0),
        "vision_full": (1, s_vis, s_vis, vc.num_heads, vc.num_heads,
                        vc.head_dim, None, False, 0),
        "prefix": (1, SUFFIX_BUCKET, PREFIX_LEN + SUFFIX_BUCKET, t.num_heads,
                   t.num_kv_heads, t.head_dim, PREFIX_LEN + SUFFIX_LEN, True,
                   PREFIX_LEN),
    }
    errs, times = [], {}
    for name, (b, sq, sk, h, kvh, d, live, causal, q_off) in cases.items():
        q, k, v, mask = _flash_case(dev, gen, b, sq, sk, h, kvh, d,
                                    torch.bfloat16, live or sk)
        if name == "vision_full":  # the page's validity mask
            mask = torch.from_numpy(layout.valid).to(dev)[None]
        got = A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_off)
        errs.append(check_bf16(f"flash_attention {name} {tuple(q.shape)} kv "
                               f"{tuple(k.shape)} q_offset={q_off} bf16",
                               got, want))
        live_len = int(mask[0].sum().item())
        if name == "vision_full":
            # the page's valid keys are scattered over the window-ordered
            # sequence: SDPA takes them as a key-padding mask
            sdpa_mask = (mask > 0)[:, None, None, :]
        else:
            sdpa_mask = _sdpa_mask(sq, sk, live_len, causal, dev, q_off)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def lib(qt=qt, kt=kt, vt=vt, m=sdpa_mask, g=(h != kvh)):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=m, enable_gqa=g)

        def kernel(q=q, k=k, v=v, m=mask, c=causal, o=q_off):
            return A.flash_attention(q, k, v, m, causal=c, q_offset=o)

        times[name] = (
            cuda_ms(kernel, 10),
            cuda_ms(lambda q=q, k=k, v=v, m=mask, c=causal, o=q_off:
                    A.flash_attention_plain(q, k, v, m, causal=c,
                                            q_offset=o), 3),
            cuda_ms(lib, 10),
            flash_work(sq, sk, h, kvh, d, [live_len], causal, q_off),
            graph_ms(kernel), graph_ms(lib))
        log(f"  flash {name}: kernel {times[name][0]:.3f} ms (device "
            f"{times[name][4]:.4f}), plain {times[name][1]:.3f} ms, sdpa "
            f"{times[name][2]:.3f} ms (device {times[name][5]:.4f})")
    # small ragged cases in float32: GQA, mask, q_offset, Sq != Sk
    for (b, sq, sk, h, kvh, d, causal, q_off) in (
            (2, 333, 333, 6, 2, 128, True, 0),
            (1, 77, 200, 4, 1, 16, True, 123),
            (1, 150, 150, 4, 4, 80, False, 0)):
        q, k, v, mask = _flash_case(dev, gen, b, sq, sk, h, kvh, d,
                                    torch.float32, sk - 13)
        got = A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_off)
        check(f"flash_attention ragged f32 {tuple(q.shape)} kv "
              f"{tuple(k.shape)} q_offset={q_off}", max_err(got, want),
              F32_ATOL)
    # the bf16 instance's resources, as the CUDA runtime reports them (the
    # registers a producer and a consumer thread hold after setmaxnreg
    # beside them)
    resources = {d: A.flash_attention_info(d)
                 for d in sorted({t.head_dim, vc.head_dim})}
    for d, info in resources.items():
        log(f"  flash bf16 D={d}: {info}")
    # the row reports the prefill shape (28 of the 32 launches per page);
    # the vision-full and prefix numbers ride along. Shares and ratios
    # from device times (CUDA graphs), which leave the wrappers' host time
    # out
    rates = {}
    for name, (t_k, _, t_l, work, t_dev, t_ldev) in times.items():
        bound, _ = bound_ms(*work)
        rates[name] = {"device_ms": t_dev, "library_device_ms": t_ldev,
                       "tflops": work[1] / t_dev * 1e-9,
                       "bound_share": bound / t_dev,
                       "library_ratio": t_dev / t_ldev}
        log(f"  flash {name}: bound {bound:.4f} ms; kernel device "
            f"{t_dev:.4f} ms, {rates[name]['tflops']:.1f} TFLOP/s on the "
            f"live pairs, {100 * rates[name]['bound_share']:.1f}% of the "
            f"bound; {t_dev / t_ldev:.2f}x SDPA's device time "
            f"({t_k / t_l:.2f}x by events)")
    t_k, t_p, t_l, (n_bytes, flops), _, _ = times["prefill"]
    b, by = bound_ms(n_bytes, flops)
    extra = {name: {"ms": times[name][0], "plain_ms": times[name][1],
                    "library_ms": times[name][2],
                    "bound_ms": bound_ms(*times[name][3])[0], **rates[name]}
             for name in ("vision_full", "prefix")}
    extra["bf16_resources"] = resources
    extra.update(flash_batched(cfg, layout, dev, gen))
    errs += [e["max_abs_err"] for e in extra.values() if "max_abs_err" in e]
    return dict(name="flash_attention", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/flash_attention.cu",
                replaces="karanta_tpu/ops/attention.py:235",
                max_abs_err=max(errs), ms=t_k, plain_ms=t_p, bound_ms=b,
                bound_by=by, library_ms=t_l, **rates["prefill"], **extra)


def flash_batched(cfg, layout, dev, gen) -> dict:
    """#2 at batched prefill's shapes: the vision full layers at (4, 5120,
    16, 80), one validity mask a page, and the decoder prefill at (4, 1408,
    28/4, 128) causal with kv lengths 1390, 700, 1408 and 1; bf16, against
    the plain version, timed beside SDPA with the same masks."""
    t, vc = cfg.text, cfg.vision
    s_vis = len(layout.valid)
    n = BATCHED_PAGES
    out = {}
    for name in ("vision_batched", "prefill_batched"):
        vision = name == "vision_batched"
        if vision:
            sq = sk = s_vis
            h = kvh = vc.num_heads
            d, causal = vc.head_dim, False
            mask = torch.zeros((n, sk), device=dev)
            for i, live in enumerate(BATCHED_VISION_LIVE):
                if live is None:
                    mask[i] = torch.from_numpy(layout.valid).to(dev)
                else:
                    idx = torch.randperm(sk, generator=gen, device=dev)
                    mask[i, idx[:live]] = 1.0
        else:
            sq = sk = 1408
            h, kvh, d, causal = t.num_heads, t.num_kv_heads, t.head_dim, True
            mask = torch.zeros((n, sk), device=dev)
            for i, live in enumerate(BATCHED_PREFILL_LIVE):
                mask[i, :live] = 1.0
        q, k, v, _ = _flash_case(dev, gen, n, sq, sk, h, kvh, d,
                                 torch.bfloat16, sk)
        got = A.flash_attention(q, k, v, mask, causal=causal)
        torch.cuda.synchronize()
        want = A.flash_attention_plain(q, k, v, mask, causal=causal)
        err = check_bf16(f"flash_attention {name} {tuple(q.shape)} kv "
                         f"{tuple(k.shape)} bf16", got, want)
        del got, want
        lives = [int(x) for x in mask.sum(-1).tolist()]
        sdpa_mask = (mask > 0)[:, None, None, :]
        if causal:
            sdpa_mask = sdpa_mask & torch.ones(
                (sq, sk), dtype=torch.bool, device=dev).tril()[None, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        def kernel():
            return A.flash_attention(q, k, v, mask, causal=causal)

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=h != kvh)

        t_k = cuda_ms(kernel, 10)
        t_p = cuda_ms(lambda: A.flash_attention_plain(q, k, v, mask,
                                                      causal=causal), 3)
        t_l = cuda_ms(lib, 10)
        t_dev, t_ldev = graph_ms(kernel, calls=5), graph_ms(lib, calls=5)
        n_bytes, flops = flash_work(sq, sk, h, kvh, d, lives, causal)
        b, by = bound_ms(n_bytes, flops)
        log(f"  flash {name}: live keys {lives}; kernel {t_k:.4f} ms, "
            f"device {t_dev:.4f} ({t_dev / n:.4f} a page, "
            f"{flops / t_dev * 1e-9:.1f} TFLOP/s), {100 * b / t_dev:.1f}% of "
            f"the bound {b:.4f} ms ({by}); plain {t_p:.4f} ms; "
            f"{t_dev / t_ldev:.2f}x SDPA's device {t_ldev:.4f} ms (events "
            f"{t_l:.4f})")
        out[name] = dict(shape=list(q.shape), live=lives, max_abs_err=err,
                         ms=t_k, device_ms=t_dev, plain_ms=t_p, library_ms=t_l,
                         library_device_ms=t_ldev, bound_ms=b, bound_by=by,
                         tflops=flops / t_dev * 1e-9, bound_share=b / t_dev,
                         library_ratio=t_dev / t_ldev)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _decode_inputs(dev, gen, n_layers, b, kvh, m, d, h, lens, dtype):
    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    kq, ks = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    vq, vs = quantize_kv_rows(rows((n_layers, b, kvh, m, d)))
    nkq, nks = quantize_kv_rows(rows((b, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, kvh, d)))
    q = rows((b, 1, h, d)).to(dtype)
    caches = (kq, vq, ks.to(dtype), vs.to(dtype))
    new = (nkq, nvq, nks.to(dtype), nvs.to(dtype))
    return q, new, caches, torch.tensor(lens, dtype=torch.int32, device=dev)


def kernel_decode(cfg, dev, gen, batch: int) -> dict:
    """One decode step of one layer over the 7B int8 cache (28 layers,
    B slots, 4 kv heads, M=1920, D=128), cache_len 0 / mid-block / M-1;
    then the decode A/B point (B = 80, every slot filled to 1,650 rows)."""
    t = cfg.text
    m, layer = 1920, min(5, t.num_layers - 1)
    lens = ([0, 700, m - 1, 1390] * batch)[:batch]
    q, new, caches, lens_t = _decode_inputs(
        dev, gen, t.num_layers, batch, t.num_kv_heads, m, t.head_dim,
        t.num_heads, lens, torch.bfloat16)
    a = [c.clone() for c in caches]
    b_ = [c.clone() for c in caches]
    got = DA.paged_decode_append_quant(q, *new, *a, layer, lens_t)
    torch.cuda.synchronize()
    want = DA.paged_decode_append_quant_plain(q, *new, *b_, layer, lens_t)
    err = check_bf16(f"paged_decode_append_quant 7B B={batch} lens={lens} "
                     f"bf16", got, want)
    for x, y, name in zip(a, b_, ("k", "v", "ks", "vs")):
        if not torch.equal(x, y):
            raise AssertionError(f"decode kernel: cache {name} differs from "
                                 f"the plain version")
    log("  paged_decode_append_quant: all four caches bit-equal")
    # small ragged case in float32 (tiny-config heads: D=16, G=2)
    q2, new2, c2, l2 = _decode_inputs(dev, gen, 2, 3, 2, 200, 16, 4,
                                      [0, 77, 199], torch.float32)
    a2 = [c.clone() for c in c2]
    b2 = [c.clone() for c in c2]
    g2 = DA.paged_decode_append_quant(q2, *new2, *a2, 1, l2)
    torch.cuda.synchronize()
    w2 = DA.paged_decode_append_quant_plain(q2, *new2, *b2, 1, l2)
    check("paged_decode_append_quant ragged f32 (B=3, M=200)",
          max_err(g2, w2), F32_ATOL)
    if not all(torch.equal(x, y) for x, y in zip(a2, b2)):
        raise AssertionError("decode kernel: small-case caches differ")

    t_k = cuda_ms(lambda: DA.paged_decode_append_quant(q, *new, *a, layer,
                                                       lens_t), 50)
    t_dev = graph_ms(lambda: DA.paged_decode_append_quant(q, *new, *a, layer,
                                                          lens_t))
    t_p = cuda_ms(lambda: DA.paged_decode_append_quant_plain(
        q, *new, *b_, layer, lens_t), 5)
    d, kvh, g = t.head_dim, t.num_kv_heads, t.num_heads // t.num_kv_heads

    def work(lens_, b):
        live = sum(lens_)
        n_bytes = (kvh * live * (d + 2) * 2            # old K/V rows + scales
                   + b * kvh * (d + 2) * 2 * 2         # new rows: read + write
                   + 2 * b * t.num_heads * d * 2)      # q in, attn out
        return n_bytes, 4.0 * d * g * kvh * (live + b)

    bd, by = bound_ms(*work(lens, batch))
    res = DA.paged_decode_append_quant_info(d, g, batch, kvh, m)
    del a, b_, caches
    torch.cuda.empty_cache()
    # the second timed shape: the decode A/B point, B = 80 slots each filled
    # to 1,650 of 1,920 rows; two layers of cache (the kernel reads one)
    lens80 = [AB_FILL] * AB_BATCH
    q8, new8, c8, l8 = _decode_inputs(dev, gen, 2, AB_BATCH, kvh, AB_BUCKET,
                                      d, t.num_heads, lens80, torch.bfloat16)
    a8 = [c.clone() for c in c8]
    got8 = DA.paged_decode_append_quant(q8, *new8, *a8, 1, l8)
    torch.cuda.synchronize()
    want8 = DA.paged_decode_append_quant_plain(q8, *new8, *c8, 1, l8)
    err8 = check_bf16(f"paged_decode_append_quant 7B B={AB_BATCH} "
                      f"M={AB_BUCKET} fill {AB_FILL} bf16", got8, want8)
    _check_caches(f"paged_decode_append_quant B={AB_BATCH}", a8, c8)
    t8 = cuda_ms(lambda: DA.paged_decode_append_quant(q8, *new8, *a8, 1, l8),
                 50)
    t8_dev = graph_ms(lambda: DA.paged_decode_append_quant(q8, *new8, *a8, 1,
                                                           l8))
    n8, f8 = work(lens80, AB_BATCH)
    bd8, _ = bound_ms(n8, f8)
    res8 = DA.paged_decode_append_quant_info(d, g, AB_BATCH, kvh, AB_BUCKET)
    del a8, c8
    torch.cuda.empty_cache()
    n4, _ = work(lens, batch)
    rates = {"device_ms": t_dev, "bound_share": bd / t_dev,
             "live_gbps": n4 / t_dev * 1e-6, "run_rows": res["run_rows"],
             "resources": res,
             "b80": {"ms": t8, "device_ms": t8_dev, "bound_ms": bd8,
                     "bound_share": bd8 / t8_dev,
                     "live_gbps": n8 / t8_dev * 1e-6, "max_abs_err": err8,
                     "run_rows": res8["run_rows"]}}
    log(f"  paged_decode_append_quant B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {100 * bd / t_dev:.1f}% of the "
        f"bound {bd:.4f} ms, {n4 / t_dev * 1e-6:.0f} GB/s; B={AB_BATCH}: "
        f"{t8:.4f} ms ({t8_dev:.4f} device), {100 * bd8 / t8_dev:.1f}% of "
        f"its bound {bd8:.4f} ms, {n8 / t8_dev * 1e-6:.0f} GB/s; bf16 "
        f"instance {res}, runs of {res8['run_rows']} rows at B={AB_BATCH}")
    return dict(name="paged_decode_append_quant", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/decode_append_quant.cu",
                replaces="karanta_tpu/ops/decode_attention.py:887",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                bound_by=by, library_ms=None, **rates)


def _check_caches(name: str, got, want) -> None:
    for x, y, part in zip(got, want, ("k", "v", "ks", "vs")):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: cache {part} differs from the "
                                 f"plain version")
    log(f"  {name}: all {len(got)} caches bit-equal")


def kernel_decode_multi(cfg, dev, gen) -> dict:
    """One verify pass of one layer over the 7B int8 cache: T = 4 rows per
    slot (gamma 3) at B = 4, M = 4096 (the served context), cache_len 0, a
    page prompt's length, a longer one and M - T - 1; then B = 32 with
    ragged lengths and the decode A/B point's B = 80, every slot filled to
    1,650 of 1,920 rows (device time, share of the bound, GB/s)."""
    t = cfg.text
    m, layer, batch, tq = 4096, 5, 4, 4
    lens = [0, 1700, 2100, m - tq - 1]
    d, kvh, g = t.head_dim, t.num_kv_heads, t.num_heads // t.num_kv_heads

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(n_layers, b, kvh_, m_, d_, h, tq_, dtype):
        kq, ks = quantize_kv_rows(rows((n_layers, b, kvh_, m_, d_)))
        vq, vs = quantize_kv_rows(rows((n_layers, b, kvh_, m_, d_)))
        nkq, nks = quantize_kv_rows(rows((b, tq_, kvh_, d_)))
        nvq, nvs = quantize_kv_rows(rows((b, tq_, kvh_, d_)))
        q = rows((b, tq_, h, d_)).to(dtype)
        return (q, (nkq, nvq, nks.to(dtype), nvs.to(dtype)),
                (kq, vq, ks.to(dtype), vs.to(dtype)))

    q, new, caches = inputs(t.num_layers, batch, kvh, m, d, t.num_heads, tq,
                            torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    a = [c.clone() for c in caches]
    b_ = [c.clone() for c in caches]
    got = DA.paged_decode_append_multi_quant(q, *new, *a, layer, lens_t)
    torch.cuda.synchronize()
    want = DA.paged_decode_append_multi_quant_plain(q, *new, *b_, layer,
                                                    lens_t)
    err = check_bf16(f"paged_decode_append_multi_quant 7B B={batch} T={tq} "
                     f"lens={lens} bf16", got, want)
    _check_caches("paged_decode_append_multi_quant", a, b_)
    # small ragged case in float32 (tiny-config heads: D=16, G=2, T=5)
    q2, new2, c2 = inputs(2, 3, 2, 200, 16, 4, 5, torch.float32)
    l2 = torch.tensor([0, 77, 194], dtype=torch.int32, device=dev)
    a2 = [c.clone() for c in c2]
    b2 = [c.clone() for c in c2]
    g2 = DA.paged_decode_append_multi_quant(q2, *new2, *a2, 1, l2)
    torch.cuda.synchronize()
    w2 = DA.paged_decode_append_multi_quant_plain(q2, *new2, *b2, 1, l2)
    check("paged_decode_append_multi_quant ragged f32 (B=3, T=5, M=200)",
          max_err(g2, w2), F32_ATOL)
    _check_caches("paged_decode_append_multi_quant ragged", a2, b2)

    t_k = cuda_ms(lambda: DA.paged_decode_append_multi_quant(
        q, *new, *a, layer, lens_t), 50)
    t_dev = graph_ms(lambda: DA.paged_decode_append_multi_quant(
        q, *new, *a, layer, lens_t))
    t_p = cuda_ms(lambda: DA.paged_decode_append_multi_quant_plain(
        q, *new, *b_, layer, lens_t), 5)

    def work(lens_, b):
        n_bytes = (kvh * sum(lens_) * (d + 2) * 2       # old K/V rows + scales
                   + b * tq * kvh * (d + 2) * 2 * 2     # new rows: read + write
                   + 2 * b * tq * t.num_heads * d * 2)  # q in, attn out
        # query t of a slot sees its cache_len old rows and fresh rows 0..t
        pairs = sum(tq * n + tq * (tq + 1) // 2 for n in lens_)
        return n_bytes, 4.0 * d * g * kvh * pairs

    n_bytes, flops = work(lens, batch)
    bd, by = bound_ms(n_bytes, flops)
    resources = DA.paged_decode_append_multi_quant_info(d, g * tq, batch, kvh,
                                                        m)
    del a, b_, caches
    torch.cuda.empty_cache()
    # the second timed shape: B = 32 slots, ragged lengths, two layers of
    # cache (the kernel reads one)
    b32 = 32
    rng = np.random.default_rng(11)
    lens32 = [0, m - tq - 1] + sorted(int(x) for x in rng.integers(
        1, m - tq - 1, b32 - 2))
    q3, new3, c3 = inputs(2, b32, kvh, m, d, t.num_heads, tq, torch.bfloat16)
    l3 = torch.tensor(lens32, dtype=torch.int32, device=dev)
    a3 = [c.clone() for c in c3]
    got3 = DA.paged_decode_append_multi_quant(q3, *new3, *a3, 1, l3)
    torch.cuda.synchronize()
    want3 = DA.paged_decode_append_multi_quant_plain(q3, *new3, *c3, 1, l3)
    err3 = check_bf16(f"paged_decode_append_multi_quant 7B B={b32} T={tq} "
                      f"M={m} ragged bf16", got3, want3)
    _check_caches("paged_decode_append_multi_quant B=32", a3, c3)
    t3 = cuda_ms(lambda: DA.paged_decode_append_multi_quant(
        q3, *new3, *a3, 1, l3), 50)
    t3_dev = graph_ms(lambda: DA.paged_decode_append_multi_quant(
        q3, *new3, *a3, 1, l3))
    n3, f3 = work(lens32, b32)
    bd3, _ = bound_ms(n3, f3)
    res3 = DA.paged_decode_append_multi_quant_info(d, g * tq, b32, kvh, m)
    del a3, c3
    torch.cuda.empty_cache()
    # the third: the decode A/B point's batch, B = 80 slots each filled to
    # 1,650 of the int8 engine's 1,920 rows; two layers of cache
    lens80 = [AB_FILL] * AB_BATCH
    q8, new8, c8 = inputs(2, AB_BATCH, kvh, AB_BUCKET, d, t.num_heads, tq,
                          torch.bfloat16)
    l8 = torch.tensor(lens80, dtype=torch.int32, device=dev)
    a8 = [c.clone() for c in c8]
    got8 = DA.paged_decode_append_multi_quant(q8, *new8, *a8, 1, l8)
    torch.cuda.synchronize()
    want8 = DA.paged_decode_append_multi_quant_plain(q8, *new8, *c8, 1, l8)
    err8 = check_bf16(f"paged_decode_append_multi_quant 7B B={AB_BATCH} "
                      f"T={tq} M={AB_BUCKET} fill {AB_FILL} bf16", got8, want8)
    _check_caches(f"paged_decode_append_multi_quant B={AB_BATCH}", a8, c8)
    t8 = cuda_ms(lambda: DA.paged_decode_append_multi_quant(
        q8, *new8, *a8, 1, l8), 50)
    t8_dev = graph_ms(lambda: DA.paged_decode_append_multi_quant(
        q8, *new8, *a8, 1, l8))
    n8, f8 = work(lens80, AB_BATCH)
    bd8, _ = bound_ms(n8, f8)
    res8 = DA.paged_decode_append_multi_quant_info(d, g * tq, AB_BATCH, kvh,
                                                   AB_BUCKET)
    del a8, c8
    torch.cuda.empty_cache()
    rates = {"device_ms": t_dev, "live_gbps": n_bytes / t_dev * 1e-6,
             "bound_share": bd / t_dev, "resources": resources,
             "b32": {"ms": t3, "device_ms": t3_dev, "bound_ms": bd3,
                     "bound_share": bd3 / t3_dev,
                     "live_gbps": n3 / t3_dev * 1e-6,
                     "max_abs_err": err3, "run_rows": res3["run_rows"]},
             "b80": {"ms": t8, "device_ms": t8_dev, "bound_ms": bd8,
                     "bound_share": bd8 / t8_dev,
                     "live_gbps": n8 / t8_dev * 1e-6,
                     "max_abs_err": err8, "run_rows": res8["run_rows"]}}
    log(f"  paged_decode_append_multi_quant B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {rates['live_gbps']:.0f} GB/s of "
        f"live bytes, {100 * rates['bound_share']:.1f}% of the bound "
        f"{bd:.4f} ms; B={b32}: {t3:.4f} ms ({t3_dev:.4f} device), "
        f"{100 * bd3 / t3_dev:.1f}% of its bound {bd3:.4f} ms, "
        f"{n3 / t3_dev * 1e-6:.0f} GB/s; B={AB_BATCH} fill {AB_FILL}: "
        f"{t8:.4f} ms ({t8_dev:.4f} device), {100 * bd8 / t8_dev:.1f}% of "
        f"its bound {bd8:.4f} ms, {n8 / t8_dev * 1e-6:.0f} GB/s; bf16 "
        f"instance {resources}, runs of {res3['run_rows']} rows at B={b32}, "
        f"{res8['run_rows']} at B={AB_BATCH}")
    return dict(name="paged_decode_append_multi_quant", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/"
                       "decode_append_multi_quant.cu",
                replaces="karanta_tpu/ops/decode_attention.py:1245",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                bound_by=by, library_ms=None, **rates)


def kernel_append(cfg, dev, gen) -> dict:
    """One decode step of one layer over the 7B bf16 cache at the CLI
    defaults: B = 32 slots, M = 4096, ragged lengths from 0 to M - 1. Four
    layers of cache stand in for 28 (the kernel reads one)."""
    t = cfg.text
    m, n_layers, layer, batch = 4096, 4, 3, 32
    d, kvh, h = t.head_dim, t.num_kv_heads, t.num_heads
    rng = np.random.default_rng(5)
    lens = [0, m - 1] + sorted(int(x) for x in rng.integers(1, m - 1,
                                                            batch - 2))

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def inputs(n_l, b, kvh_, m_, d_, h_, dtype):
        return (randn((b, 1, h_, d_), dtype), randn((b, kvh_, d_), dtype),
                randn((b, kvh_, d_), dtype),
                randn((n_l, b, kvh_, m_, d_), dtype),
                randn((n_l, b, kvh_, m_, d_), dtype))

    q, nk, nv, kc, vc = inputs(n_layers, batch, kvh, m, d, h, torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    a = [kc.clone(), vc.clone()]
    b_ = [kc, vc]
    got = DA.paged_decode_append(q, nk, nv, *a, layer, lens_t)
    torch.cuda.synchronize()
    want = DA.paged_decode_append_plain(q, nk, nv, *b_, layer, lens_t)
    err = check_bf16(f"paged_decode_append 7B B={batch} M={m} ragged bf16",
                     got, want)
    _check_caches("paged_decode_append", a, b_)
    # small ragged case in float32 (tiny-config heads: D=16, G=2)
    q2, nk2, nv2, k2, v2 = inputs(2, 3, 2, 200, 16, 4, torch.float32)
    l2 = torch.tensor([0, 77, 199], dtype=torch.int32, device=dev)
    a2 = [k2.clone(), v2.clone()]
    b2 = [k2, v2]
    g2 = DA.paged_decode_append(q2, nk2, nv2, *a2, 1, l2)
    torch.cuda.synchronize()
    w2 = DA.paged_decode_append_plain(q2, nk2, nv2, *b2, 1, l2)
    check("paged_decode_append ragged f32 (B=3, M=200)", max_err(g2, w2),
          F32_ATOL)
    _check_caches("paged_decode_append ragged", a2, b2)

    t_k = cuda_ms(lambda: DA.paged_decode_append(q, nk, nv, *a, layer,
                                                 lens_t), 50)
    t_dev = graph_ms(lambda: DA.paged_decode_append(q, nk, nv, *a, layer,
                                                    lens_t))
    t_p = cuda_ms(lambda: DA.paged_decode_append_plain(q, nk, nv, *b_, layer,
                                                       lens_t), 5)
    live = sum(lens)
    n_bytes = (kvh * live * d * 2 * 2             # old K/V rows
               + batch * kvh * d * 2 * 2 * 2      # new rows: read + write
               + 2 * batch * h * d * 2)           # q in, attn out
    flops = 4.0 * d * h * (live + batch)
    bd, by = bound_ms(n_bytes, flops)
    # #9's yardstick, for context only (no PyTorch call appends): SDPA over
    # the bucket with this step's row already in the cache
    mask = (torch.arange(m, device=dev)[None, :]
            <= lens_t[:, None].long())[:, None, None, :]      # (B, 1, 1, M)
    qt = q.transpose(1, 2)
    t_sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, a[0][layer], a[1][layer], attn_mask=mask, enable_gqa=True), 20)
    resources = DA.paged_decode_append_info(d, h // kvh)
    rates = {"device_ms": t_dev, "live_gbps": n_bytes / t_k * 1e-6,
             "bound_share": bd / t_k, "sdpa_after_scatter_ms": t_sdpa,
             "sdpa_ratio": t_k / t_sdpa, "resources": resources}
    log(f"  paged_decode_append: kernel {t_k:.4f} ms ({t_dev:.4f} ms of "
        f"device time), {rates['live_gbps']:.0f} GB/s of live bytes, "
        f"{100 * rates['bound_share']:.1f}% of the bound {bd:.4f} ms; "
        f"{rates['sdpa_ratio']:.2f}x SDPA's {t_sdpa:.4f} ms over the bucket "
        f"with the row scattered (no append); bf16 instance {resources}")
    return dict(name="paged_decode_append", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/decode_append.cu",
                replaces="karanta_tpu/ops/decode_attention.py:582",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                bound_by=by, library_ms=None, **rates)


def _q4_live_rows(n: int) -> int:
    """Packed rows holding a token below n (whole windows, then the partial
    window's rows whose low token is live)."""
    return (n // 64) * 32 + min(n % 64, 32)


def _q4_inputs(dev, gen, n_layers, b, kvh, m, d, h, tq, dtype):
    """int4 caches as an insert writes them (random rows, quantized and
    nibble-packed), new rows quantized to int4 (leading shape (b,) for
    tq None, else (b, tq)), and q."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    k4, v4, ks4, vs4 = q4_pack_prefill(randn((n_layers, b, kvh, m, d)),
                                       randn((n_layers, b, kvh, m, d)))
    lead = (b,) if tq is None else (b, tq)
    nkq, nks = quantize_kv_rows_q4(randn(lead + (kvh, d)))
    nvq, nvs = quantize_kv_rows_q4(randn(lead + (kvh, d)))
    q = randn((b, 1 if tq is None else tq, h, d)).to(dtype)
    return (q, (nkq, nvq, nks.to(dtype), nvs.to(dtype)),
            (k4, v4, ks4.to(dtype), vs4.to(dtype)))


def _q4_bytes(lens, kvh, d, h, b, tq, esize=2) -> int:
    """Bytes of an int4 append call: the live packed K/V rows and their
    tokens' scales read once, each fresh byte row read and written with its
    scales, q in and attention out."""
    old = sum(kvh * (_q4_live_rows(n) * d * 2 + n * 2 * esize) for n in lens)
    fresh = b * tq * kvh * (d * 2 + 2 * esize) * 2
    return old + fresh + 2 * b * tq * h * d * esize


def kernel_q4(cfg, dev, gen) -> dict:
    """One decode step of one layer over the 7B int4 cache: B = 4, M = 2048,
    kernel #3's lengths (0, mid-window, 1919, a page prompt); four layers of
    cache stand in for 28 (the kernel reads one). Then the window
    boundaries, then the served int4 point's B = 8 over its 4,096-token
    context with ragged lengths (device time, share of the bound, GB/s)."""
    t = cfg.text
    m, n_layers, layer, batch = 2048, 4, 3, 4
    lens = [0, 700, 1919, 1390]
    d, kvh, h = t.head_dim, t.num_kv_heads, t.num_heads
    q, new, caches = _q4_inputs(dev, gen, n_layers, batch, kvh, m, d, h, None,
                                torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    a = [c.clone() for c in caches]
    b_ = [c.clone() for c in caches]
    got = DA.paged_decode_append_q4(q, *new, *a, layer, lens_t)
    torch.cuda.synchronize()
    want = DA.paged_decode_append_q4_plain(q, *new, *b_, layer, lens_t)
    err = check_bf16(f"paged_decode_append_q4 7B B={batch} M={m} lens={lens} "
                     f"bf16", got, want)
    _check_caches("paged_decode_append_q4", a, b_)
    # small ragged case in float32 (tiny-config heads: D=16, G=2), every
    # length on or beside a 32-row or 64-token window boundary
    small = [0, 1, 31, 32, 33, 63, 64, 127]
    q2, new2, c2 = _q4_inputs(dev, gen, 2, len(small), 2, 128, 16, 4, None,
                              torch.float32)
    l2 = torch.tensor(small, dtype=torch.int32, device=dev)
    a2 = [c.clone() for c in c2]
    b2 = [c.clone() for c in c2]
    g2 = DA.paged_decode_append_q4(q2, *new2, *a2, 1, l2)
    torch.cuda.synchronize()
    w2 = DA.paged_decode_append_q4_plain(q2, *new2, *b2, 1, l2)
    check(f"paged_decode_append_q4 ragged f32 (M=128, lens {small})",
          max_err(g2, w2), F32_ATOL)
    _check_caches("paged_decode_append_q4 ragged", a2, b2)

    t_k = cuda_ms(lambda: DA.paged_decode_append_q4(q, *new, *a, layer,
                                                    lens_t), 50)
    t_dev = graph_ms(lambda: DA.paged_decode_append_q4(q, *new, *a, layer,
                                                       lens_t))
    t_p = cuda_ms(lambda: DA.paged_decode_append_q4_plain(
        q, *new, *b_, layer, lens_t), 5)

    def work(lens_, b):
        return (_q4_bytes(lens_, kvh, d, h, b, 1),
                4.0 * d * h * sum(n + 1 for n in lens_))

    bd, by = bound_ms(*work(lens, batch))
    g = h // kvh
    res = DA.paged_decode_append_q4_info(d, g, batch, kvh, m)
    del a, b_, caches
    torch.cuda.empty_cache()
    # the second timed shape: the served int4 point's 8 slots over its
    # 4,096-token context, ragged lengths up to M - 1; two layers of cache
    # (the kernel reads one)
    b8, m8 = 8, 4096
    rng = np.random.default_rng(17)
    lens8 = [0, m8 - 1] + sorted(int(x) for x in rng.integers(
        1, m8 - 1, b8 - 2))
    q8, new8, c8 = _q4_inputs(dev, gen, 2, b8, kvh, m8, d, h, None,
                              torch.bfloat16)
    l8 = torch.tensor(lens8, dtype=torch.int32, device=dev)
    a8 = [c.clone() for c in c8]
    got8 = DA.paged_decode_append_q4(q8, *new8, *a8, 1, l8)
    torch.cuda.synchronize()
    want8 = DA.paged_decode_append_q4_plain(q8, *new8, *c8, 1, l8)
    err8 = check_bf16(f"paged_decode_append_q4 7B B={b8} M={m8} ragged "
                      f"bf16", got8, want8)
    _check_caches("paged_decode_append_q4 B=8", a8, c8)
    t8 = cuda_ms(lambda: DA.paged_decode_append_q4(q8, *new8, *a8, 1, l8),
                 50)
    t8_dev = graph_ms(lambda: DA.paged_decode_append_q4(q8, *new8, *a8, 1,
                                                        l8))
    n8, f8 = work(lens8, b8)
    bd8, _ = bound_ms(n8, f8)
    res8 = DA.paged_decode_append_q4_info(d, g, b8, kvh, m8)
    del a8, c8
    torch.cuda.empty_cache()
    rates = {"device_ms": t_dev, "bound_share": bd / t_dev,
             "resources": res,
             "b8": {"ms": t8, "device_ms": t8_dev, "bound_ms": bd8,
                    "bound_share": bd8 / t8_dev,
                    "live_gbps": n8 / t8_dev * 1e-6, "max_abs_err": err8,
                    "run_tokens": res8["run_tokens"], "lens": lens8}}
    log(f"  paged_decode_append_q4 B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {100 * bd / t_dev:.1f}% of the "
        f"bound {bd:.5f} ms; B={b8} M={m8}: {t8:.4f} ms ({t8_dev:.4f} "
        f"device), {100 * bd8 / t8_dev:.1f}% of its bound {bd8:.5f} ms, "
        f"{n8 / t8_dev * 1e-6:.0f} GB/s; bf16 instance {res}, runs of "
        f"{res8['run_tokens']} tokens at B={b8}")
    return dict(name="paged_decode_append_q4", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/decode_append_q4.cu",
                replaces="karanta_tpu/ops/decode_attention.py:1622",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                bound_by=by, library_ms=None, **rates)


def kernel_multi_q4(cfg, dev, gen) -> dict:
    """One verify pass of one layer over the 7B int4 cache: T = 4, B = 4,
    M = 4096 (the served context), cache_len 0, a page prompt's length, a
    longer one and M - T - 1. Then spans that cross the 32-row tile and the
    64-token window (the JAX package's own cases)."""
    t = cfg.text
    m, n_layers, layer, batch, tq = 4096, 4, 3, 4, 4
    lens = [0, 1700, 2100, m - tq - 1]
    d, kvh, h = t.head_dim, t.num_kv_heads, t.num_heads
    q, new, caches = _q4_inputs(dev, gen, n_layers, batch, kvh, m, d, h, tq,
                                torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    a = [c.clone() for c in caches]
    b_ = [c.clone() for c in caches]
    got = DA.paged_decode_append_multi_q4(q, *new, *a, layer, lens_t)
    torch.cuda.synchronize()
    want = DA.paged_decode_append_multi_q4_plain(q, *new, *b_, layer, lens_t)
    err = check_bf16(f"paged_decode_append_multi_q4 7B B={batch} T={tq} "
                     f"lens={lens} bf16", got, want)
    _check_caches("paged_decode_append_multi_q4", a, b_)
    for tq2, small in ((5, [31, 32, 63, 127]), (4, [60, 62, 95, 126])):
        q2, new2, c2 = _q4_inputs(dev, gen, 2, 4, 2, 256, 16, 4, tq2,
                                  torch.float32)
        l2 = torch.tensor(small, dtype=torch.int32, device=dev)
        a2 = [c.clone() for c in c2]
        b2 = [c.clone() for c in c2]
        g2 = DA.paged_decode_append_multi_q4(q2, *new2, *a2, 1, l2)
        torch.cuda.synchronize()
        w2 = DA.paged_decode_append_multi_q4_plain(q2, *new2, *b2, 1, l2)
        check(f"paged_decode_append_multi_q4 ragged f32 (T={tq2}, lens "
              f"{small})", max_err(g2, w2), F32_ATOL)
        _check_caches("paged_decode_append_multi_q4 ragged", a2, b2)

    t_k = cuda_ms(lambda: DA.paged_decode_append_multi_q4(
        q, *new, *a, layer, lens_t), 50)
    t_dev = graph_ms(lambda: DA.paged_decode_append_multi_q4(
        q, *new, *a, layer, lens_t))
    t_p = cuda_ms(lambda: DA.paged_decode_append_multi_q4_plain(
        q, *new, *b_, layer, lens_t), 5)

    def work(lens_, b):
        pairs = sum(tq * n + tq * (tq + 1) // 2 for n in lens_)
        return _q4_bytes(lens_, kvh, d, h, b, tq), 4.0 * d * h * pairs

    bd, by = bound_ms(*work(lens, batch))
    g = h // kvh
    res = DA.paged_decode_append_multi_q4_info(d, g * tq, batch, kvh, m)
    del a, b_, caches
    torch.cuda.empty_cache()
    # the second timed shape: the served int4 point's 8 slots, ragged
    # lengths up to M - T - 1; two layers of cache (the kernel reads one)
    b8 = 8
    rng = np.random.default_rng(13)
    lens8 = [0, m - tq - 1] + sorted(int(x) for x in rng.integers(
        1, m - tq - 1, b8 - 2))
    q8, new8, c8 = _q4_inputs(dev, gen, 2, b8, kvh, m, d, h, tq,
                              torch.bfloat16)
    l8 = torch.tensor(lens8, dtype=torch.int32, device=dev)
    a8 = [c.clone() for c in c8]
    got8 = DA.paged_decode_append_multi_q4(q8, *new8, *a8, 1, l8)
    torch.cuda.synchronize()
    want8 = DA.paged_decode_append_multi_q4_plain(q8, *new8, *c8, 1, l8)
    err8 = check_bf16(f"paged_decode_append_multi_q4 7B B={b8} T={tq} M={m} "
                      f"ragged bf16", got8, want8)
    _check_caches("paged_decode_append_multi_q4 B=8", a8, c8)
    t8 = cuda_ms(lambda: DA.paged_decode_append_multi_q4(
        q8, *new8, *a8, 1, l8), 50)
    t8_dev = graph_ms(lambda: DA.paged_decode_append_multi_q4(
        q8, *new8, *a8, 1, l8))
    n8, f8 = work(lens8, b8)
    bd8, _ = bound_ms(n8, f8)
    res8 = DA.paged_decode_append_multi_q4_info(d, g * tq, b8, kvh, m)
    del a8, c8
    torch.cuda.empty_cache()
    rates = {"device_ms": t_dev, "bound_share": bd / t_dev,
             "resources": res,
             "b8": {"ms": t8, "device_ms": t8_dev, "bound_ms": bd8,
                    "bound_share": bd8 / t8_dev,
                    "live_gbps": n8 / t8_dev * 1e-6, "max_abs_err": err8,
                    "run_tokens": res8["run_tokens"]}}
    log(f"  paged_decode_append_multi_q4 B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {100 * bd / t_dev:.1f}% of the "
        f"bound {bd:.4f} ms; B={b8}: {t8:.4f} ms ({t8_dev:.4f} device), "
        f"{100 * bd8 / t8_dev:.1f}% of its bound {bd8:.4f} ms, "
        f"{n8 / t8_dev * 1e-6:.0f} GB/s; bf16 instance {res}, runs of "
        f"{res8['run_tokens']} tokens at B={b8}")
    return dict(name="paged_decode_append_multi_q4", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/"
                       "decode_append_multi_q4.cu",
                replaces="karanta_tpu/ops/decode_attention.py:1998",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                bound_by=by, library_ms=None, **rates)


def kernel_read_only(cfg, dev, gen) -> list:
    """Kernels #8 and #9 at the CLI defaults' decode shape: B = 32 slots,
    M = 4096, ragged lengths from 0 to M - 1 (this step's row already at
    cache_len). #8 over a per-slot cache (B, KVH, M, D), #9 over layer 3 of
    a four-layer stacked cache. The library yardstick: one
    scaled_dot_product_attention call over the bucket with a boolean length
    mask."""
    t = cfg.text
    m, n_layers, layer, batch = 4096, 4, 3, 32
    d, kvh, h = t.head_dim, t.num_kv_heads, t.num_heads
    rng = np.random.default_rng(7)
    lens = [0, m - 1] + sorted(int(x) for x in rng.integers(1, m - 1,
                                                            batch - 2))

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q = randn((batch, 1, h, d))
    kc, vc = randn((n_layers, batch, kvh, m, d)), randn((n_layers, batch, kvh,
                                                         m, d))
    k1, v1 = kc[layer].clone(), vc[layer].clone()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    k0, v0 = kc.clone(), vc.clone()
    want = DA.paged_decode_attention_plain(q, k1, v1, lens_t)
    got8 = DA.paged_decode_attention(q, k1, v1, lens_t)
    got9 = DA.paged_decode_attention_stacked(q, kc, vc, layer, lens_t)
    torch.cuda.synchronize()
    want9 = DA.paged_decode_attention_stacked_plain(q, kc, vc, layer, lens_t)
    err8 = check_bf16(f"paged_decode_attention 7B B={batch} M={m} ragged "
                      f"bf16", got8, want)
    err9 = check_bf16(f"paged_decode_attention_stacked 7B B={batch} M={m} "
                      f"layer {layer} ragged bf16", got9, want9)
    if not (torch.equal(kc, k0) and torch.equal(vc, v0)):
        raise AssertionError("paged_decode_attention_stacked wrote its cache")
    # small ragged case in float32 (tiny-config heads: D=16, G=2)
    q2 = randn((3, 1, 4, 16), torch.float32)
    k2 = randn((2, 3, 2, 200, 16), torch.float32)
    v2 = randn((2, 3, 2, 200, 16), torch.float32)
    l2 = torch.tensor([0, 77, 199], dtype=torch.int32, device=dev)
    w2 = DA.paged_decode_attention_stacked_plain(q2, k2, v2, 1, l2)
    for name, g2 in (("paged_decode_attention",
                      DA.paged_decode_attention(q2, k2[1].contiguous(),
                                                v2[1].contiguous(), l2)),
                     ("paged_decode_attention_stacked",
                      DA.paged_decode_attention_stacked(q2, k2, v2, 1, l2))):
        torch.cuda.synchronize()
        check(f"{name} ragged f32 (B=3, M=200)", max_err(g2, w2), F32_ATOL)

    mask = (torch.arange(m, device=dev)[None, :]
            <= lens_t[:, None].long())[:, None, None, :]      # (B, 1, 1, M)
    qt = q.transpose(1, 2)

    def lib(kk, vv):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kk, vv, attn_mask=mask, enable_gqa=True)

    live = sum(n + 1 for n in lens)
    n_bytes = kvh * live * d * 2 * 2 + 2 * batch * h * d * 2
    bd, by = bound_ms(n_bytes, 4.0 * d * h * live)
    resources = DA.paged_decode_attention_info(d, h // kvh)
    rows = []
    for name, err, kernel, plain, args, line in (
            ("paged_decode_attention", err8, DA.paged_decode_attention,
             DA.paged_decode_attention_plain, (q, k1, v1, lens_t), 120),
            ("paged_decode_attention_stacked", err9,
             DA.paged_decode_attention_stacked,
             DA.paged_decode_attention_stacked_plain,
             (q, kc, vc, layer, lens_t), 272)):
        t_k = cuda_ms(lambda: kernel(*args), 50)
        t_dev = graph_ms(lambda: kernel(*args))
        t_p = cuda_ms(lambda: plain(*args), 5)
        t_l = cuda_ms(lambda: lib(k1, v1) if line == 120
                      else lib(kc[layer], vc[layer]), 20)
        # the bf16 instance's rate over the live bytes, share of the bound
        rates = {"device_ms": t_dev, "live_gbps": n_bytes / t_k * 1e-6,
                 "bound_share": bd / t_k, "sdpa_ratio": t_k / t_l,
                 "resources": resources}
        log(f"  {name}: kernel {t_k:.4f} ms ({t_dev:.4f} ms of device "
            f"time), {rates['live_gbps']:.0f} GB/s "
            f"of live bytes, {100 * rates['bound_share']:.1f}% of the bound "
            f"{bd:.4f} ms; {rates['sdpa_ratio']:.2f}x SDPA's {t_l:.4f} ms; "
            f"bf16 instance {resources}")
        rows.append(dict(name=name, route="cuda",
                         source="karanta_tpu_torch/kernels/csrc/"
                                "decode_attention.cu",
                         replaces=f"karanta_tpu/ops/decode_attention.py:"
                                  f"{line}",
                         max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                         bound_by=by, library_ms=t_l, **rates))
    return rows


# ---------------------------------------------------------------------------
# kernels #10 and #11 and the decode-stream A/B (ops/decode_stream.py)
# ---------------------------------------------------------------------------

# the JAX package's decode A/B point (scratch/mega_meas.py): 80 slots, the
# 1920-row bucket filled to 1650 rows (bench/stream_trace.py), 20 chained
# steps per variant
# ---------------------------------------------------------------------------
# phase 3, per-rank shapes: the serving kernels as one rank of tensor-parallel
# serving launches them (phase 15)
# ---------------------------------------------------------------------------

PER_RANK_TP = (2, 4)
PER_RANK_B, PER_RANK_T = 4, 4


def _per_rank_row(label: str, kernel, plain, work, lib=None, caches=None,
                  graph: bool = False) -> dict:
    """Check kernel() against plain() (its caches, when it writes some,
    bit-equal), then time both, the library call and the bound."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = check_bf16(label, got, want)
    if caches is not None:
        _check_caches(label, *caches)
    t_k = cuda_ms(kernel, 20)
    t_dev = graph_ms(kernel) if graph else t_k
    t_p = cuda_ms(plain, 3)
    t_l = cuda_ms(lib, 20) if lib is not None else None
    t_ldev = (graph_ms(lib) if graph else t_l) if lib is not None else None
    b, by = bound_ms(*work)
    ratio = "" if lib is None else f", {t_dev / t_ldev:.2f}x the library's"
    log(f"    {label}: kernel {t_k:.4f} ms (device {t_dev:.4f}), plain "
        f"{t_p:.4f}, library {t_l if t_l is None else round(t_l, 4)}"
        f"{'' if lib is None or not graph else f' (device {t_ldev:.4f})'}, "
        f"bound {b:.4f} ms ({by}), {100 * b / t_dev:.1f}% of it{ratio}")
    return {"max_abs_err": err, "ms": t_k, "device_ms": t_dev,
            "plain_ms": t_p, "library_ms": t_l, "library_device_ms": t_ldev,
            "bound_ms": b, "bound_by": by, "bound_share": b / t_dev,
            "library_ratio": None if lib is None else t_dev / t_ldev}


def kernel_per_rank(cfg, dev, gen) -> dict:
    """Kernels #1-#7 and #9 at one rank's shapes of tensor-parallel serving
    of the 7B config, tp = 2 and 4: vision heads 16/tp, decoder q heads
    28/tp over kv heads 4/tp (the GQA group stays 7). #1 and #2 at the
    page's shapes (window and full vision layers, the decoder prefill and
    the prefix continuation); the decode kernels at B = 4 over one layer of
    a two-layer cache, M = 1920 (int4: 2048), lengths 0, 700, a page prompt
    and the bucket's end; the verify kernels at T = 4. Returns
    {kernel: {"tp2": row, "tp4": row}}."""
    t, vc = cfg.text, cfg.vision
    _, layout = _page_layout(cfg)
    s_vis, w = len(layout.valid), vc.window_patches ** 2
    vmask = torch.from_numpy(layout.valid).to(dev)[None]
    cos, sin = vision_rope_cos_sin(torch.from_numpy(layout.pos_hw).to(dev),
                                   vc.head_dim)
    cos = cos.to(torch.bfloat16).float()[None].contiguous()
    sin = sin.to(torch.bfloat16).float()[None].contiguous()
    b, tq, d = PER_RANK_B, PER_RANK_T, t.head_dim
    out: dict = {}

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def add(name, tp, row):
        out.setdefault(name, {})[f"tp{tp}"] = row

    for tp in PER_RANK_TP:
        h, kvh, vh = t.num_heads // tp, t.num_kv_heads // tp, \
            vc.num_heads // tp
        log(f"  per-rank shapes, tp={tp}: vision heads {vh}, decoder heads "
            f"{h} over {kvh} kv heads")
        # #1: window layers, rope fused
        q, k, v = (randn((1, s_vis, vh, vc.head_dim)) for _ in range(3))
        from karanta_tpu_torch.ops.rotary import apply_rope

        qr, kr = apply_rope(q, k, cos, sin)
        nw = s_vis // w

        def windows(x):
            return x.reshape(nw, w, vh, vc.head_dim).transpose(1, 2) \
                .contiguous()

        qw, kw, vw = windows(qr), windows(kr), windows(v)
        mw = vmask.reshape(nw, 1, 1, w) > 0
        add("window_attention", tp, _per_rank_row(
            f"window_attention tp={tp} (1,{s_vis},{vh},{vc.head_dim})",
            lambda: A.window_attention_kernel_call(q, k, v, w, vmask,
                                                   cos=cos, sin=sin),
            lambda: A.window_attention_plain(q, k, v, w, vmask, cos=cos,
                                             sin=sin),
            (4 * s_vis * vh * vc.head_dim * 2 + 2 * s_vis * vc.head_dim * 4
             + s_vis * 4, 4.0 * w * vc.head_dim * s_vis * vh),
            lib=lambda: torch.nn.functional.scaled_dot_product_attention(
                qw, kw, vw, attn_mask=mw),
            graph=True))
        del q, k, v, qr, kr, qw, kw, vw
        # #2: the vision full layers, the decoder prefill, the prefix
        for dd in sorted({vc.head_dim, d}):
            log(f"    flash bf16 D={dd}: {A.flash_attention_info(dd)}")
        flash = {}
        for case, (sq, sk, hq, hk, dd, live, causal, q_off) in {
                "vision_full": (s_vis, s_vis, vh, vh, vc.head_dim, None,
                                False, 0),
                "prefill": (1408, 1408, h, kvh, d, 1390, True, 0),
                "prefix": (SUFFIX_BUCKET, PREFIX_LEN + SUFFIX_BUCKET, h, kvh,
                           d, PREFIX_LEN + SUFFIX_LEN, True, PREFIX_LEN),
        }.items():
            q, k, v, mask = _flash_case(dev, gen, 1, sq, sk, hq, hk, dd,
                                        torch.bfloat16, live or sk)
            if case == "vision_full":
                mask = vmask
                sdpa_mask = (mask > 0)[:, None, None, :]
            else:
                sdpa_mask = _sdpa_mask(sq, sk, live, causal, dev, q_off)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            live_len = int(mask[0].sum().item())
            flash[case] = _per_rank_row(
                f"flash_attention {case} tp={tp} {tuple(q.shape)} kv "
                f"{tuple(k.shape)}",
                lambda q=q, k=k, v=v, m=mask, c=causal, o=q_off:
                    A.flash_attention(q, k, v, m, causal=c, q_offset=o),
                lambda q=q, k=k, v=v, m=mask, c=causal, o=q_off:
                    A.flash_attention_plain(q, k, v, m, causal=c,
                                            q_offset=o),
                flash_work(sq, sk, hq, hk, dd, [live_len], causal, q_off),
                lib=lambda qt=qt, kt=kt, vt=vt, m=sdpa_mask, g=hq != hk:
                    torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=m, enable_gqa=g),
                graph=True)
            del q, k, v, qt, kt, vt
        add("flash_attention", tp, {**flash["prefill"], "cases": flash})
        # #3 and #4: the int8 cache
        m = 1920
        lens = [0, 700, 1390, m - tq - 1]
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = sum(lens)
        q1, new1, caches, _ = _decode_inputs(dev, gen, 2, b, kvh, m, d, h,
                                             lens, torch.bfloat16)
        a, c = [x.clone() for x in caches], [x.clone() for x in caches]
        n3 = (kvh * live * (d + 2) * 2 + b * kvh * (d + 2) * 4
              + 2 * b * h * d * 2)
        add("paged_decode_append_quant", tp, _per_rank_row(
            f"paged_decode_append_quant tp={tp} B={b} H={h} KVH={kvh}",
            lambda: DA.paged_decode_append_quant(q1, *new1, *a, 1, lens_t),
            lambda: DA.paged_decode_append_quant_plain(q1, *new1, *c, 1,
                                                       lens_t),
            (n3, 4.0 * d * h * (live + b)), caches=(a, c), graph=True))
        row3 = out["paged_decode_append_quant"][f"tp{tp}"]
        row3["live_gbps"] = n3 / row3["device_ms"] * 1e-6
        row3["resources"] = DA.paged_decode_append_quant_info(d, h // kvh, b,
                                                              kvh, m)
        log(f"    paged_decode_append_quant tp={tp}: "
            f"{row3['live_gbps']:.0f} GB/s; bf16 instance "
            f"{row3['resources']}")
        qm = randn((b, tq, h, d))
        nk, nks = quantize_kv_rows(randn((b, tq, kvh, d), torch.float32))
        nv, nvs = quantize_kv_rows(randn((b, tq, kvh, d), torch.float32))
        newm = (nk, nv, nks, nvs)
        a, c = [x.clone() for x in caches], [x.clone() for x in caches]
        add("paged_decode_append_multi_quant", tp, _per_rank_row(
            f"paged_decode_append_multi_quant tp={tp} B={b} T={tq} H={h} "
            f"KVH={kvh}",
            lambda: DA.paged_decode_append_multi_quant(qm, *newm, *a, 1,
                                                       lens_t),
            lambda: DA.paged_decode_append_multi_quant_plain(qm, *newm, *c,
                                                             1, lens_t),
            (kvh * live * (d + 2) * 2 + b * tq * kvh * (d + 2) * 4
             + 2 * b * tq * h * d * 2,
             4.0 * d * h * (live * tq + b * tq * (tq + 1) // 2)),
            caches=(a, c), graph=True))
        del caches, a, c
        # #5 and #9: the cache in the activations' dtype
        kc, vc_ = randn((2, b, kvh, m, d)), randn((2, b, kvh, m, d))
        nk5, nv5 = randn((b, kvh, d)), randn((b, kvh, d))
        a, c = [kc.clone(), vc_.clone()], [kc.clone(), vc_.clone()]
        add("paged_decode_append", tp, _per_rank_row(
            f"paged_decode_append tp={tp} B={b} H={h} KVH={kvh}",
            lambda: DA.paged_decode_append(q1, nk5, nv5, *a, 1, lens_t),
            lambda: DA.paged_decode_append_plain(q1, nk5, nv5, *c, 1,
                                                 lens_t),
            (kvh * live * d * 4 + b * kvh * d * 8 + 2 * b * h * d * 2,
             4.0 * d * h * (live + b)),
            caches=(a, c), graph=True))
        kl = torch.arange(m, device=dev)[None, :] <= lens_t.long()[:, None]
        qs, ks_, vs_ = q1.transpose(1, 2), kc[1], vc_[1]
        add("paged_decode_attention_stacked", tp, _per_rank_row(
            f"paged_decode_attention_stacked tp={tp} B={b} H={h} KVH={kvh}",
            lambda: DA.paged_decode_attention_stacked(q1, kc, vc_, 1,
                                                      lens_t),
            lambda: DA.paged_decode_attention_stacked_plain(q1, kc, vc_, 1,
                                                            lens_t),
            (kvh * (live + b) * d * 4 + 2 * b * h * d * 2,
             4.0 * d * h * (live + b)),
            lib=lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks_, vs_, attn_mask=kl[:, None, None, :],
                enable_gqa=True),
            graph=True))
        del kc, vc_, a, c
        # #6 and #7: the int4 cache
        m4 = 2048
        lens4 = [0, 700, 1390, m4 - tq - 1]
        l4 = torch.tensor(lens4, dtype=torch.int32, device=dev)
        live4 = sum(lens4)
        q6, new6, c6 = _q4_inputs(dev, gen, 2, b, kvh, m4, d, h, None,
                                  torch.bfloat16)
        a, c = [x.clone() for x in c6], [x.clone() for x in c6]
        add("paged_decode_append_q4", tp, _per_rank_row(
            f"paged_decode_append_q4 tp={tp} B={b} H={h} KVH={kvh}",
            lambda: DA.paged_decode_append_q4(q6, *new6, *a, 1, l4),
            lambda: DA.paged_decode_append_q4_plain(q6, *new6, *c, 1, l4),
            (_q4_bytes(lens4, kvh, d, h, b, 1), 4.0 * d * h * (live4 + b)),
            caches=(a, c), graph=True))
        q7, new7, c7 = _q4_inputs(dev, gen, 2, b, kvh, m4, d, h, tq,
                                  torch.bfloat16)
        a, c = [x.clone() for x in c7], [x.clone() for x in c7]
        add("paged_decode_append_multi_q4", tp, _per_rank_row(
            f"paged_decode_append_multi_q4 tp={tp} B={b} T={tq} H={h} "
            f"KVH={kvh}",
            lambda: DA.paged_decode_append_multi_q4(q7, *new7, *a, 1, l4),
            lambda: DA.paged_decode_append_multi_q4_plain(q7, *new7, *c, 1,
                                                          l4),
            (_q4_bytes(lens4, kvh, d, h, b, tq),
             4.0 * d * h * (live4 * tq + b * tq * (tq + 1) // 2)),
            caches=(a, c), graph=True))
        del c6, c7, a, c
        torch.cuda.empty_cache()
    return out


AB_BATCH, AB_ITERS = 80, 20
STREAM_NORM_TOL = 2e-2  # normwise relative error after 28 layers
STREAM_CALLS = 20  # chained calls per stream device time


def normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def check_streams(cfg, sp, x, cos, sin, caches, lens_t, attn,
                  label: str) -> tuple[float, float]:
    """#10 and #11 against their plain versions on the same inputs, full
    depth: #10's layer-0 qkv per element, its x_final and last-layer qkv
    normwise; #11's x_final normwise, the caches outside each slot's new row
    bit-equal to the input, layer-0 new int8 entries within one step, all
    layers' new rows dequantized normwise; two calls of each bit-equal.
    Then stream_layer_witness. Returns the two max abs errors."""
    from karanta_tpu_torch.ops import decode_stream as DS

    t = cfg.text
    b = x.shape[0]
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    got_x, got_q = DS.dense_stream(x, attn, sp)
    again = DS.dense_stream(x, attn, sp)
    torch.cuda.synchronize()
    want_x, want_q = DS.dense_stream_plain(x, attn, sp)
    check_bf16(f"dense_stream {label} layer-0 qkv bf16", got_q[0], want_q[0])
    for name, got, want in (("x_final", got_x, want_x),
                            ("last-layer qkv", got_q[-1], want_q[-1])):
        err = normwise(got, want)
        log(f"  dense_stream {label} {name}: normwise rel err {err:.3e} "
            f"(tol {STREAM_NORM_TOL})")
        if not err <= STREAM_NORM_TOL:
            raise AssertionError(f"dense_stream {label} {name}: normwise "
                                 f"error {err}")
    if not (torch.equal(got_x, again[0]) and torch.equal(got_q, again[1])):
        raise AssertionError(f"dense_stream {label}: two calls on the same "
                             f"inputs differ")
    log(f"  dense_stream {label}: two calls bit-equal")
    err10 = max(max_err(got_x, want_x), max_err(got_q, want_q))

    runs = [[c.clone() for c in caches] for _ in range(3)]
    mx = [DS.decode_megakernel(x, cos, sin, sp, *runs[i], lens_t, qd=qd,
                               kvd=kvd)[0] for i in range(2)]
    torch.cuda.synchronize()
    want = DS.decode_megakernel_plain(x, cos, sin, sp, *runs[2], lens_t, qd,
                                      kvd, t.head_dim ** -0.5)
    err = normwise(mx[0], want)
    per_slot = [normwise(mx[0][i], want[i]) for i in range(b)]
    slots = ([f"{e:.2e}" for e in per_slot] if b <= 8
             else f"worst {max(per_slot):.2e}")
    log(f"  decode_megakernel {label} x_final: normwise rel err {err:.3e} "
        f"(tol {STREAM_NORM_TOL}); per slot {slots}")
    if not err <= STREAM_NORM_TOL:
        raise AssertionError(f"decode_megakernel {label} x_final: normwise "
                             f"error {err}")
    if not (torch.equal(mx[0], mx[1])
            and all(torch.equal(p, q) for p, q in zip(runs[0], runs[1]))):
        raise AssertionError(f"decode_megakernel {label}: two calls on the "
                             f"same inputs differ")
    new = (torch.arange(AB_BUCKET, device=x.device)[None, :]
           == lens_t[:, None])[None, :, None, :]              # (1, B, 1, M)
    for part, got, plain, inp in zip(("k", "v", "ks", "vs"), runs[0],
                                     runs[2], caches):
        keep = ~new if got.dim() == 4 else ~new[..., None]
        if not torch.equal(torch.where(keep, got, 0),
                           torch.where(keep, inp, 0)):
            raise AssertionError(f"decode_megakernel {label}: cache {part} "
                                 f"changed outside the new rows")
        if got.dim() == 5:
            # (L, B, KVH, D): each layer's new row per slot
            sel = ~keep.expand_as(got)
            steps = (got[sel].int() - plain[sel].int()).abs().reshape(
                t.num_layers, -1)
            per_layer = (steps > 0).sum(dim=1).tolist()
            log(f"  decode_megakernel {label} new {part} rows: "
                f"{sum(per_layer)} of {steps.numel()} int8 entries differ "
                f"from the plain version's (max {int(steps.max())} step); "
                f"layer 0: {per_layer[0]} of {steps.shape[1]} (max "
                f"{int(steps[0].max())}); per layer {per_layer}")
            # layer 0 sees the same inputs in both up to float32 summation
            # order; deeper layers see hidden states that drifted apart
            # through earlier roundings (stream_layer_witness holds every
            # layer to one step from matched inputs)
            if int(steps[0].max()) > 1:
                raise AssertionError(f"decode_megakernel {label}: layer-0 "
                                     f"new {part} entries more than one "
                                     f"step from the plain version's")
            scale_k = runs[0][2 + (part == "v")]
            scale_p = runs[2][2 + (part == "v")]
            deq = (got[sel].float().reshape(-1, t.head_dim)
                   * scale_k[new.expand_as(scale_k)].float()[:, None])
            deq_p = (plain[sel].float().reshape(-1, t.head_dim)
                     * scale_p[new.expand_as(scale_p)].float()[:, None])
            row_err = normwise(deq, deq_p)
            log(f"  decode_megakernel {label} new {part} rows dequantized, "
                f"all layers: normwise rel err {row_err:.3e}")
            if not row_err <= STREAM_NORM_TOL:
                raise AssertionError(f"decode_megakernel {label}: new {part} "
                                     f"rows normwise error {row_err}")
    log(f"  decode_megakernel {label}: untouched cache entries bit-equal to "
        f"the input; two calls bit-equal")
    err11 = max_err(mx[0], want)
    x_full, caches_full = mx[0], runs[0]
    del runs, mx, want
    stream_layer_witness(cfg, sp, x, cos, sin, caches, lens_t, x_full,
                         caches_full, label)
    return err10, err11


def stream_layer_witness(cfg, sp, x, cos, sin, caches, lens_t, x_full,
                         caches_full, label: str) -> None:
    """Tells depth drift from a kernel fault: #11 and its plain version run
    one layer at a time, each layer from the same input (the kernel's own
    output of the layer before), and every layer's new int8 K/V entries are
    held to one step of the plain version's. The chained one-layer launches
    must give the full-depth launch's x_final and caches bit for bit, so
    each layer here is the arithmetic of the fused call, writes included."""
    from karanta_tpu_torch.ops import decode_stream as DS

    t = cfg.text
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    kern = [c.clone() for c in caches]
    plain = [c.clone() for c in caches]
    slots, rows = torch.arange(x.shape[0], device=x.device), lens_t.long()
    h, per_layer, worst = x, [], 0
    for l in range(t.num_layers):
        sp_l = {k: v[l:l + 1] for k, v in sp.items()}
        got = [c[l:l + 1] for c in kern]
        want = [c[l:l + 1] for c in plain]
        out = DS.decode_megakernel(h, cos, sin, sp_l, *got, lens_t, qd=qd,
                                   kvd=kvd)[0]
        DS.decode_megakernel_plain(h, cos, sin, sp_l, *want, lens_t, qd, kvd,
                                   t.head_dim ** -0.5)
        n = 0
        for g, w in zip(got[:2], want[:2]):
            steps = (g[0, slots, :, rows].int()
                     - w[0, slots, :, rows].int()).abs()
            n += int((steps > 0).sum())
            worst = max(worst, int(steps.max()))
        per_layer.append(n)
        h = out
    torch.cuda.synchronize()
    same = torch.equal(h, x_full) and all(
        torch.equal(p, q) for p, q in zip(kern, caches_full))
    log(f"  decode_megakernel {label} layer by layer from matched inputs: "
        f"new K/V entries that differ per layer {per_layer} of "
        f"{2 * x.shape[0] * kvd} (max {worst} step); chained one-layer "
        f"launches bit-equal to the full-depth launch, x and caches: {same}")
    if worst > 1:
        raise AssertionError(f"decode_megakernel {label}: from matched "
                             f"inputs a new K/V entry is {worst} steps from "
                             f"the plain version's")
    if not same:
        raise AssertionError(f"decode_megakernel {label}: chained one-layer "
                             f"launches differ from the full-depth launch")


def _renorm(x: torch.Tensor) -> torch.Tensor:
    """The A/B chain's next input (scratch/mega_meas.py _norm)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean() + 1e-6)).to(x.dtype)


def decode_stream_ab(cfg, dev, gen, params, sp, b: int) -> dict:
    """The decode-stream A/B at B slots, the bucket filled to AB_FILL rows:
    the megakernel step, the split decode_step and dense_stream, each
    chained AB_ITERS times at a fixed cache_len (the same row is rewritten),
    in the order mega, split, dense, split, mega. Returns ms/step (CUDA
    events around each chain), GB/s over the bytes bound, peak memory and
    the launches of each chain."""
    from karanta_tpu_torch.models.qwen25_vl import decoder as dec
    from karanta_tpu_torch.ops import decode_stream as DS

    t = cfg.text
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    lens = [AB_FILL] * b
    x0, cos, sin, caches, lens_t, attn = stream_inputs(cfg, dev, gen, b,
                                                       lens)
    cache = dec.QuantKVCache(*caches)
    positions = lens_t[None].expand(3, b)

    def mega(x):
        return _renorm(DS.decode_megakernel(x, cos, sin, sp, cache.k, cache.v,
                                            cache.ks, cache.vs, lens_t, qd=qd,
                                            kvd=kvd)[0])

    def split(x):
        return _renorm(dec.decode_step(params, t, x[:, None], positions, cache,
                                       lens_t)[0][:, 0])

    def dense(x):
        return _renorm(DS.dense_stream(x, attn, sp)[0])

    variants = {"megakernel": (mega, {"decode_megakernel": AB_ITERS,
                                      "paged_decode_append_quant": 0}),
                "split": (split, {"paged_decode_append_quant":
                                  t.num_layers * AB_ITERS,
                                  "decode_megakernel": 0}),
                "dense_stream": (dense, {"dense_stream": AB_ITERS})}
    out = {}
    for name in ("megakernel", "split", "dense_stream", "split", "megakernel"):
        fn, want = variants[name]
        x = fn(x0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(AB_ITERS):
            x = fn(x)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        ms = start.elapsed_time(end) / AB_ITERS
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"A/B {name} B={b}: non-finite output")
        for kname, n in want.items():
            if launches[kname] != n:
                raise AssertionError(f"A/B {name} B={b}: {kname} launched "
                                     f"{launches[kname]} times, expected {n}")
        n_bytes, _ = stream_work(cfg, b, lens, mega=name != "dense_stream")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[A/B B={b}] {name}: {ms:.3f} ms/step, "
            f"{n_bytes / ms / 1e6:.1f} GB/s of the bytes bound "
            f"({n_bytes / 1e9:.3f} GB, bound {n_bytes / PEAK_BYTES * 1e3:.3f} "
            f"ms), peak {peak:.2f} GiB; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        entry = out.setdefault(name, dict(ms=[], launches=launches,
                                          bytes=n_bytes, peak_gib=peak))
        entry["ms"].append(ms)
        entry["peak_gib"] = max(entry["peak_gib"], peak)
    del cache, caches, attn
    return out


def barrier_probe(cfg, dev, gen) -> dict:
    """The grid barriers' cost: both kernels at 28 layers but tiny widths
    (hidden 256, ffn 512, one kv head with the 7B's 7 query heads of 128,
    B = 4, a 128-row bucket), where each phase has almost no work; the time
    per barrier (8 a layer and one more for #11, 5 a layer and one more for
    #10) is an upper bound, since it includes each phase's own least
    time."""
    from karanta_tpu_torch.ops import decode_stream as DS
    from karanta_tpu_torch.ops.quantization import quantize_weight

    n, b, h, g, d, ff, m = cfg.text.num_layers, 4, 256, 7, 128, 512, 128
    qd, kvd = g * d, d

    def q(shape):
        return quantize_weight(torch.randn((n,) + shape, generator=gen,
                                           device=dev) * 0.05)

    def small(shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * 0.02).bfloat16()

    layers = {"ln1": small((n, h)) + 1, "ln2": small((n, h)) + 1,
              "attn": {"wq": q((h, qd)), "wk": q((h, kvd)), "wv": q((h, kvd)),
                       "wo": q((qd, h)), "bq": small((n, qd)),
                       "bk": small((n, kvd)), "bv": small((n, kvd))},
              "mlp": {"gate": q((h, ff)), "up": q((h, ff)),
                      "down": q((ff, h))}}
    sp = DS.pack_stream_params(layers)
    sp_dense = DS.pack_stream_params({**layers, "attn": {
        **layers["attn"], "wq": q((h, h)), "wo": q((h, h)),
        "bq": small((n, h))}})
    x = small((b, h))
    cos = torch.ones((b, d), device=dev)
    sin = torch.zeros((b, d), device=dev)
    caches = [torch.zeros((n, b, 1, m, d), dtype=torch.int8, device=dev)
              for _ in range(2)]
    caches += [torch.ones((n, b, 1, m), dtype=torch.bfloat16, device=dev)
               for _ in range(2)]
    lens = torch.full((b,), 64, dtype=torch.int32, device=dev)
    attn = small((n, b, h))
    t_mega = cuda_ms(lambda: DS.decode_megakernel(
        x, cos, sin, sp, *caches, lens, qd=qd, kvd=kvd), 20)
    t_dense = cuda_ms(lambda: DS.dense_stream(x, attn, sp_dense), 20)
    out = {"megakernel": t_mega * 1e3 / (8 * n + 1.0),
           "dense_stream": t_dense * 1e3 / (5 * n + 1.0),
           "megakernel_call_ms": t_mega, "dense_stream_call_ms": t_dense}
    log(f"[streams] barrier probe at 28 layers, tiny widths: megakernel "
        f"{t_mega:.3f} ms a call ({out['megakernel']:.2f} us per barrier, "
        f"upper bound), dense_stream {t_dense:.3f} ms "
        f"({out['dense_stream']:.2f} us)")
    return out


def phase_decode_streams(cfg, dev, gen) -> tuple[list, dict, dict]:
    """Kernels #10 and #11 at full 7B width and depth (random int8 weights
    from init_params_bench): checks at B = 4 with ragged lengths and at
    the A/B point (B = 80), each followed by both streams' device time (CUDA
    events over STREAM_CALLS chained calls of the port's kernel: a call runs
    for milliseconds, far longer than the host takes to issue the next) and
    a per-phase timer trace on an instrumented copy (bench/stream_trace.py:
    the phases' ms per step and the traced call's span), times at B = 80
    beside the plain versions and their yardsticks, then the A/B at B = 80
    and B = 4. Returns the two kernel rows and the A/B numbers."""
    from karanta_tpu_torch.bench import stream_trace as ST
    from karanta_tpu_torch.models.qwen25_vl import decoder as dec
    from karanta_tpu_torch.ops import decode_stream as DS

    t0 = time.perf_counter()
    params, _ = init_params_bench(cfg, torch.bfloat16, "int8", device=dev)
    text = {"layers": params["text"]["layers"],
            "final_norm": params["text"]["final_norm"]}
    del params
    sp = DS.pack_stream_params(text["layers"])
    torch.cuda.synchronize()
    log(f"[streams] 7B int8 decoder layers + packed copy in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    t = cfg.text
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    traced = ST.build_traced()
    phases = {}

    def trace(label, b, x, cos, sin, caches, lens_t, attn):
        """Both streams' device time on the port's kernel, then a per-phase
        timer trace on the instrumented copy."""
        calls = ST.stream_calls(sp, x, cos, sin, caches, lens_t, attn, qd, kvd)
        for name, call in calls.items():
            dev_ms = cuda_ms(lambda: call(None), STREAM_CALLS)
            res = ST.trace_call(traced, call, name, t.num_layers)
            res["device_ms"] = dev_ms
            phases.setdefault(name, {})[f"B={b}"] = res
            log(f"  {name} {label}: {dev_ms:.3f} ms device time by events")
            log(f"  {ST.line(f'{name} {label}', res)}")

    b, lens = len(STREAM_CHECK_LENS), STREAM_CHECK_LENS
    inputs4 = stream_inputs(cfg, dev, gen, b, lens)
    errs = [check_streams(cfg, sp, *inputs4, f"7B B={b} lens={lens}")]
    trace(f"7B B={b} lens={lens}", b, *inputs4)
    del inputs4
    b, lens = AB_BATCH, [AB_FILL] * AB_BATCH
    x, cos, sin, caches, lens_t, attn = stream_inputs(cfg, dev, gen, b, lens)
    errs.append(check_streams(cfg, sp, x, cos, sin, caches, lens_t, attn,
                              f"7B B={b} fill {AB_FILL}"))
    trace(f"7B B={b} fill {AB_FILL}", b, x, cos, sin, caches, lens_t, attn)
    err10, err11 = (max(e) for e in zip(*errs))
    positions = lens_t[None].expand(3, b)
    cache = dec.QuantKVCache(*caches)
    # the kernels' ms is their device time at B = 80, measured in trace()
    times = {
        "dense_stream": (
            phases["dense_stream"][f"B={b}"]["device_ms"],
            cuda_ms(lambda: DS.dense_stream_plain(x, attn, sp), 2, 1)),
        "decode_megakernel": (
            phases["decode_megakernel"][f"B={b}"]["device_ms"],
            cuda_ms(lambda: DS.decode_megakernel_plain(
                x, cos, sin, sp, *caches, lens_t, qd, kvd,
                t.head_dim ** -0.5), 1, 1)),
    }
    # yardsticks: #11 beside the port's split decode_step over the same
    # cache; #10 beside the same 28 layers' products as a loop of cuBLAS
    # calls over weights dequantized to bf16 beforehand (out-major, x @ W.T)
    t_split = cuda_ms(lambda: dec.decode_step(text, t, x[:, None], positions,
                                              cache, lens_t), 5)
    w16 = ST.dequantized_layers(text["layers"], t.num_layers)
    h_mid = (torch.randn((b, t.intermediate_size), generator=gen, device=dev)
             * 0.3).bfloat16()
    t_lib10 = cuda_ms(ST.cublas_products(w16, x, attn[0], h_mid), 5)
    del w16, cache, caches, attn
    torch.cuda.empty_cache()
    rows = []
    for name, line, err, (t_k, t_p), t_l in (
            ("dense_stream", 173, err10, times["dense_stream"], t_lib10),
            ("decode_megakernel", 589, err11, times["decode_megakernel"],
             t_split)):
        bd, by = bound_ms(*stream_work(cfg, b, lens,
                                       mega=name == "decode_megakernel"))
        bd4, _ = bound_ms(*stream_work(cfg, len(STREAM_CHECK_LENS),
                                       STREAM_CHECK_LENS,
                                       mega=name == "decode_megakernel"))
        per = phases[name]
        dev_ms = per[f"B={b}"]["device_ms"]
        dev4 = per[f"B={len(STREAM_CHECK_LENS)}"]["device_ms"]
        rows.append(dict(name=name, route="cuda",
                         source="karanta_tpu_torch/kernels/csrc/"
                                "decode_stream.cu",
                         replaces=f"karanta_tpu/ops/decode_stream.py:{line}",
                         max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bd,
                         bound_by=by, library_ms=t_l, device_ms=dev_ms,
                         bound_share=bd / dev_ms,
                         b4={"device_ms": dev4, "bound_ms": bd4,
                             "bound_share": bd4 / dev4},
                         phases={k: {"traced_ms": v["total_ms"],
                                     "phase_ms": v["phase_ms"],
                                     "barrier_release_ms":
                                         v["barrier_release_ms"]}
                                 for k, v in per.items()}))
        log(f"  {name} B={b}: kernel {t_k:.3f} ms device time "
            f"({100 * bd / dev_ms:.1f}% of the bound; the instrumented copy "
            f"{per[f'B={b}']['total_ms']:.3f} ms traced), plain {t_p:.3f} "
            f"ms, yardstick {t_l:.3f} ms, bound {bd:.3f} ms ({by}); "
            f"B={len(STREAM_CHECK_LENS)}: {dev4:.3f} ms device time, bound "
            f"{bd4:.3f} ms")
    ab = {f"B={bb}": decode_stream_ab(cfg, dev, gen, text, sp, bb)
          for bb in (AB_BATCH, 4)}
    barrier = barrier_probe(cfg, dev, gen)
    del text, sp
    gc.collect()
    torch.cuda.empty_cache()
    return rows, ab, barrier


# ---------------------------------------------------------------------------
# phase 4: the engine path
# ---------------------------------------------------------------------------

def instrument(engine) -> dict:
    """Count what an engine runs, through wrappers on its instance: decode
    steps and verify passes with their host-clock time (each chunk ends in
    a copy of its tokens to the host), prefix-continuation prefills and
    prefix builds."""
    c = dict(decode_steps=0, decode_s=0.0, verify_passes=0, verify_s=0.0,
             prefix_hits=0, prefix_builds=0)
    decode_async, chunk_spec = engine.decode_chunk_async, \
        engine.decode_chunk_spec
    prefill_insert, get_prefix = engine.prefill_insert, \
        engine._get_prefix_cache

    def counted_decode(steps=None, logits_out=None):
        c["decode_steps"] += steps or engine.ecfg.decode_chunk
        t0 = time.perf_counter()
        collect = decode_async(steps, logits_out)

        def timed_collect():
            toks = collect()
            # launch to tokens on the host; overlaps the next chunk's time
            # when the caller launched one ahead
            c["decode_s"] += time.perf_counter() - t0
            return toks

        return timed_collect

    def counted_spec(steps=None, logits_out=None):
        t0 = time.perf_counter()
        toks, n_new = chunk_spec(steps, logits_out)
        c["verify_s"] += time.perf_counter() - t0
        c["verify_passes"] += toks.shape[0]
        return toks, n_new

    def counted_prefill(slot, prepared):
        c["prefix_hits"] += bool(prepared.prefix_len)
        return prefill_insert(slot, prepared)

    def counted_prefix(ids):
        c["prefix_builds"] += ids.tobytes() not in engine._prefix_kv
        return get_prefix(ids)

    engine.decode_chunk_async = counted_decode
    engine.decode_chunk_spec = counted_spec
    engine.prefill_insert = counted_prefill
    engine._get_prefix_cache = counted_prefix
    return c


def phase_main_path(cfg, dev, profile: bool = False) -> dict:
    n_pages, batch, max_tokens, chunk = PAGES, BATCH, MAX_TOKENS, CHUNK
    t0 = time.perf_counter()
    params, engine_quantize = init_params_bench(cfg, torch.bfloat16, "int8",
                                                device=dev)
    tok = NoStopTokenizer()
    ecfg = EngineConfig(
        max_batch_size=batch, max_seq_len=1920, decode_chunk=chunk,
        prefill_buckets=(512, 1024, 1408), image_token_buckets=(2048,),
        dtype=torch.bfloat16, quantize=engine_quantize, kv_quantize="int8",
        act_quant="int8")
    engine = Engine(params, cfg, tok, ecfg, device=dev)
    del params
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.text.num_layers} decoder layers, "
        f"{cfg.vision.depth} vision blocks, weights + cache in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    pages = [make_page_png(seed=i) for i in range(n_pages + 1)]

    def requests(idx):
        return [GenRequest(messages=page_messages(pages[i]),
                           max_tokens=max_tokens, temperature=0.0,
                           request_id=f"page-{i}") for i in idx]

    # warm-up (cuBLAS handles, allocator): one short page, not counted
    engine.generate([GenRequest(messages=page_messages(pages[-1]),
                                max_tokens=2, request_id="warm")])
    torch.cuda.synchronize()

    counts = instrument(engine)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t_run = time.perf_counter()
    results = engine.generate(requests(range(n_pages)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = counts["decode_steps"]

    vocab = cfg.text.vocab_size
    for r in results:
        if len(r.token_ids) != max_tokens or not all(
                0 <= t < vocab for t in r.token_ids):
            raise AssertionError(f"{r.request_id}: bad tokens {r.token_ids}")
    n_vis_full = len(cfg.vision.fullatt_block_indexes)
    want = {"window_attention": (cfg.vision.depth - n_vis_full) * n_pages,
            "flash_attention": (n_vis_full + cfg.text.num_layers) * n_pages,
            "paged_decode_append_quant": cfg.text.num_layers * steps}
    log(f"[main] launches {launches}; expected {want} "
        f"({steps} decode steps)")
    for name, n in want.items():
        if launches[name] != n or n == 0:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"main path, expected {n}")
    total_tokens = sum(r.completion_tokens for r in results)
    log(f"[main] {n_pages} pages x {max_tokens} tokens in {wall:.3f}s: "
        f"{n_pages / wall:.4f} pages/s, {total_tokens / wall:.1f} tokens/s "
        f"end to end; prompt {results[0].prompt_tokens} tokens; peak "
        f"{peak / 2**30:.2f} GiB")

    # per-stage times (not counted): prepare, prefill+insert, decode
    prep_ms, prefill_ms = [], []
    for i in range(min(batch, 2)):
        t1 = time.perf_counter()
        prepared = engine.prepare(requests([i])[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.prefill_insert(i, prepared)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        prep_ms.append((t2 - t1) * 1e3)
        prefill_ms.append((t3 - t2) * 1e3)
    t4 = time.perf_counter()
    toks = engine.decode_chunk(chunk)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t4) * 1e3 / chunk
    if not np.isfinite(toks).all():
        raise AssertionError("decode produced non-finite tokens")
    if profile:
        profile_stages(engine, requests, chunk)
    for i in range(batch):
        engine.free_slot(i)
    log(f"[main] prepare (PNG decode + device resize) "
        f"{np.mean(prep_ms):.1f} ms/page, prefill+insert "
        f"{np.mean(prefill_ms):.1f} ms/page, decode {step_ms:.2f} ms/step "
        f"at B={batch} ({batch / step_ms * 1e3:.1f} tokens/s)")
    del engine
    torch.cuda.empty_cache()
    return dict(launches=launches, pages_per_s=n_pages / wall,
                tokens_per_s=total_tokens / wall,
                prefill_ms=float(np.mean(prefill_ms)),
                prepare_ms=float(np.mean(prep_ms)), decode_step_ms=step_ms,
                peak_gib=peak / 2**30)


def profile_run(stage: str, fn) -> None:
    """torch.profiler over fn(): device time by kernel and the device's busy
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] {stage}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):  # the top 14, and every kernel of the port
        if i < 14 or e.key.startswith("void karanta::"):
            log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                f"{e.count:6d}x  {e.key[:90]}")


def profile_stages(engine, requests, chunk: int) -> None:
    """One page's prefill+insert and one decode chunk of the engine path."""
    prepared = engine.prepare(requests([0])[0])
    profile_run("prefill", lambda: engine.prefill_insert(0, prepared))
    profile_run("decode", lambda: engine.decode_chunk(chunk))


def profile_verify(engine, stage: str) -> None:
    """Two verify passes of a served engine with four page prompts in its
    slots (after its server stopped)."""
    for i in range(4):
        png = make_page_png(seed=300 + i)
        engine.prefill_insert(i, engine.prepare(GenRequest(
            messages=page_messages(png, INSTRUCTION),
            max_tokens=SERVED_TOKENS)))
    engine.decode_chunk_spec(1)
    profile_run(stage, lambda: engine.decode_chunk_spec(2))
    for i in range(4):
        engine.free_slot(i)


# ---------------------------------------------------------------------------
# phases 5-7: the served paths
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def serving(engine):
    """The port's InferenceServer in this process on 127.0.0.1 at a free
    port, its event loop in a thread; stopped and joined on exit."""
    server = InferenceServer(engine, model_name="smoke")
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        holder["port"] = loop.run_until_complete(server.start("127.0.0.1", 0))
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    if not started.wait(120):
        raise AssertionError("server did not start")
    try:
        yield server, holder["port"]
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(120)
        loop.close()


def http_call(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def page_body(png_b64: str, stream: bool = False, **extra) -> dict:
    return {"model": "smoke", "max_tokens": SERVED_TOKENS,
            "temperature": 0.0, "stream": stream,
            "messages": page_messages(png_b64, INSTRUCTION), **extra}


def post_pages(port: int, bodies: list, tokens: int = SERVED_TOKENS) -> list:
    """POST the bodies concurrently. Checks each answer: status 200, and
    `tokens` tokens, from the usage count and from the text; a stream ends
    with a finish_reason chunk and [DONE], and its deltas put together spell
    `tokens` tokens. Returns the completion texts."""
    out = [None] * len(bodies)

    def post(i):
        status, raw = http_call(port, "POST", "/v1/chat/completions",
                                bodies[i])
        out[i] = (status, raw)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    texts = []
    for body, (status, raw) in zip(bodies, out):
        if status != 200:
            raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
        if body["stream"]:
            events = [ln[len("data: "):] for ln in raw.decode().split("\n")
                      if ln.startswith("data: ")]
            chunks = [json.loads(e) for e in events[:-1]]
            if events[-1] != "[DONE]" or \
                    chunks[-1]["choices"][0]["finish_reason"] != "length":
                raise AssertionError(f"SSE did not end with a finish_reason "
                                     f"chunk and [DONE]: {events[-2:]}")
            text = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
            n_usage = tokens
        else:
            data = json.loads(raw)
            text = data["choices"][0]["message"]["content"]
            n_usage = data["usage"]["completion_tokens"]
        if n_usage != tokens or n_tokens(text) != tokens:
            raise AssertionError(f"a response has {n_usage} / "
                                 f"{n_tokens(text)} tokens, expected "
                                 f"{tokens}")
        texts.append(text)
    return texts


def served_engine(argv: list):
    """The engine the server CLI builds from argv (random weights), with a
    tokenizer that counts tokens in the text (CountingTokenizer). A
    multi-rank server's engine is rank 0's leader: the tokenizer goes to
    the engine inside it, which decides where completions stop."""
    t0 = time.perf_counter()
    engine, _ = build_engine_from_args(make_arg_parser().parse_args(argv))
    getattr(engine, "engine", engine).tok = CountingTokenizer()
    torch.cuda.synchronize()
    log(f"[served] {' '.join(argv)}: engine in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return engine


def expected_prefill_launches(cfg, n_pages: int, n_builds: int) -> dict:
    """Per page: the vision encoder's window and full layers and the
    decoder prefill; per prefix build one more decoder prefill."""
    n_full = len(cfg.vision.fullatt_block_indexes)
    return {"window_attention": (cfg.vision.depth - n_full) * n_pages,
            "flash_attention": (n_full + cfg.text.num_layers) * n_pages
            + cfg.text.num_layers * n_builds}


def check_launches(path: str, launches: dict, want: dict) -> None:
    log(f"[{path}] launches {launches}; expected {want}")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"{path} path, expected {n}")


def phase_served_int8(cfg, profile: bool = False) -> dict:
    """The server at the int8 operating point; every verify pass runs the
    multi-token int8 kernel in each of the 28 layers."""
    engine = served_engine(
        ["--preset", "qwen2.5-vl-7b", "--quantize", "int8", "--kv-quantize",
         "int8", "--act-quant", "int8", "--max-batch-size", "4",
         "--decode-chunk", "8"])
    counts = instrument(engine)
    pages = [make_page_png(seed=100 + i) for i in range(SERVED_PAGES)]
    bodies = [page_body(png, stream=(i == 1)) for i, png in enumerate(pages)]
    with serving(engine) as (server, port):
        if http_call(port, "GET", "/health")[0] != 200:
            raise AssertionError("/health did not answer 200")
        status, raw = http_call(port, "GET", "/v1/models")
        if status != 200 or json.loads(raw)["data"][0]["id"] != "smoke":
            raise AssertionError(f"/v1/models: {status} {raw[:200]!r}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        post_pages(port, bodies)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    layers = cfg.text.num_layers
    want = expected_prefill_launches(cfg, SERVED_PAGES,
                                     counts["prefix_builds"])
    want.update({name: 0 for name in DECODE_KERNELS})
    want.update(paged_decode_append_multi_quant=layers
                * counts["verify_passes"],
                paged_decode_append_quant=layers * counts["decode_steps"])
    check_launches("served int8", launches, want)
    if not counts["verify_passes"] or not metrics.get("spec_passes"):
        raise AssertionError(f"no verify pass ran: {counts}, {metrics}")
    if counts["prefix_hits"] < 1 or counts["prefix_builds"] != 1:
        raise AssertionError(f"prefix cache: {counts}")
    verify_ms = counts["verify_s"] / counts["verify_passes"] * 1e3
    stats = dict(pages_per_s=SERVED_PAGES / wall,
                 tokens_per_pass=metrics["spec_tokens_per_pass"],
                 verify_ms=verify_ms, verify_passes=counts["verify_passes"],
                 decode_steps=counts["decode_steps"],
                 prefix_hits=counts["prefix_hits"], launches=launches)
    log(f"[served int8] {SERVED_PAGES} pages x {SERVED_TOKENS} tokens over "
        f"HTTP in {wall:.3f}s: {SERVED_PAGES / wall:.4f} pages/s; "
        f"{metrics['spec_tokens_per_pass']} tokens per verify pass, "
        f"{verify_ms:.2f} ms per verify pass (host clock, B=4, T=4); "
        f"{counts['prefix_hits']} prefix hits; /metrics {metrics}")
    if profile:
        profile_verify(engine, "verify pass, int8 KV, W8A8, B=4, T=4")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# the kernels a decode step or a verify pass may launch: in a wave, all but
# the wave's own must stay at 0
DECODE_KERNELS = ("paged_decode_append_quant",
                  "paged_decode_append_multi_quant", "paged_decode_append",
                  "paged_decode_append_q4", "paged_decode_append_multi_q4",
                  "paged_decode_attention", "paged_decode_attention_stacked")


@contextlib.contextmanager
def paged_decode_env(mode):
    """KARANTA_PAGED_DECODE set to mode (None: unset) inside the block, and
    restored after it."""
    before = os.environ.get("KARANTA_PAGED_DECODE")
    if mode is None:
        os.environ.pop("KARANTA_PAGED_DECODE", None)
    else:
        os.environ["KARANTA_PAGED_DECODE"] = mode
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("KARANTA_PAGED_DECODE", None)
        else:
            os.environ["KARANTA_PAGED_DECODE"] = before


def served_waves(cfg, label: str, argv: list, waves: list, seed: int,
                 profile_stage=None) -> dict:
    """The server built from argv answers one wave of DEFAULT_WAVE pages per
    entry of `waves`: (name, speculative vote, KARANTA_PAGED_DECODE, the
    per-step kernel, the verify kernel or None). In each wave the per-step
    kernel launches 28 x decode steps, the verify kernel 28 x verify passes,
    and no other decode kernel launches."""
    engine = served_engine(argv)
    counts = instrument(engine)
    layers = cfg.text.num_layers
    stats = {}
    with serving(engine) as (server, port):
        for w, (wave, vote, mode, step_kernel, verify_kernel) in \
                enumerate(waves):
            for key in counts:
                counts[key] = 0
            pages = [make_page_png(seed=seed + 10 * w + i)
                     for i in range(DEFAULT_WAVE)]
            extra = {} if vote is None else {"speculative": vote}
            bodies = [page_body(png, **extra) for png in pages]
            with paged_decode_env(mode):
                kernels.reset_launches()
                t0 = time.perf_counter()
                post_pages(port, bodies)
                wall = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
            want = expected_prefill_launches(cfg, DEFAULT_WAVE,
                                             counts["prefix_builds"])
            want.update({name: 0 for name in DECODE_KERNELS})
            want[step_kernel] = layers * counts["decode_steps"]
            if verify_kernel is not None:
                want[verify_kernel] = layers * counts["verify_passes"]
            check_launches(f"{label}, {wave} wave", launches, want)
            key = "decode_steps" if vote is False else "verify_passes"
            if not counts[key]:
                raise AssertionError(f"{wave} wave: no {key}: {counts}")
            per = (counts["verify_s"] / counts["verify_passes"] * 1e3
                   if counts["verify_passes"] else None)
            step = (counts["decode_s"] / counts["decode_steps"] * 1e3
                    if counts["decode_steps"] else None)
            stats[wave] = dict(pages_per_s=DEFAULT_WAVE / wall,
                               launches=launches, verify_ms=per,
                               decode_step_ms=step,
                               **{k: counts[k] for k in
                                  ("decode_steps", "verify_passes",
                                   "prefix_hits", "prefix_builds")})
            log(f"[{label}] {wave} wave: {DEFAULT_WAVE} pages x "
                f"{SERVED_TOKENS} tokens in {wall:.3f}s "
                f"({DEFAULT_WAVE / wall:.4f} pages/s); {counts}")
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    stats["tokens_per_pass"] = metrics.get("spec_tokens_per_pass")
    log(f"[{label}] /metrics {metrics}")
    if profile_stage:
        profile_verify(engine, profile_stage)
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def phase_served_int4(cfg, profile: bool = False) -> dict:
    """The server at the int4 capacity point: per-step decode through the
    int4 append kernel, verify passes through the multi-token int4 kernel,
    and the shared instruction served from the prefix cache."""
    stats = served_waves(
        cfg, "served int4",
        ["--preset", "qwen2.5-vl-7b", "--quantize", "int8", "--kv-quantize",
         "int4", "--act-quant", "int8", "--max-batch-size", "8",
         "--decode-chunk", "8"],
        [("per-step", False, None, "paged_decode_append_q4", None),
         ("speculative", None, None, "paged_decode_append_q4",
          "paged_decode_append_multi_q4")],
        seed=400, profile_stage="verify pass, int4 KV, W8A8, B=8, T=4"
        if profile else None)
    hits = sum(stats[w]["prefix_hits"] for w in ("per-step", "speculative"))
    if hits < 1:
        raise AssertionError(f"served int4: no prefix hit: {stats}")
    return stats


def phase_served_defaults(cfg, profile: bool = False) -> dict:
    """The server with the CLI's own defaults: a wave that opts out of
    speculation decodes per step through the bf16 append kernel, the same
    under KARANTA_PAGED_DECODE=stacked through the read-only stacked kernel,
    then a default wave runs the bf16 verify pass (no kernel: the JAX
    package's XLA path)."""
    return served_waves(
        cfg, "served defaults", ["--preset", "qwen2.5-vl-7b"],
        [("per-step", False, None, "paged_decode_append", None),
         ("stacked", False, "stacked", "paged_decode_attention_stacked",
          None),
         ("speculative", None, None, "paged_decode_append", None)],
        seed=200, profile_stage="verify pass, bf16 KV and weights, B=32, T=4"
        if profile else None)


# ---------------------------------------------------------------------------
# phase 8: tiny config, card vs CPU
# ---------------------------------------------------------------------------

def token_rows(cache, slot: int, n_rows: int) -> torch.Tensor:
    """K and V of one slot's first n_rows tokens, in token order (the int4
    cache unpacked), on the host."""
    k, v = cache.k[:, slot], cache.v[:, slot]
    if isinstance(cache, Q4KVCache):
        k, v = unpack_q4_rows(k), unpack_q4_rows(v)
    return torch.stack((k[:, :, :n_rows], v[:, :, :n_rows])).cpu()


def tiny_setup(dev):
    tok = NoStopTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params_cpu = init_params(cfg, 0, torch.float32, device="cpu")
    params_gpu = tree_map(lambda x, _: x.to(dev), params_cpu)
    return tok, cfg, params_cpu, params_gpu


def phase_tiny(dev, kv: str) -> float:
    """The engine (int8 weights, W8A8, the `kv` cache) on the card and on the
    CPU: the logits of the prefill and three decode steps, and the greedy
    tokens of a page request, agree; then the speculative engine."""
    tok, cfg, params_cpu, params_gpu = tiny_setup(dev)
    ecfg = EngineConfig(max_batch_size=2, max_seq_len=256, decode_chunk=4,
                        prefill_buckets=(128, 256), dtype=torch.float32,
                        quantize="int8", kv_quantize=kv, act_quant="int8")
    rng = np.random.default_rng(0)
    page = rng.integers(0, 255, size=(84, 112, 3), dtype=np.uint8)
    png = base64.b64encode(encode_png_rgb(page)).decode()
    req = GenRequest(messages=page_messages(png), max_tokens=8,
                     request_id="tiny")
    n_steps = 3
    logits, tokens, rows = {}, {}, {}
    for name, device, params in (("cpu", "cpu", params_cpu),
                                 ("cuda", dev, params_gpu)):
        eng = Engine(params, cfg, tok, ecfg, device=device)
        prepared = eng.prepare(req)
        steps = [eng.prefill(prepared)[0][None]]
        eng.prefill_insert(0, prepared)
        eng.decode_chunk(n_steps, logits_out=steps)  # the decode kernel
        rows[name] = token_rows(eng.cache, 0, int(eng.cache_len[0]))
        eng.free_slot(0)
        # (1 + n_steps, V): the prefill's logits, then slot 0's per step
        logits[name] = torch.stack([x[0] for x in steps]).float().cpu()
        tokens[name] = eng.generate([req])[0].token_ids
    log(f"[tiny {kv}] greedy tokens cpu {tokens['cpu']} cuda "
        f"{tokens['cuda']}")
    # float32 rounding differences can move a value across an int8 or int4
    # rounding boundary; each such flip shifts the later logits by a
    # quantization step
    n_prompt = len(prepared.ids)
    diff = (rows["cpu"].int() - rows["cuda"].int()).abs()
    for part, d in (("prompt", diff[..., :n_prompt, :]),
                    ("decode", diff[..., n_prompt:, :])):
        log(f"[tiny {kv}] K/V entries of the {part} rows that differ card vs "
            f"CPU: {int((d > 0).sum())} of {d.numel()} (max "
            f"{int(d.max()) if d.numel() else 0} steps)")
    if tokens["cpu"] != tokens["cuda"]:
        raise AssertionError(f"tiny config, {kv} KV: greedy tokens differ "
                             f"between the card and the CPU")
    worst = 0.0
    for i in range(1 + n_steps):
        want, got = logits["cpu"][i], logits["cuda"][i]
        scale = float(want.abs().max())
        err = float((want - got).abs().max())
        stage = "prefill" if i == 0 else f"decode step {i}"
        log(f"[tiny {kv}] {stage} logits card vs CPU: max abs err {err:.3e} "
            f"(max |logit| {scale:.3f})")
        check(f"tiny {kv} {stage} logits card vs CPU", err,
              TINY_LOGIT_TOL * max(scale, 1.0))
        worst = max(worst, err)
    return max(worst, phase_tiny_spec(dev, kv, tok, cfg, params_cpu,
                                      params_gpu))


def phase_tiny_spec(dev, kv, tok, cfg, params_cpu, params_gpu) -> float:
    """The speculative engine (gamma 3, int8 weights, the `kv` cache, no
    W8A8) on the card and on the CPU: the logits of three verify passes (the
    multi-token kernel on the card, its plain version on the CPU) and the
    greedy tokens of a whole request agree."""
    ecfg = EngineConfig(max_batch_size=2, max_seq_len=256, decode_chunk=8,
                        prefill_buckets=(128, 256), dtype=torch.float32,
                        quantize="int8", kv_quantize=kv,
                        speculative_ngram=3)
    req = GenRequest(messages=[{"role": "user",
                                "content": "abcabcabcabcabcabc"}],
                     max_tokens=24, request_id="tiny-spec")
    n_passes = 3
    logits, tokens, accepted = {}, {}, {}
    for name, device, params in (("cpu", "cpu", params_cpu),
                                 ("cuda", dev, params_gpu)):
        eng = Engine(params, cfg, tok, ecfg, device=device)
        eng.prefill_insert(0, eng.prepare(req))
        passes = []
        _, n_new = eng.decode_chunk_spec(n_passes, logits_out=passes)
        eng.free_slot(0)
        logits[name] = torch.stack([x[0] for x in passes]).float().cpu()
        accepted[name] = n_new[:, 0].tolist()
        tokens[name] = eng.generate([req])[0].token_ids
    log(f"[tiny {kv} spec] tokens per verify pass cpu {accepted['cpu']} cuda "
        f"{accepted['cuda']}; greedy tokens cpu {tokens['cpu']} cuda "
        f"{tokens['cuda']}")
    if tokens["cpu"] != tokens["cuda"] or accepted["cpu"] != accepted["cuda"]:
        raise AssertionError(f"tiny config, {kv} KV: speculative decoding "
                             f"differs between the card and the CPU")
    worst = 0.0
    for i in range(n_passes):
        want, got = logits["cpu"][i], logits["cuda"][i]
        scale = float(want.abs().max())
        err = float((want - got).abs().max())
        check(f"tiny {kv} verify pass {i + 1} logits (T=4) card vs CPU", err,
              TINY_LOGIT_TOL * max(scale, 1.0))
        worst = max(worst, err)
    return worst


def phase_tiny_stacked(dev) -> None:
    """Per-step decoding over the cache in the activations' dtype on the
    card: KARANTA_PAGED_DECODE=stacked (scatter + kernel #9) gives the
    tokens of the default mode (kernel #5), and launches only #9."""
    tok, cfg, _, params_gpu = tiny_setup(dev)
    ecfg = EngineConfig(max_batch_size=2, max_seq_len=256, decode_chunk=4,
                        prefill_buckets=(128, 256), dtype=torch.float32)
    req = GenRequest(messages=[{"role": "user",
                                "content": "The quick brown fox."}],
                     max_tokens=24, request_id="tiny-stacked")
    tokens = {}
    for mode in (None, "stacked"):
        eng = Engine(params_gpu, cfg, tok, ecfg, device=dev)
        with paged_decode_env(mode):
            kernels.reset_launches()
            tokens[mode] = eng.generate([req])[0].token_ids
            launches = dict(kernels.LAUNCHES)
        step_kernel = ("paged_decode_attention_stacked" if mode
                       else "paged_decode_append")
        others = {k: v for k, v in launches.items()
                  if k in DECODE_KERNELS and k != step_kernel and v}
        if not launches[step_kernel] or others:
            raise AssertionError(f"tiny, mode {mode}: launches {launches}")
    log(f"[tiny stacked] greedy tokens append {tokens[None]} stacked "
        f"{tokens['stacked']}")
    if tokens[None] != tokens["stacked"]:
        raise AssertionError("tiny config: the stacked mode's tokens differ "
                             "from the append kernel's")


# ---------------------------------------------------------------------------
# phase 9: the OCR pipeline
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
# the entry point's corpus: 6 PDFs of distinct 1288x994 pages, 7 pages, three
# PDFs under an invisible text layer of PIPE_LINES lines (anchors of >= 200
# characters, so those pages vote for speculation), one of two pages
PIPE_PDFS = 6
PIPE_PAGES = 7
PIPE_LINES = 6
PIPE_TOKENS = 32
PIPE_TIMEOUT = 600
# the in-process bench point: 7B, int8 weights, W8A8, int8 KV, 1920 rows,
# 8 slots, 8 pages under a text layer, 32 tokens a page. The olmOCR prompt
# with a page's anchor and 1,240 image tokens does not fit 1,920 rows, so
# the bench sends the short anchored prompt of closed_loop.yaml (1,642
# prompt tokens at 4 lines a page).
BENCH_PAGES = 8
BENCH_BATCH = 8
BENCH_LINES = 4
LOG_TIME = "%Y-%m-%d %H:%M:%S,%f"


def pipeline_corpus(root: str) -> list:
    """The entry point's corpus, written by the port's data/synthetic.py
    (Flate RGB pages, no PIL)."""
    from karanta_tpu_torch.bench.pipeline_bench import (make_page_array,
                                                        page_text)
    from karanta_tpu_torch.data.synthetic import (page_to_pdf_bytes,
                                                  pages_to_pdf_bytes)
    from karanta_tpu_torch.pdf.anchor import get_anchor_text

    os.makedirs(root)
    paths = []
    for i in range(PIPE_PDFS):
        if i == PIPE_PDFS - 1:
            data = pages_to_pdf_bytes([make_page_array(500 + i),
                                       make_page_array(600 + i)])
        else:
            layer = page_text(500 + i, n_lines=PIPE_LINES) if i < 3 else None
            data = page_to_pdf_bytes(make_page_array(500 + i),
                                     text_layer=layer)
        path = os.path.join(root, f"doc{i}.pdf")
        with open(path, "wb") as f:
            f.write(data)
        paths.append(path)
        if i < 3 and len(get_anchor_text(path, 1, "pdfreport").strip()) < 200:
            raise AssertionError(f"{path}: text layer under 200 characters")
    return paths


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _log_time(line: str) -> float:
    import datetime

    return datetime.datetime.strptime(line[:23], LOG_TIME).timestamp()


def _expected_span(text, index: int, n_pages: int) -> str:
    """A page's share of its Dolma text (pipeline/dolma.py's rule)."""
    if text is None:
        return ""
    return text + ("\n" if index < n_pages - 1 else "")


def phase_pipeline_entry(root: str) -> dict:
    """`python -m karanta_tpu_torch.pipeline ... --serve-inproc` as a user
    runs it: the pipeline spawns the port's server at its CLI defaults
    (bf16, 32 slots, speculation and prefix cache on) on the 7B preset.

    Random weights never emit the end token, so each completion runs to the
    32-token budget and the runner's validation counts the page as failed
    after its one attempt (finish_reason "length"), then falls back to the
    page's text layer. So the checks are: every page's one attempt was
    answered by the server and failed only for that reason (or for text
    that does not parse, when a completion is empty); finished plus failed
    pages are 7; every work group is done; and each PDF's Dolma document is
    there exactly when the runner's rules give it text, with the fallback
    pages' text equal to their anchor fallback (--max_page_error_rate 1.01
    keeps documents with fallback pages, as the bench does)."""
    from karanta_tpu_torch.pdf.anchor import get_anchor_text
    from karanta_tpu_torch.pdf.minipdf import PdfDocument
    from karanta_tpu_torch.pipeline.work_queue import LocalBackend, _group_hash

    pdfs = pipeline_corpus(os.path.join(root, "corpus"))
    ws = os.path.join(root, "ws")
    port = _free_port()
    cmd = [sys.executable, "-m", "karanta_tpu_torch.pipeline", ws,
           "--pdfs", *pdfs, "--serve-inproc",
           "--server", f"http://127.0.0.1:{port}/v1",
           "--preset", "qwen2.5-vl-7b",
           "--max_output_tokens", str(PIPE_TOKENS), "--accept_raw_text",
           "--max_page_retries", "1", "--admission_release_interval", "1",
           "--max_page_error_rate", "1.01"]
    log(f"[pipeline] {' '.join(cmd[2:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=PIPE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise AssertionError(f"the pipeline ran past {PIPE_TIMEOUT} s: "
                             f"{err[-3000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    wall = time.perf_counter() - t0
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "pipeline_entry.log"),
              "w") as f:
        f.write(out + "\n---- stderr ----\n" + err)
    if proc.returncode != 0:
        raise AssertionError(f"the pipeline exited {proc.returncode}: "
                             f"{err[-3000:]}")
    summary, _ = json.JSONDecoder().raw_decode(out[out.rindex("\n{\n") + 1:]
                                               if "\n{\n" in out else out)
    totals = summary["total_metrics"]
    finished = int(totals.get("finished_on_attempt_0", 0))
    failed = int(totals.get("failed_pages", 0))
    lines = err.splitlines()
    bad = [ln for ln in lines if re.search(
        r"server returned|transport error|unexpected error|Traceback|"
        r"failed on group|could not", ln)]
    if bad:
        raise AssertionError(f"the pipeline met errors: {bad[:5]}")
    fail_re = re.compile(r"(?:attempt 0 failed for|json decode error "
                         r"attempt 0 for) (\S+)-(\d+): (.*)$")
    failures = {}
    for ln in lines:
        m = fail_re.search(ln)
        if m:
            reason = m.group(3)
            if "json decode error" not in ln and \
                    reason != "finish_reason was not 'stop'":
                raise AssertionError(f"a page failed for another reason: "
                                     f"{ln}")
            failures[(m.group(1), int(m.group(2)))] = reason
    if finished + failed != PIPE_PAGES or len(failures) != failed:
        raise AssertionError(f"pages: {finished} finished on attempt 0, "
                             f"{failed} failed, {len(failures)} failures "
                             f"logged; expected {PIPE_PAGES} in all")
    backend = LocalBackend(ws)
    groups = backend.read_index()
    if not groups or not all(backend.is_done(_group_hash(g))
                             for g in groups):
        raise AssertionError(f"not every work group is done: {groups}")
    docs = {}
    for path in glob.glob(os.path.join(ws, "results", "output_*.jsonl")):
        with open(path) as f:
            for line in f:
                doc = json.loads(line)
                docs[doc["metadata"]["Source-File"]] = doc
    want_docs = 0
    for pdf in pdfs:
        n = PdfDocument.open(pdf).num_pages()
        doc = docs.get(pdf)
        page_failed = [(pdf, p) in failures for p in range(1, n + 1)]
        fallback = [get_anchor_text(pdf, p, "pdftotext") or None
                    if page_failed[p - 1] else None for p in range(1, n + 1)]
        spans = [_expected_span(t, i, n) for i, t in enumerate(fallback)]
        has_text = not all(page_failed) or any(spans)
        want_docs += has_text
        if has_text != (doc is not None):
            raise AssertionError(f"{pdf}: Dolma document "
                                 f"{'missing' if has_text else 'unexpected'}")
        if doc is None:
            continue
        if doc["metadata"]["total-fallback-pages"] != sum(page_failed):
            raise AssertionError(f"{pdf}: fallback pages {doc['metadata']}")
        for (start, end, page), was_failed, span in zip(
                doc["attributes"]["pdf_page_numbers"], page_failed, spans):
            if was_failed and doc["text"][start:end] != span:
                raise AssertionError(f"{pdf} page {page}: fallback text "
                                     f"differs from its anchor fallback")
            if not was_failed and end == start:
                raise AssertionError(f"{pdf} page {page}: finished page "
                                     f"without text")
    starts = [_log_time(ln) for ln in lines if "inference server on :" in ln]
    ends = [_log_time(ln) for ln in lines if "final metrics:" in ln]
    served_s = ends[-1] - starts[0]
    log(f"[pipeline] entry point: {PIPE_PAGES} pages of {PIPE_PDFS} PDFs in "
        f"{wall:.3f}s of command time (server spawn and 7B init included), "
        f"{served_s:.3f}s from the server's start to the pipeline's end: "
        f"{PIPE_PAGES / served_s:.4f} pages/s; {finished} finished on "
        f"attempt 0, {failed} failed ({sorted(set(failures.values()))}); "
        f"{len(groups)} work groups done; {len(docs)} Dolma documents "
        f"(expected {want_docs})")
    return dict(pages_per_s=PIPE_PAGES / served_s, command_s=wall,
                served_s=served_s, finished_on_attempt_0=finished,
                failed_pages=failed, documents=len(docs),
                server_output_tokens=totals.get("server_output_tokens", 0))


def phase_pipeline_bench(cfg, root: str) -> dict:
    """The port's pipeline bench in this process at its bench point: the
    pipeline, the port's server and the engine in one event loop, launches
    counted from the engine's build through the warm-up page and the 8
    timed pages."""
    import argparse

    from karanta_tpu_torch.bench import pipeline_bench
    from karanta_tpu_torch.pipeline import render_pool

    parser = argparse.ArgumentParser()
    pipeline_bench.add_args(parser)
    args = parser.parse_args([
        "--preset", "qwen2.5-vl-7b", "--pages", str(BENCH_PAGES),
        "--batch", str(BENCH_BATCH), "--max-seq-len", "1920",
        "--decode-tokens", str(PIPE_TOKENS), "--text-layer",
        "--page-lines", str(BENCH_LINES), "--quantize", "int8",
        "--kv-quantize", "int8", "--act-quant", "int8",
        "--prompt-key", "olmo_ocr_system_prompt",
        "--prompt-path", os.path.join(REPO, "configs", "prompts",
                                      "closed_loop.yaml"),
        "--admission-release-interval", "1",
        "--workspace", os.path.join(root, "bench")])
    build = pipeline_bench.build_engine
    held = {}

    def counted_build(args_, cfg_, dtype, device):
        engine = build(args_, cfg_, dtype, device)
        held["counts"] = instrument(engine)
        kernels.reset_launches()
        return engine

    pipeline_bench.build_engine = counted_build
    t0 = time.perf_counter()
    try:
        result = pipeline_bench.run(args)  # prints the bench's JSON line
    finally:
        pipeline_bench.build_engine = build
        render_pool.shutdown_pool()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    seconds = time.perf_counter() - t0
    counts, detail = held["counts"], result["detail"]
    if detail["requests_served"] != BENCH_PAGES + 1 or \
            detail["finished_on_attempt_0"] + detail["fallback_pages"] \
            != BENCH_PAGES:
        raise AssertionError(f"pipeline bench: {detail}")
    layers = cfg.text.num_layers
    want = expected_prefill_launches(cfg, BENCH_PAGES + 1,
                                     counts["prefix_builds"])
    want.update({name: 0 for name in DECODE_KERNELS})
    want.update(paged_decode_append_quant=layers * counts["decode_steps"],
                paged_decode_append_multi_quant=layers
                * counts["verify_passes"])
    check_launches("pipeline bench", launches, want)
    if not (launches["window_attention"] and launches["flash_attention"]
            and (launches["paged_decode_append_quant"]
                 or launches["paged_decode_append_multi_quant"])):
        raise AssertionError(f"pipeline bench: a kernel of the path did not "
                             f"launch: {launches}")
    log(f"[pipeline] bench: {BENCH_PAGES} pages x {PIPE_TOKENS} tokens, "
        f"B={BENCH_BATCH}: {result['value']:.4f} pages/s/card "
        f"({detail['elapsed_s']} s timed); {detail['finished_on_attempt_0']} "
        f"finished on attempt 0, {detail['fallback_pages']} fell back; "
        f"{counts['decode_steps']} decode steps, {counts['verify_passes']} "
        f"verify passes, {counts['prefix_hits']} prefix hits; phase "
        f"{seconds:.1f}s")
    return dict(pages_per_s=result["value"], launches=launches,
                detail=detail, seconds=seconds,
                **{k: counts[k] for k in ("decode_steps", "verify_passes",
                                          "prefix_hits", "prefix_builds")})


def phase_pipeline(cfg, kind: str) -> dict:
    """Phase 9: the entry point as a subprocess, then the bench in process,
    both in a temporary directory that is removed after."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="pipeline_")
    try:
        entry = phase_pipeline_entry(root)
        bench = phase_pipeline_bench(cfg, root)
        forced = phase_pipeline_forced(cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"[pipeline] entry point {entry['pages_per_s']:.4f} pages/s, bench "
        f"{bench['pages_per_s']:.4f} pages/s/card, teacher-forced bench "
        f"{forced['pages_per_s']:.4f} pages/s/card at "
        f"{forced['tokens_per_pass']} tokens a pass; phase {seconds:.1f}s; "
        f"{kind}; {smi}; random weights")
    return dict(entry=entry, bench=bench, forced=forced, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 10: the pipeline's success path under teacher forcing
# ---------------------------------------------------------------------------

# the teacher-forced bench point: the bench point above (7B, int8 weights,
# W8A8, int8 KV, 8 slots, 8 text-layer pages, closed_loop.yaml's prompt)
# with each page's completion forced to its own text layer at 5% word
# errors, 512 tokens a page. At 14 lines a page the transcripts run 565-596 bytes, past the
# budget, so every completion is 511 forced tokens and EOS; the prompts
# (about 2,140 tokens) + 512 + gamma + 2 fit 2,816 rows.
FORCED_LINES = 14
FORCED_TOKENS = 512
FORCED_SEQ = 2816
FORCE_ERROR_RATE = 0.05


def phase_pipeline_forced(cfg, root: str) -> dict:
    """The port's pipeline bench with --teacher-force: every page finishes
    on its first attempt with its forced transcript, cut to the budget, as
    its Dolma text; the kernels' launches match the passes counted."""
    import argparse

    from karanta_tpu_torch.bench import pipeline_bench
    from karanta_tpu_torch.pipeline import render_pool

    parser = argparse.ArgumentParser()
    pipeline_bench.add_args(parser)
    workspace = os.path.join(root, "forced")
    args = parser.parse_args([
        "--preset", "qwen2.5-vl-7b", "--pages", str(BENCH_PAGES),
        "--batch", str(BENCH_BATCH), "--max-seq-len", str(FORCED_SEQ),
        "--decode-tokens", str(FORCED_TOKENS), "--text-layer",
        "--page-lines", str(FORCED_LINES), "--quantize", "int8",
        "--kv-quantize", "int8", "--act-quant", "int8",
        "--prompt-key", "olmo_ocr_system_prompt",
        "--prompt-path", os.path.join(REPO, "configs", "prompts",
                                      "closed_loop.yaml"),
        "--admission-release-interval", "1", "--teacher-force",
        "--force-error-rate", str(FORCE_ERROR_RATE),
        "--workspace", workspace])
    build = pipeline_bench.build_engine
    held = {}

    def counted_build(args_, cfg_, dtype, device):
        engine = build(args_, cfg_, dtype, device)
        held["engine"] = engine
        held["counts"] = instrument(engine)
        kernels.reset_launches()
        return engine

    pipeline_bench.build_engine = counted_build
    t0 = time.perf_counter()
    try:
        result = pipeline_bench.run(args)  # prints the bench's JSON line
    finally:
        pipeline_bench.build_engine = build
        render_pool.shutdown_pool()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    seconds = time.perf_counter() - t0
    counts, detail = held["counts"], result["detail"]
    engine = held.pop("engine")
    if (detail["requests_served"] != BENCH_PAGES + 1
            or detail["finished_on_attempt_0"] != BENCH_PAGES
            or detail["fallback_pages"] != 0 or not detail["teacher_force"]):
        raise AssertionError(f"forced pipeline bench: not every page "
                             f"finished on attempt 0: {detail}")
    docs = {}
    for path in glob.glob(os.path.join(workspace, "results",
                                       "output_*.jsonl")):
        with open(path) as f:
            for line in f:
                doc = json.loads(line)
                docs[os.path.basename(doc["metadata"]["Source-File"])] = doc
    if len(docs) != BENCH_PAGES:
        raise AssertionError(f"forced pipeline bench: {len(docs)} Dolma "
                             f"documents, expected {BENCH_PAGES}")
    for name, doc in sorted(docs.items()):
        seed = int(re.search(r"page_(\d+)", name).group(1))
        forced = pipeline_bench.forced_page_text(seed, FORCE_ERROR_RATE,
                                                 n_lines=FORCED_LINES)
        # the byte tokenizer: a token a byte; the budget's last is EOS
        want = forced.encode()[:FORCED_TOKENS - 1].decode().strip()
        if doc["text"] != want or doc["metadata"]["total-fallback-pages"]:
            raise AssertionError(f"{name}: Dolma text is not its forced "
                                 f"transcript cut to the budget: "
                                 f"{doc['text'][:80]!r} vs {want[:80]!r}")
    layers = cfg.text.num_layers
    want = expected_prefill_launches(cfg, BENCH_PAGES + 1,
                                     counts["prefix_builds"])
    want.update({name: 0 for name in DECODE_KERNELS})
    want.update(paged_decode_append_quant=layers * counts["decode_steps"],
                paged_decode_append_multi_quant=layers
                * counts["verify_passes"])
    check_launches("forced pipeline bench", launches, want)
    if not launches["paged_decode_append_multi_quant"]:
        raise AssertionError(f"forced pipeline bench: no verify pass ran: "
                             f"{launches}")
    tokens_a_page = detail["server_output_tokens"] / BENCH_PAGES
    tokens_per_pass = detail.get("spec_tokens_per_pass")
    log(f"[forced] bench, teacher-forced at {FORCE_ERROR_RATE} word errors: "
        f"{BENCH_PAGES} pages x {FORCED_TOKENS}-token budget, B="
        f"{BENCH_BATCH}: {result['value']:.4f} pages/s/card "
        f"({detail['elapsed_s']} s timed); {detail['finished_on_attempt_0']}"
        f" finished on attempt 0, {detail['fallback_pages']} fell back; "
        f"{tokens_a_page:.1f} tokens a page; {counts['verify_passes']} "
        f"verify passes, {tokens_per_pass} tokens a pass (engine: "
        f"{engine.spec_tokens} tokens in {engine.spec_passes} passes); "
        f"{counts['decode_steps']} decode steps, {counts['prefix_hits']} "
        f"prefix hits; phase {seconds:.1f}s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(pages_per_s=result["value"], launches=launches,
                detail=detail, seconds=seconds, tokens_a_page=tokens_a_page,
                tokens_per_pass=tokens_per_pass,
                **{k: counts[k] for k in ("decode_steps", "verify_passes",
                                          "prefix_hits", "prefix_builds")})


# ---------------------------------------------------------------------------
# phase 11: HF weight loading
# ---------------------------------------------------------------------------

LOAD_SEED = 11
LOAD_TOKENS = 32


def bpe_tokenizer_dir(out: str) -> str:
    """A byte-level BPE tokenizer trained here on a few lines and written
    as an HF tokenizer dir (tokenizer.json + tokenizer_config.json), with
    the chat template's special tokens."""
    from tokenizers import (Tokenizer, decoders, models, pre_tokenizers,
                            trainers)

    specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>",
                "<|vision_start|>", "<|vision_end|>", "<|image_pad|>"]
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        [INSTRUCTION * 20, "the quick brown fox jumps over the lazy dog " * 50],
        trainers.BpeTrainer(vocab_size=800, special_tokens=specials,
                            initial_alphabet=pre_tokenizers.ByteLevel
                            .alphabet(), show_progress=False))
    tok.save(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>",
                   "additional_special_tokens": specials[3:],
                   "model_max_length": 32768}, f)
    return out


def greedy_page_tokens(params, cfg, engine_quantize, png: str) -> list:
    """One page x LOAD_TOKENS greedy tokens of a one-slot int8 engine."""
    engine = Engine(params, cfg, NoStopTokenizer(), EngineConfig(
        max_batch_size=1, max_seq_len=2048, decode_chunk=CHUNK,
        prefill_buckets=(512, 1024, 1408), image_token_buckets=(2048,),
        dtype=torch.bfloat16, quantize=engine_quantize, kv_quantize="int8",
        act_quant="int8"), device="cuda")
    [res] = engine.generate([GenRequest(messages=page_messages(png),
                                        max_tokens=LOAD_TOKENS)])
    del engine
    return res.token_ids


def phase_loading(cfg) -> dict:
    """A random 7B checkpoint written by the port's exporter and read back
    by its loader, int8 on transfer: every loaded tensor bit-equal to
    quantize_decoder_params of the weights in memory, the greedy tokens of
    an engine on each equal; then the server CLI's --model-path beside a
    locally trained BPE tokenizer answers a page."""
    import shutil
    import tempfile

    from karanta_tpu_torch.models.qwen25_vl.exporting import \
        save_hf_checkpoint
    from karanta_tpu_torch.models.qwen25_vl.loading import load_hf_checkpoint
    from karanta_tpu_torch.ops.quantization import quantize_decoder_params

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="checkpoint_")
    try:
        params = init_params(cfg, LOAD_SEED, torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_hf_checkpoint(params, cfg, root)
        write_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(p) for p in
                      glob.glob(os.path.join(root, "*.safetensors")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_hf_checkpoint(root, cfg, torch.bfloat16,
                                    quantize="int8", device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = {**params, "text": quantize_decoder_params(params["text"])}
        got_leaves = dict(tree_leaves(loaded))
        want_leaves = dict(tree_leaves(want))
        if got_leaves.keys() != want_leaves.keys():
            raise AssertionError(f"loaded tree differs: "
                                 f"{sorted(got_leaves.keys() ^ want_leaves.keys())[:5]}")
        for path, w in want_leaves.items():
            g = got_leaves[path]
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not torch.equal(g, w):
                raise AssertionError(f"loaded {'/'.join(path)} is not "
                                     f"bit-equal to the weights in memory")
        del want, got_leaves, want_leaves
        png = make_page_png(seed=LOAD_SEED)
        tokens_loaded = greedy_page_tokens(loaded, cfg, None, png)
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        tokens_memory = greedy_page_tokens(params, cfg, "int8", png)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if tokens_loaded != tokens_memory or \
                len(tokens_loaded) != LOAD_TOKENS:
            raise AssertionError(f"greedy tokens differ: loaded "
                                 f"{tokens_loaded} vs in memory "
                                 f"{tokens_memory}")
        log(f"[loading] {cfg.name} ({cfg.text.num_layers} decoder layers, "
            f"{cfg.vision.depth} vision blocks), bf16: written in "
            f"{write_s:.1f}s ({n_bytes / 1e9:.2f} GB, "
            f"{n_bytes / 1e9 / write_s:.2f} GB/s), loaded with int8 on "
            f"transfer in {load_s:.2f}s ({n_bytes / 1e9 / load_s:.2f} GB/s);"
            f" every tensor bit-equal to the weights in memory; greedy "
            f"tokens equal over 1 page x {LOAD_TOKENS}")
        stats = dict(write_s=write_s, load_s=load_s, gbytes=n_bytes / 1e9,
                     load_gb_per_s=n_bytes / 1e9 / load_s, served=None)
        stats["served"] = serve_model_path(root)
        return stats
    finally:
        shutil.rmtree(root, ignore_errors=True)


def serve_model_path(root: str):
    """The server CLI with --model-path over the checkpoint, beside a BPE
    tokenizer trained here, answers one page over HTTP. Needs `tokenizers`
    and `transformers` (HFTokenizer); without them the step is reported as
    not run."""
    import importlib.util

    missing = [m for m in ("tokenizers", "transformers")
               if importlib.util.find_spec(m) is None]
    if missing:
        log(f"[loading] --model-path serving not run: no {missing} here")
        return None
    bpe_tokenizer_dir(root)
    argv = ["--model-path", root, "--preset", "qwen2.5-vl-7b", "--quantize",
            "int8", "--kv-quantize", "int8", "--act-quant", "int8",
            "--max-batch-size", "4", "--decode-chunk", "8"]
    t0 = time.perf_counter()
    engine, name = build_engine_from_args(make_arg_parser().parse_args(argv))
    build_s = time.perf_counter() - t0
    png = make_page_png(seed=LOAD_SEED + 1)
    with serving(engine) as (server, port):
        status, raw = http_call(port, "POST", "/v1/chat/completions",
                                page_body(png))
    if status != 200:
        raise AssertionError(f"--model-path server: HTTP {status}: "
                             f"{raw[:300]!r}")
    data = json.loads(raw)
    n = data["usage"]["completion_tokens"]
    reason = data["choices"][0]["finish_reason"]
    if not 1 <= n <= SERVED_TOKENS or reason not in ("stop", "length"):
        raise AssertionError(f"--model-path server: {data}")
    log(f"[loading] --model-path server ({name}, HFTokenizer vocab "
        f"{engine.tok.vocab_size}): built in {build_s:.1f}s, one page "
        f"answered, {n} tokens ({reason})")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(build_s=build_s, completion_tokens=n, finish_reason=reason)


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# phase 12: guided decoding and logprobs, served
# ---------------------------------------------------------------------------

GUIDED_TOKENS = 160   # past the regex's ~110-byte front matter
LOGPROB_TOL = 1e-3


def phase_guided_logprobs(cfg) -> dict:
    """The int8 server (as phase 5) answers one wave of three pages: one
    under the pipeline's guided regex, one with logprobs (top 5, greedy),
    one plain. The guided completion matches its regex; each chosen
    logprob is its top-1 and within 1e-3 of a float32 log_softmax of the
    logits captured at that step; guided and unguided slots decode side by
    side; the launches match the steps and passes counted."""
    from karanta_tpu_torch.inference.guided import compile_regex, match_full
    from karanta_tpu_torch.pipeline.runner import GUIDED_REGEX

    engine = served_engine(
        ["--preset", "qwen2.5-vl-7b", "--quantize", "int8", "--kv-quantize",
         "int8", "--act-quant", "int8", "--max-batch-size", "4",
         "--decode-chunk", "8"])
    # the byte tokenizer with its end token: the regex reads the text's
    # bytes, and the end token is allowed in accepting states only (with
    # no end token in the vocabulary, a state that still needs a byte
    # would count as free and could speculate byte-less tokens only)
    engine.tok = ByteTokenizer()
    counts = instrument(engine)
    watch = {"lp_slot": None, "first": None, "steps": [], "mixed": 0}
    prefill_insert, decode_async, sample_first = engine.prefill_insert, \
        engine.decode_chunk_async, engine._sample_first

    def watched_prefill(slot, prepared):
        if prepared.logprobs:
            watch["lp_slot"] = slot
        return prefill_insert(slot, prepared)

    def watched_first(prepared, logits):
        if prepared.logprobs:
            watch["first"] = logits.float()
        return sample_first(prepared, logits)

    def watched_decode(steps=None, logits_out=None):
        active = [i for i, f in enumerate(engine.slot_free) if not f]
        guided = [i for i in active if engine._slot_guided[i]]
        watch["mixed"] += bool(guided) and len(guided) < len(active)
        captured = []
        collect = decode_async(steps, captured)
        slot = watch["lp_slot"]
        if slot is not None and slot in active:
            watch["steps"] += [x[slot].float() for x in captured]
        return collect

    engine.prefill_insert = watched_prefill
    engine._sample_first = watched_first
    engine.decode_chunk_async = watched_decode
    pngs = [make_page_png(seed=700 + i) for i in range(3)]
    bodies = [page_body(pngs[0], guided_regex=GUIDED_REGEX,
                        max_tokens=GUIDED_TOKENS),
              page_body(pngs[1], logprobs=True, top_logprobs=5),
              page_body(pngs[2], max_tokens=GUIDED_TOKENS)]
    out = [None] * 3
    with serving(engine) as (server, port):
        kernels.reset_launches()
        t0 = time.perf_counter()

        def post(i):
            out[i] = http_call(port, "POST", "/v1/chat/completions",
                               bodies[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    data = []
    for status, raw in out:
        if status != 200:
            raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
        data.append(json.loads(raw))
    guided_text = data[0]["choices"][0]["message"]["content"]
    if not match_full(compile_regex(GUIDED_REGEX), guided_text.encode()):
        raise AssertionError(f"guided completion does not match the "
                             f"pipeline's regex: {guided_text[:200]!r}")
    lp = data[1]["choices"][0]["logprobs"]["content"]
    logits = [watch["first"]] + watch["steps"]
    n_lp = data[1]["usage"]["completion_tokens"] - (
        data[1]["choices"][0]["finish_reason"] == "stop")  # less the EOS
    if not lp or len(lp) != n_lp or len(logits) < len(lp):
        raise AssertionError(f"logprobs: {len(lp)} entries for {n_lp} "
                             f"tokens, {len(logits)} steps captured")
    worst = 0.0
    for j, entry in enumerate(lp):
        logp = torch.log_softmax(logits[j], dim=-1)
        want = float(logp.max())
        tops = [t["logprob"] for t in entry["top_logprobs"]]
        if len(tops) != 5 or tops != sorted(tops, reverse=True) or \
                entry["logprob"] != tops[0]:
            raise AssertionError(f"logprobs entry {j}: {entry}")
        worst = max(worst, abs(entry["logprob"] - want))
    check("logprobs vs float32 log_softmax of the captured logits", worst,
          LOGPROB_TOL)
    if not watch["mixed"]:
        raise AssertionError("no decode chunk ran guided and unguided slots "
                             "side by side")
    if not 1 <= data[2]["usage"]["completion_tokens"] <= GUIDED_TOKENS:
        raise AssertionError(f"plain page: {data[2]['usage']}")
    layers = cfg.text.num_layers
    want = expected_prefill_launches(cfg, 3, counts["prefix_builds"])
    want.update({name: 0 for name in DECODE_KERNELS})
    want.update(paged_decode_append_quant=layers * counts["decode_steps"],
                paged_decode_append_multi_quant=layers
                * counts["verify_passes"])
    check_launches("guided and logprobs", launches, want)
    n_tok = [d["usage"]["completion_tokens"] for d in data]
    log(f"[guided] 3 pages (guided, logprobs, plain: {n_tok} tokens of "
        f"{GUIDED_TOKENS}, {SERVED_TOKENS}, {GUIDED_TOKENS}) in {wall:.3f}s; "
        f"guided "
        f"text matches the regex ({guided_text[:60]!r}...); logprobs worst "
        f"err {worst:.3e}; {watch['mixed']} chunks with guided and "
        f"unguided slots; {counts['decode_steps']} decode steps, "
        f"{counts['verify_passes']} verify passes")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_s=wall, logprob_err=worst, mixed_chunks=watch["mixed"],
                launches=launches,
                **{k: counts[k] for k in ("decode_steps", "verify_passes")})


# ---------------------------------------------------------------------------
# phase 12 of the docstring: training
# ---------------------------------------------------------------------------

TRAIN_PRESET = "qwen2.5-vl-3b"
TRAIN_YAML = os.path.join(REPO, "configs", "training", "ocr",
                          "karanta_qwen25_3b.yaml")
TRAIN_SEED = 12
TRAIN_DOCS = 5          # one goes to eval (eval_fraction 0.01 -> 1 sample)
TRAIN_LINES = 14        # text-layer lines a page: anchored prompts
GRAD_TOL = 1e-2         # normwise, bf16 gradients vs float32 autograd
TINY_TRAIN_TOL = 1e-4   # tiny float32 step, card vs CPU (relative)
TINY_TRAIN_STEPS = 3
TINY_TRAIN_LR = 1e-3


def normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def autograd_check(name: str, fn, ref, inputs, dout, rows=None) -> dict:
    """fn (the kernel forward through its autograd function, the plain
    backward) against ref (the dense plain version) in float32 autograd from
    the same inputs: the forward at the bf16 limit (over `rows` of the
    sequence axis where given), dq/dk/dv normwise within GRAD_TOL, two calls
    bit-equal; kernel-forward and backward times."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    got = torch.autograd.grad(out, xs, dout)
    fs = [x.detach().float().requires_grad_(True) for x in inputs]
    want_out = ref(*fs)
    want = torch.autograd.grad(want_out, fs, dout.float())
    check_bf16(f"{name} forward (autograd function)", out.detach()[0],
               want_out.detach().to(out.dtype)[0], rows)
    errs = [normwise(g, w) for g, w in zip(got, want)]
    for label, err in zip(("dq", "dk", "dv"), errs):
        if not err <= GRAD_TOL:
            raise AssertionError(f"{name} {label}: normwise {err} > "
                                 f"{GRAD_TOL}")
    with torch.no_grad():
        if not torch.equal(fn(*inputs), fn(*inputs)):
            raise AssertionError(f"{name}: two calls differ")
    fwd_ms = cuda_ms(lambda: fn(*inputs), 5)

    def fwd_bwd():
        ys = [x.detach().requires_grad_(True) for x in inputs]
        torch.autograd.grad(fn(*ys), ys, dout)
    bwd_ms = cuda_ms(fwd_bwd, 3, warmup=1) - fwd_ms
    log(f"  {name}: dq/dk/dv normwise {errs[0]:.2e} / {errs[1]:.2e} / "
        f"{errs[2]:.2e} (tol {GRAD_TOL:g}); two calls bit-equal; kernel "
        f"forward {fwd_ms:.3f} ms, plain backward {bwd_ms:.3f} ms")
    return dict(grad_normwise=errs, forward_ms=fwd_ms, backward_ms=bwd_ms)


def train_kernel_grads(dev, gen, shapes: dict) -> dict:
    """#1 and #2 under autograd at the Qwen2.5-VL-3B training shapes, bf16,
    with the masks of the first row that the 3B trainer ran (``shapes``,
    from its TrainProbe): the decoder's causal flash attention (16 query
    heads over 2 kv heads, d = 128, the row's pad mask over its sequence
    bucket), the vision full layers (non-causal, d = 80, the row's patch
    mask) and the window layers through the window kernel's no-rope
    instance."""
    cfg = get_config(TRAIN_PRESET)
    t, v = cfg.text, cfg.vision
    mask = shapes["attn_mask"].to(dev).float()
    s, live = mask.shape[1], int(mask.sum())
    q = torch.randn((1, s, t.num_heads, t.head_dim), generator=gen,
                    device=dev).bfloat16()
    k = torch.randn((1, s, t.num_kv_heads, t.head_dim), generator=gen,
                    device=dev).bfloat16()
    vv = torch.randn_like(k.float()).bfloat16()
    dout = torch.randn_like(q.float()).bfloat16()
    log(f"[train kernels] {TRAIN_PRESET} shapes of the trainer's first row "
        f"under autograd, bf16")
    out = {"decoder": autograd_check(
        f"flash (1,{s},{t.num_heads}/{t.num_kv_heads},{t.head_dim}) causal, "
        f"{live} live", lambda q, k, v: A.attention(q, k, v, kv_mask=mask,
                                                   causal=True),
        lambda q, k, v: A.mha_reference(q, k, v, kv_mask=mask, causal=True),
        (q, k, vv), dout)}
    out["decoder"].update(seq=s, live=live)
    vmask = shapes["vis_valid"].to(dev).float()
    tokens = vmask.shape[1]
    qv, kv_, vv_ = (torch.randn((1, tokens, v.num_heads, v.head_dim),
                                generator=gen, device=dev).bfloat16()
                    for _ in range(3))
    dv = torch.randn_like(qv.float()).bfloat16()
    out["vision_full"] = autograd_check(
        f"flash (1,{tokens},{v.num_heads},{v.head_dim}) vision full, "
        f"{int(vmask.sum())} live", lambda q, k, v: A.attention(
            q, k, v, kv_mask=vmask),
        lambda q, k, v: A.mha_reference(q, k, v, kv_mask=vmask),
        (qv, kv_, vv_), dv)
    w = v.window_patches ** 2
    rows = vmask[0] > 0
    out["window"] = autograd_check(
        f"window no-rope (1,{tokens},{v.num_heads},{v.head_dim}) w={w}",
        lambda q, k, v: A.window_attention(q, k, v, w, kv_mask=vmask),
        lambda q, k, v: A._window_reference(q, k, v, w, vmask, None),
        (qv, kv_, vv_), dv * rows[None, :, None, None], rows)
    return out


def stack_grad_ab(dev) -> dict:
    """The backward's cost of taking each layer from the stacked decoder
    tree of the 3B preset (bf16, the seven matrices and the biases and
    norms): indexing every layer (each layer's backward writes a
    zero-filled gradient of the whole stack) against one
    ``torch.unbind`` (the backward stacks the layers' gradients once). The
    per-layer work is a sum, so the times are the gradients' assembly."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import \
        init_decoder_params
    from karanta_tpu_torch.utils.tree import (flatten_tree, unbind_layers,
                                              unflatten_tree)

    cfg = get_config(TRAIN_PRESET).text
    shapes = init_decoder_params(cfg, None, torch.bfloat16,
                                 device="meta")["layers"]
    leaves = {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=dev)
              .requires_grad_(True) for k, v in flatten_tree(shapes).items()}
    tree = unflatten_tree(leaves)

    def backward(split):
        layers = (unbind_layers(tree, cfg.num_layers) if split == "unbind"
                  else [tree_map(lambda x, _: x[i], tree)
                        for i in range(cfg.num_layers)])
        loss = sum(leaf.float().sum() for layer in layers
                   for leaf in flatten_tree(layer).values())
        torch.autograd.grad(loss, list(leaves.values()))

    out = {split: cuda_ms(lambda: backward(split), 3, warmup=1)
           for split in ("index", "unbind")}
    gbytes = sum(x.numel() * 2 for x in leaves.values()) / 1e9
    log(f"[train] stacked-layer gradients of the {TRAIN_PRESET} decoder "
        f"({cfg.num_layers} layers, {gbytes:.2f} GB bf16): indexed "
        f"{out['index']:.1f} ms, unbind {out['unbind']:.1f} ms a "
        f"backward")
    del leaves, tree
    return dict(out, gbytes=gbytes)


def tiny_train_corpus(root: str) -> str:
    from karanta_tpu_torch.data.synthetic import make_corpus

    make_corpus(root, 3, n_chars=6, seed=TRAIN_SEED)
    return root


def tiny_train_batch(root: str, device) -> tuple:
    from karanta_tpu_torch.training.data import DataCollator, LocalDataset
    from karanta_tpu_torch.training.train import to_device_batch

    cfg = tiny_config(vocab_size=ByteTokenizer().vocab_size)
    pipeline = [{"name": "PDF2ImageStep", "target_longest_image_dim": 128},
                {"name": "FetchPageData"},
                {"name": "StaticLengthDocumentAnchoring",
                 "target_anchor_text_len": 1000},
                {"name": "FinetuningPrompt"},
                {"name": "PlainTextFormat"},
                {"name": "InstructUserMessages", "prompt_first": True},
                {"name": "Tokenizer"}]
    samples = LocalDataset(root, pipeline_steps=pipeline,
                           tokenizer=ByteTokenizer(), vision_cfg=cfg.vision,
                           max_length=2048).build(num_workers=1)
    batch = DataCollator(cfg.vision)(samples[:2])
    return cfg, to_device_batch(batch, device)


def phase_train_tiny(dev) -> dict:
    """The tiny config, float32, one training step's loss and every
    gradient leaf on the card against the CPU, the parameters after 3 AdamW
    steps, and the launch counts of #1 and #2 without and with remat (the
    recompute launches the kernels again)."""
    import tempfile

    from karanta_tpu_torch.training import train_step as ts
    from karanta_tpu_torch.training.optimizer import (make_lr_schedule,
                                                      make_optimizer)
    from karanta_tpu_torch.utils.tree import flatten_tree

    root = tiny_train_corpus(tempfile.mkdtemp(prefix="tiny_train_"))
    cfg, batch_cpu = tiny_train_batch(root, "cpu")
    batch_gpu = {k: v.to(dev) for k, v in batch_cpu.items()}
    params_cpu = init_params(cfg, TRAIN_SEED, torch.float32, device="cpu")
    n_full = len(cfg.vision.fullatt_block_indexes)
    rows = batch_cpu["token_ids"].shape[0]
    per_forward = {"window_attention": (cfg.vision.depth - n_full) * rows,
                   "flash_attention": n_full * rows + cfg.text.num_layers}
    grads, losses, launches = {}, {}, {}
    for remat in (False, True):
        for name, device, batch in (("cpu", "cpu", batch_cpu),
                                    ("cuda", dev, batch_gpu)):
            params = tree_map(lambda x, _: x.to(device), params_cpu)
            kernels.reset_launches()
            loss, tokens, g = ts.value_and_grad(
                ts.make_loss_fn(cfg, remat=remat), params, batch)
            torch.cuda.synchronize()
            launches[(name, remat)] = {
                k: kernels.LAUNCHES[k] for k in per_forward}
            losses[(name, remat)], grads[(name, remat)] = float(loss), g
        want = {k: v * (2 if remat else 1) for k, v in per_forward.items()}
        if launches[("cuda", remat)] != want or \
                sum(launches[("cpu", remat)].values()):
            raise AssertionError(f"tiny train step, remat={remat}: launches "
                                 f"{launches[('cuda', remat)]}, expected "
                                 f"{want} on the card and none on the CPU")
        log(f"[train tiny] remat={remat}: launches {want} (forward"
            f"{' + recompute' if remat else ''})")
    worst = 0.0
    for remat in (False, True):
        lc, lg = losses[("cpu", remat)], losses[("cuda", remat)]
        err = abs(lc - lg) / abs(lc)
        check(f"tiny train loss card vs CPU (remat={remat}, relative)", err,
              TINY_TRAIN_TOL)
        for path, gc_ in grads[("cpu", remat)].items():
            gg = grads[("cuda", remat)][path].cpu()
            scale = float(gc_.abs().max())
            if scale == 0.0:
                if float(gg.abs().max()) != 0.0:
                    raise AssertionError(f"grad {path}: zero on the CPU, "
                                         f"not on the card")
                continue
            worst = max(worst, float((gg - gc_).abs().max()) / scale)
    check("tiny train grads card vs CPU (max abs err / max |grad|, "
          "every leaf)", worst, TINY_TRAIN_TOL)
    states = {}
    for name, device, batch in (("cpu", "cpu", batch_cpu),
                                ("cuda", dev, batch_gpu)):
        opt = make_optimizer("adamw", make_lr_schedule(
            "cosine", TINY_TRAIN_LR, 1, TINY_TRAIN_STEPS))
        state = ts.create_train_state(
            tree_map(lambda x, _: x.to(device, copy=True), params_cpu), opt)
        step = ts.make_train_step(cfg, opt, remat=True)
        for _ in range(TINY_TRAIN_STEPS):
            state, metrics = step(state, batch)
        states[name] = flatten_tree(state.params)
    errs = {k: float((states["cuda"][k].cpu() - v).abs().max())
            for k, v in states["cpu"].items()}
    worst5 = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"[train tiny] largest parameter differences after the steps: "
        f"{[(k, f'{e:.2e}') for k, e in worst5]}; attn/bk "
        f"{max(e for k, e in errs.items() if k.endswith('attn/bk')):.2e}")
    perr = max(errs.values())
    check(f"tiny params after {TINY_TRAIN_STEPS} AdamW steps card vs CPU "
          f"(max abs, every leaf)", perr, TINY_TRAIN_TOL)
    return dict(loss_rel_err=max(abs(losses[("cpu", r)] - losses[("cuda", r)])
                                 / abs(losses[("cpu", r)]) for r in (0, 1)),
                grad_rel_err=worst, param_err=perr,
                launches_remat=launches[("cuda", True)])


def train_corpus(root: str) -> str:
    """TRAIN_DOCS synthetic pages at 1288x994 under a TRAIN_LINES-line text
    layer (anchored prompts), ground truth their text."""
    from karanta_tpu_torch.bench.pipeline_bench import (make_page_array,
                                                        page_text)
    from karanta_tpu_torch.data.synthetic import (ground_truth_json,
                                                  page_to_pdf_bytes)

    for sub in ("pdfs", "json"):
        os.makedirs(os.path.join(root, sub))
    for i in range(TRAIN_DOCS):
        text = page_text(TRAIN_SEED + i, n_lines=TRAIN_LINES)
        with open(os.path.join(root, "pdfs", f"doc{i}.pdf"), "wb") as f:
            f.write(page_to_pdf_bytes(make_page_array(TRAIN_SEED + i),
                                      text_layer=text))
        with open(os.path.join(root, "json", f"doc{i}.json"), "w") as f:
            f.write(ground_truth_json(text))
    return root


class TrainProbe:
    """Wraps the trainer's step and checkpoint functions while main() runs:
    per step its time (synchronized), token counts and #1/#2 launches;
    copies of the small parameter leaves (and of a QLoRA run's NF4 base)
    and of the first row's masks before the first step; the last state;
    each checkpoint write's seconds and bytes."""

    def __init__(self):
        self.steps, self.saves = [], []
        self.snap = self.base = self.base_snap = self.last = None
        self.shapes = None

    def __enter__(self):
        from karanta_tpu_torch.training import checkpoint as ckpt
        from karanta_tpu_torch.training import lora
        from karanta_tpu_torch.training import train_step as ts

        self._saved = (ts.make_train_step, lora.make_lora_train_step,
                       ckpt.save_checkpoint)
        make_step, make_lora, save = self._saved

        def timed(step):
            def run(state, *args):
                batch = args[-1]
                if self.snap is None:
                    self.base = args[0] if len(args) == 3 else None
                    self.snap = {p: x.clone() for p, x in
                                 tree_leaves(state.params)
                                 if x.numel() < 50_000_000}
                    self.base_snap = None if self.base is None else {
                        p: x.clone() for p, x in tree_leaves(self.base)
                        if x.dtype == torch.uint8}
                    self.shapes = {k: batch[k][:1].clone()
                                   for k in ("attn_mask", "vis_valid")}
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                out = step(state, *args)
                torch.cuda.synchronize()
                self.steps.append(dict(
                    s=time.perf_counter() - t0,
                    tokens=int(batch["attn_mask"].sum()),
                    vision_tokens=int(batch["vis_valid"].sum()),
                    vis_pad=int(batch["vis_valid"].numel()),
                    rows=int(batch["attn_mask"].shape[0]),
                    seq=int(batch["attn_mask"].shape[1]),
                    launches={k: kernels.LAUNCHES[k] for k in
                              ("window_attention", "flash_attention")}))
                self.last = out[0]
                return out
            return run

        def saving(output_dir, step, state, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(output_dir, step, state, *a, **kw)
            size = os.path.getsize(os.path.join(path, ckpt.STATE_FILE))
            self.saves.append(dict(path=path, s=time.perf_counter() - t0,
                                   gbytes=size / 1e9))
            return path

        ts.make_train_step = lambda *a, **kw: timed(make_step(*a, **kw))
        lora.make_lora_train_step = lambda *a, **kw: timed(
            make_lora(*a, **kw))
        ckpt.save_checkpoint = saving
        return self

    def changed(self) -> int:
        """How many of the snapshotted leaves the steps changed."""
        now = dict(tree_leaves(self.last.params))
        return sum(not torch.equal(now[p], x) for p, x in self.snap.items())

    def base_unchanged(self) -> bool:
        now = dict(tree_leaves(self.base))
        return all(torch.equal(now[p], x) for p, x in self.base_snap.items())

    def __exit__(self, *exc):
        from karanta_tpu_torch.training import checkpoint as ckpt
        from karanta_tpu_torch.training import lora
        from karanta_tpu_torch.training import train_step as ts

        ts.make_train_step, lora.make_lora_train_step, \
            ckpt.save_checkpoint = self._saved
        return False


def param_count(tree) -> int:
    return sum(leaf.numel() for _, leaf in tree_leaves(tree))


def train_flops(cfg, step: dict) -> float:
    """Useful FLOPs of one step: 6 N T for the decoder (N its parameters,
    the tied head included; T the live tokens), 6 N_vis T_vis for the vision
    tower (T_vis its live patches), and attention's score and value
    products, forward and backward (x3): the decoder's causal 2 S^2 H D a
    row and layer over the bucket, the full vision layers' 4 T^2 H D, the
    window layers' 4 T W H D; the merger's 6 N_merger T_vis / 4. Remat's
    recompute is not counted."""
    t, v = cfg.text, cfg.vision
    n_text = (t.vocab_size * t.hidden_size + t.num_layers * (
        t.hidden_size * (t.num_heads + 2 * t.num_kv_heads) * t.head_dim
        + t.num_heads * t.head_dim * t.hidden_size
        + 3 * t.hidden_size * t.intermediate_size))
    merged = v.merge_unit * v.hidden_size
    n_vis = v.depth * (4 * v.hidden_size ** 2 + 3 * v.hidden_size
                       * v.intermediate_size) + (v.patch_input_dim
                                                 * v.hidden_size)
    n_merger = merged * merged + merged * v.out_hidden_size
    n_full = len(v.fullatt_block_indexes)
    rows = step["rows"]
    t_vis_pad = step["vis_pad"] // rows
    attn = 3 * (rows * t.num_layers * 2 * step["seq"] ** 2 * t.num_heads
                * t.head_dim
                + rows * n_full * 4 * t_vis_pad ** 2 * v.num_heads
                * v.head_dim
                + rows * (v.depth - n_full) * 4 * t_vis_pad
                * v.window_patches ** 2 * v.num_heads * v.head_dim)
    return (6 * n_text * step["tokens"] + 6 * n_vis * step["vision_tokens"]
            + 6 * n_merger * step["vision_tokens"] // v.merge_unit + attn)


def train_run(label: str, argv: list) -> tuple:
    """One main() run under a TrainProbe; peak memory over the run."""
    from karanta_tpu_torch.training.train import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainProbe() as probe:
        metrics = train_main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (math.isfinite(metrics["loss"])
            and math.isfinite(metrics["grad_norm"])):
        raise AssertionError(f"{label}: loss {metrics['loss']}, grad_norm "
                             f"{metrics['grad_norm']}")
    if not probe.changed():
        raise AssertionError(f"{label}: no parameter changed")
    return probe, metrics, dict(wall_s=wall, peak_gib=peak)


def report_steps(label: str, cfg, probe, vision_trains: bool) -> dict:
    """ms/step, tokens/s and the FLOP share of the steps after the first
    (the first builds the optimizer state), printed with the card; checks
    that every step launched #1 and #2 in the forward and again in the
    remat recompute (the vision tower's only where it trains)."""
    n_full = len(cfg.vision.fullatt_block_indexes)
    rows = probe.steps[0]["rows"]
    vis = 2 if vision_trains else 1
    want = {"window_attention": vis * (cfg.vision.depth - n_full) * rows,
            "flash_attention": (vis * n_full + 2 * cfg.text.num_layers)
            * rows}
    for x in probe.steps:
        if x["launches"] != want:
            raise AssertionError(f"{label}: launches a step {x['launches']},"
                                 f" expected {want}")
    steady = probe.steps[1:] or probe.steps
    step_s = sum(x["s"] for x in steady) / len(steady)
    tokens = sum(x["tokens"] for x in steady) / len(steady)
    flops = sum(train_flops(cfg, x) for x in steady) / len(steady)
    out = dict(ms_per_step=step_s * 1e3, tokens_per_s=tokens / step_s,
               tflops=flops / step_s / 1e12,
               flop_share=flops / step_s / PEAK_BF16_FLOPS,
               first_step_ms=probe.steps[0]["s"] * 1e3,
               steps=len(probe.steps), tokens_per_step=tokens,
               seq=probe.steps[0]["seq"], rows=probe.steps[0]["rows"],
               launches_per_step=probe.steps[-1]["launches"])
    log(f"[train {label}] {out['ms_per_step']:.1f} ms/step (first "
        f"{out['first_step_ms']:.1f}), {out['tokens_per_s']:.1f} tokens/s "
        f"({tokens:.0f} live tokens of {out['rows']} x {out['seq']} a step), "
        f"{out['tflops']:.1f} TFLOP/s = {100 * out['flop_share']:.2f}% of "
        f"989 TFLOP/s; #1/#2 launches a step {out['launches_per_step']}")
    return out


def phase_train_full(device: str = "cuda", profile: bool = False
                     ) -> tuple:
    """Three main() runs of the 3B preset's yaml on synthetic pages, from a
    random 3B checkpoint written by the port's exporter beside a BPE
    tokenizer: (a) AdamW, all parameters, 3 steps, the final checkpoint
    read back bit-equal; (b) QLoRA rank 16, 2 steps, the NF4 base
    unchanged; (c) Muon, 2 steps. Then the server CLI serves (a)'s
    checkpoint with --native-checkpoint and answers a page over HTTP.
    With profile, a fourth run (AdamW, 2 steps) traces its second step
    under the trainer's --is_profile and prints the table. Returns the
    stats and the first row's masks of run (a)."""
    import shutil
    import tempfile

    from karanta_tpu_torch.models.qwen25_vl.exporting import \
        save_hf_checkpoint
    from karanta_tpu_torch.training.checkpoint import restore_params

    cfg = get_config(TRAIN_PRESET)
    root = tempfile.mkdtemp(prefix="train_")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    try:
        data = train_corpus(os.path.join(root, "data"))
        model = os.path.join(root, "model")
        params = init_params(cfg, TRAIN_SEED, torch.bfloat16, device=device)
        n_params = param_count(params)
        t0 = time.perf_counter()
        save_hf_checkpoint(params, cfg, model)
        bpe_tokenizer_dir(model)
        log(f"[train] random {TRAIN_PRESET} ({n_params / 1e9:.3f}B "
            f"parameters) written in {time.perf_counter() - t0:.1f}s; "
            f"card: {smi}")
        del params
        base = [TRAIN_YAML, "--model_name_or_path", TRAIN_PRESET,
                "--checkpoint_path", model, "--dataset_root", data,
                "--warmup_steps", "0", "--logging_steps", "1",
                "--checkpointing_steps", "0", "--eval_steps", "0",
                "--device", device]
        stats = {"card": smi, "params": n_params}

        out_a = os.path.join(root, "run_a")
        probe, metrics, run = train_run("adamw", base + [
            "--output_dir", out_a, "--max_steps", "3"])
        stats["adamw"] = {**report_steps("adamw", cfg, probe, True), **run,
                          "loss": metrics["loss"],
                          "grad_norm": metrics["grad_norm"]}
        [save] = probe.saves
        shapes = probe.shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, meta = restore_params(save["path"], device=device)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        have = dict(tree_leaves(probe.last.params))
        got = dict(tree_leaves(restored))
        if got.keys() != have.keys() or meta["step"] != 3 or not all(
                got[p].dtype == x.dtype and torch.equal(got[p], x)
                for p, x in have.items()):
            raise AssertionError("restore_params of run (a)'s checkpoint is "
                                 "not bit-equal to the parameters in memory")
        params_gb = sum(x.numel() * x.element_size()
                        for x in have.values()) / 1e9
        stats["adamw"]["checkpoint"] = dict(
            write_s=save["s"], gbytes=save["gbytes"],
            write_gb_per_s=save["gbytes"] / save["s"], read_params_s=read_s,
            params_gbytes=params_gb, read_gb_per_s=params_gb / read_s)
        log(f"[train adamw] loss {metrics['loss']:.4f}, grad_norm "
            f"{metrics['grad_norm']:.4f}; peak {run['peak_gib']:.2f} GiB; "
            f"checkpoint {save['gbytes']:.2f} GB written in {save['s']:.1f}s "
            f"({save['gbytes'] / save['s']:.2f} GB/s), params "
            f"{params_gb:.2f} GB read back in {read_s:.1f}s "
            f"({params_gb / read_s:.2f} GB/s), bit-equal")
        del probe, restored, got, have
        stats["served"] = serve_native_checkpoint(out_a, model, device)
        shutil.rmtree(out_a, ignore_errors=True)

        probe, metrics, run = train_run("qlora", base + [
            "--output_dir", os.path.join(root, "run_b"), "--max_steps", "2",
            "--use_qlora", "true", "--lora_rank", "16"])
        if not probe.base_unchanged():
            raise AssertionError("QLoRA run: the NF4 base changed")
        stats["qlora"] = {**report_steps("qlora", cfg, probe, False), **run,
                          "loss": metrics["loss"],
                          "grad_norm": metrics["grad_norm"]}
        log(f"[train qlora] loss {metrics['loss']:.4f}, grad_norm "
            f"{metrics['grad_norm']:.4f}; peak {run['peak_gib']:.2f} GiB; "
            f"NF4 base bit-equal before and after; factors changed")
        del probe

        probe, metrics, run = train_run("muon", base + [
            "--output_dir", os.path.join(root, "run_c"), "--max_steps", "2",
            "--optimizer", "muon"])
        stats["muon"] = {**report_steps("muon", cfg, probe, True), **run,
                         "loss": metrics["loss"],
                         "grad_norm": metrics["grad_norm"]}
        log(f"[train muon] loss {metrics['loss']:.4f}, grad_norm "
            f"{metrics['grad_norm']:.4f}; peak {run['peak_gib']:.2f} GiB")
        del probe
        if profile:
            profile_train_step(base, os.path.join(root, "run_profile"))
        return stats, shapes
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def profile_train_step(base: list, out: str) -> None:
    """Two AdamW steps of main() with --is_profile on the second; prints
    the head of its torch.profiler table (device time by op and kernel)."""
    from karanta_tpu_torch.training.train import main as train_main

    gc.collect()
    torch.cuda.empty_cache()
    train_main(base + ["--output_dir", out, "--max_steps", "2",
                       "--is_profile", "true", "--profile_steps", "2"])
    with open(os.path.join(out, "profiles", "profile_step_2.txt")) as f:
        lines = f.read().splitlines()
    log("[train profile] the second 3B AdamW step under --is_profile:")
    for line in lines[:32]:
        log(line[:200])


def serve_native_checkpoint(run_dir: str, tokenizer_dir: str,
                            device: str) -> dict:
    """The server CLI with --native-checkpoint over the training run's dir
    (its newest completed step) and --tokenizer-path answers a page."""
    argv = ["--preset", TRAIN_PRESET, "--native-checkpoint", run_dir,
            "--tokenizer-path", tokenizer_dir, "--device", device,
            "--max-batch-size", "2",
            "--max-model-len", "4096", "--decode-chunk", "8"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine, name = build_engine_from_args(make_arg_parser().parse_args(argv))
    build_s = time.perf_counter() - t0
    png = make_page_png(seed=TRAIN_SEED)
    with serving(engine) as (server, port):
        status, raw = http_call(port, "POST", "/v1/chat/completions",
                                page_body(png))
    if status != 200:
        raise AssertionError(f"--native-checkpoint server: HTTP {status}: "
                             f"{raw[:300]!r}")
    data = json.loads(raw)
    n = data["usage"]["completion_tokens"]
    reason = data["choices"][0]["finish_reason"]
    if not 1 <= n <= SERVED_TOKENS or reason not in ("stop", "length") \
            or not name.startswith("native-step_3"):
        raise AssertionError(f"--native-checkpoint server ({name}): {data}")
    log(f"[train] --native-checkpoint server ({name}): built in "
        f"{build_s:.1f}s, one page answered, {n} tokens ({reason})")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(build_s=build_s, completion_tokens=n, finish_reason=reason)


def phase_training(profile: bool = False) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    full, shapes = phase_train_full(profile=profile)
    grads = train_kernel_grads(dev, gen, shapes)
    stack = stack_grad_ab(dev)
    gc.collect()
    torch.cuda.empty_cache()
    tiny = phase_train_tiny(dev)
    return dict(kernel_grads=grads, stack_grads=stack, tiny=tiny,
                full=full, seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 13: the document classifiers
# ---------------------------------------------------------------------------

# H100 SXM data sheet: kernel #2's float32 instance runs on the tensor
# cores in 3xTF32 (three TF32 products a float32 product), whose least time
# is the flops at a third of the dense TF32 rate; float32 on the CUDA cores
# is the bound the instance was first held to, kept beside it
PEAK_3XTF32_FLOPS = 494.7e12 / 3
PEAK_F32_CUDA_CORE_FLOPS = 67e12
CLS_SEED = 13
CLS_ARCHS = ("segformer", "vit", "convnextv2", "resnet")
# served batch of each arch and kernel #2's launches in one forward
CLS_BATCH = {"segformer": 16, "vit": 32, "convnextv2": 16, "resnet": 16}
CLS_FLASH = {"segformer": 8, "vit": 12, "convnextv2": 0, "resnet": 0}
CLS_LOGIT_TOL = 1e-4  # card vs CPU, relative to max |logit|; TF32 off
CLS_YAML = os.path.join(REPO, "configs", "training", "classification",
                        "segment_{}.yaml")
CLS_TRAIN_STEPS = {"segformer": 3, "vit": 2}
CLS_PAGES = 10  # pages a label in the trainer's image folder


def classifier_flash_shapes() -> dict:
    """name -> (b, sq, sk, h, d) of kernel #2's calls in one forward at the
    served batches: each SegFormer (mit-b0, 512 px) stage's queries over its
    sequence-reduced keys, and the ViT of segment_vit.yaml."""
    from karanta_tpu_torch.models.classifier.segformer import SegFormerConfig
    from karanta_tpu_torch.models.classifier.vit import ViTConfig

    seg, vit = SegFormerConfig(), ViTConfig()
    shapes, side = {}, seg.image_size
    for si in range(seg.num_stages):
        side //= seg.strides[si]
        heads = seg.num_heads[si]
        shapes[f"segformer_stage{si + 1}"] = (
            CLS_BATCH["segformer"], side * side,
            (side // seg.sr_ratios[si]) ** 2, heads,
            seg.hidden_sizes[si] // heads)
    shapes["vit"] = (CLS_BATCH["vit"], vit.num_patches + 1,
                     vit.num_patches + 1, vit.num_heads, vit.head_dim)
    return shapes


def kernel_flash_f32_classifiers(dev, gen) -> dict:
    """Kernel #2's float32 instance at the classifiers' shapes against its
    plain version (within F32_ATOL, two calls bit-equal), with the kernel's
    ms by events and by a CUDA graph of 20 calls, the plain version's,
    float32 SDPA's (a yardstick the port never calls) and the factor
    against it, and the bound: 4 B H Sq Sk D flops at 164.9 TFLOP/s (3xTF32
    on the tensor cores) or the bytes at 3.35 TB/s, with the same at 67
    TFLOP/s (CUDA-core float32) as bound_cuda_core_*. Logs the instance's registers, spills, shared memory and blocks
    per SM at each head dim first."""
    info = {d: A.flash_attention_info(d, torch.float32)
            for d in A.FLASH_F32_HEAD_DIMS}
    for d, row in info.items():
        log(f"  flash f32 D={d}: {row}")
    out = {"resources": info}
    for name, (b, sq, sk, h, d) in classifier_flash_shapes().items():
        q = torch.randn((b, sq, h, d), generator=gen, device=dev)
        k = torch.randn((b, sk, h, d), generator=gen, device=dev)
        v = torch.randn((b, sk, h, d), generator=gen, device=dev)
        got = A.flash_attention(q, k, v)
        again = A.flash_attention(q, k, v)
        want = A.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(f"flash_attention f32 {name} {tuple(q.shape)} kv "
              f"{tuple(k.shape)}", err, F32_ATOL)
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention f32 {name}: two calls "
                                 f"differ")
        del got, again, want
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops = 4.0 * b * h * sq * sk * d
        n_bytes = 4.0 * (2 * b * sq * h * d + 2 * b * sk * h * d)
        t_ops, t_bytes = flops / PEAK_3XTF32_FLOPS, n_bytes / PEAK_BYTES
        row = dict(
            shape=[b, sq, sk, h, d], max_abs_err=err,
            ms=cuda_ms(lambda: A.flash_attention(q, k, v), 10),
            device_ms=graph_ms(lambda: A.flash_attention(q, k, v)),
            plain_ms=cuda_ms(lambda: A.flash_attention_plain(q, k, v), 3),
            sdpa_ms=cuda_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(qt, kt, vt), 10),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
        t_cc = flops / PEAK_F32_CUDA_CORE_FLOPS
        row["bound_cuda_core_ms"] = max(t_cc, t_bytes) * 1e3
        row["bound_cuda_core_by"] = ("operations" if t_cc >= t_bytes
                                     else "bytes")
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        row["bound_cuda_core_share"] = (row["bound_cuda_core_ms"]
                                        / row["device_ms"])
        row["sdpa_factor"] = row["device_ms"] / row["sdpa_ms"]
        row["tflops"] = flops / row["device_ms"] * 1e-9
        log(f"  flash f32 {name}: kernel {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms ({row['tflops']:.2f} TFLOP/s, "
            f"{100 * row['bound_share']:.1f}% of the {row['bound_ms']:.4f} "
            f"ms 3xTF32 bound by {row['bound_by']}, "
            f"{100 * row['bound_cuda_core_share']:.1f}% of the "
            f"{row['bound_cuda_core_ms']:.4f} ms bound at 67 TFLOP/s by "
            f"{row['bound_cuda_core_by']}), plain {row['plain_ms']:.4f} ms, "
            f"SDPA f32 {row['sdpa_ms']:.4f} ms ({row['sdpa_factor']:.2f}x "
            f"SDPA's time)")
        out[name] = row
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def classifier_pages(n: int) -> list:
    """n synthetic 1288x994 page images (PIL), decoded from the PNGs the
    engine phases serve."""
    import io

    from PIL import Image

    return [Image.open(io.BytesIO(base64.b64decode(make_page_png(seed=i))))
            .convert("RGB") for i in range(n)]


def phase_classifier_serving(device: str = "cuda") -> dict:
    """LayoutClassifier on the card for each arch at its preset geometry
    from seeded random weights: predict_batch over the served batch of
    synthetic pages, kernel #2's launches a batch, the logits against the
    same weights and pixels on the CPU, images/s end to end (host resize
    included) and of the forward alone, peak memory."""
    from karanta_tpu_torch.inference.image_classifier import LayoutClassifier

    pages = classifier_pages(max(CLS_BATCH.values()))
    stats = {}
    for arch in CLS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n = CLS_BATCH[arch]
        clf = LayoutClassifier.random(seed=CLS_SEED, arch=arch,
                                      device=device)
        clf.predict_batch(pages[:n])  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        preds = clf.predict_batch(pages[:n])
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = {"flash_attention": CLS_FLASH[arch]} if CLS_FLASH[arch] else {}
        if launches != want or len(preds) != n:
            raise AssertionError(f"classifier {arch}: launches {launches}, "
                                 f"expected {want}; {len(preds)} predictions")
        t0 = time.perf_counter()
        for _ in range(3):
            clf.predict_batch(pages[:n])
        torch.cuda.synchronize()
        e2e_s = (time.perf_counter() - t0) / 3
        batch = np.stack([clf.preprocess(p) for p in pages[:n]])
        fwd_ms = cuda_ms(lambda: clf.logits(batch), 5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = clf.logits(batch).cpu()
        params_cpu = tree_map(lambda x, _: x.to("cpu"), clf.params)
        cpu = LayoutClassifier(params_cpu, clf.cfg, arch=arch, device="cpu")
        want_logits = cpu.logits(batch)
        rel = float((got - want_logits).abs().max()
                    / want_logits.abs().max())
        check(f"classifier {arch} logits card vs CPU (max abs err / max "
              f"|logit|)", rel, CLS_LOGIT_TOL)
        if not torch.equal(got.argmax(-1), want_logits.argmax(-1)):
            raise AssertionError(f"classifier {arch}: labels differ between "
                                 f"the card and the CPU")
        stats[arch] = dict(batch=n, launches=launches, logit_rel_err=rel,
                           images_per_s=n / e2e_s, batch_s=e2e_s,
                           forward_ms=fwd_ms,
                           forward_images_per_s=n / fwd_ms * 1e3,
                           peak_gib=peak)
        log(f"[classify] {arch} (B={n}, {clf.cfg.image_size} px): "
            f"{n / e2e_s:.1f} images/s end to end ({e2e_s * 1e3:.1f} ms a "
            f"batch), forward {fwd_ms:.2f} ms ({n / fwd_ms * 1e3:.1f} "
            f"images/s), peak {peak:.2f} GiB, launches {launches}")
        del clf, cpu, params_cpu
    return stats


def classifier_folder(root: str) -> str:
    """A two-label image folder for the classifier trainer, made by the
    port's data/convert_pdf_2_image.py from PDFs that data/synthetic.py
    writes: "no_segment" pages of one text column, "segment" pages cut by
    a gutter and a rule into articles."""
    from karanta_tpu_torch.bench.pipeline_bench import make_page_array
    from karanta_tpu_torch.data.convert_pdf_2_image import \
        convert_pdfs_to_images
    from karanta_tpu_torch.data.synthetic import pages_to_pdf_bytes

    folder = os.path.join(root, "images")
    for label in ("no_segment", "segment"):
        pages = []
        for i in range(CLS_PAGES):
            page = make_page_array(1000 * (label == "segment") + i)
            if label == "segment":
                page[:, 487:507] = 235          # column gutter
                page[640:646, 60:-60] = 40      # article rule
            pages.append(page)
        pdf_dir = os.path.join(root, "pdfs", label)
        os.makedirs(pdf_dir)
        half = CLS_PAGES // 2
        for j, chunk in enumerate((pages[:half], pages[half:])):
            with open(os.path.join(pdf_dir, f"{label}_{j}.pdf"), "wb") as f:
                f.write(pages_to_pdf_bytes(chunk))
        n = convert_pdfs_to_images(pdf_dir, os.path.join(folder, label),
                                   target_dim=1288, workers=2)
        if n != CLS_PAGES:
            raise AssertionError(f"convert_pdf_2_image wrote {n} pages of "
                                 f"{label}, expected {CLS_PAGES}")
    return folder


class ClassifierProbe:
    """Wraps classifier_train.make_train_step while main() runs: each
    step's time (synchronized) and launches, the time since the previous
    step began (host batch loading included), a copy of the parameters
    before the first step, the last state; with `profile` the first step
    runs under torch.profiler for the card's busy share."""

    def __init__(self, profile: bool = False):
        self.steps, self.p0, self.state = [], None, None
        self.profile, self.busy = profile, None

    def __enter__(self):
        from karanta_tpu_torch.training import classifier_train as ct
        from karanta_tpu_torch.utils.tree import flatten_tree

        self._ct, self._make = ct, ct.make_train_step
        make = self._make

        def make_timed(forward, cfg, optimizer):
            step = make(forward, cfg, optimizer)

            def run(params, opt_state, images, label_ids):
                if self.p0 is None:
                    self.p0 = {k: v.detach().clone()
                               for k, v in flatten_tree(params).items()}
                start = int(opt_state["count"])  # the step updates it in place
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gap = (t0 - self.steps[-1]["t0"]) if self.steps else None
                kernels.reset_launches()
                profiled = self.profile and not self.steps
                if profiled:
                    from torch.profiler import ProfilerActivity, profile
                    prof = profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                    prof.__enter__()
                out = step(params, opt_state, images, label_ids)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if profiled:
                    prof.__exit__(None, None, None)
                    busy = sum(e.self_device_time_total
                               for e in prof.key_averages()
                               if e.device_type.name == "CUDA") / 1e3
                    self.busy = dict(step_ms=ms, busy_ms=busy,
                                     share=busy / ms)
                self.steps.append(dict(
                    t0=t0, ms=ms, gap_ms=None if gap is None else gap * 1e3,
                    start=start, loss=float(out[2]),
                    launches={k: v for k, v in kernels.LAUNCHES.items()
                              if v}))
                self.state = {"params": out[0], "opt_state": out[1]}
                return out
            return run

        ct.make_train_step = make_timed
        return self

    def __exit__(self, *exc):
        self._ct.make_train_step = self._make

    def changed(self) -> int:
        from karanta_tpu_torch.utils.tree import flatten_tree

        now = flatten_tree(self.state["params"])
        return sum(not torch.equal(now[k], v) for k, v in self.p0.items())


def attention_bwd_ms(dev, gen, b, sq, sk, h, d) -> dict:
    """Kernel #2's forward and the plain blockwise backward (512-row query
    chunks past 512 queries) at one classifier shape, ms by events."""
    q = torch.randn((b, sq, h, d), generator=gen, device=dev)
    k = torch.randn((b, sk, h, d), generator=gen, device=dev)
    v = torch.randn((b, sk, h, d), generator=gen, device=dev)
    out = A.flash_attention(q, k, v)
    dout = torch.randn_like(out)
    bwd = (A._attention_bwd_q_chunked if sq > A._BWD_Q_CHUNK
           else A._attention_bwd_math)
    return dict(forward_ms=cuda_ms(lambda: A.flash_attention(q, k, v), 10),
                backward_ms=cuda_ms(lambda: bwd(q, k, v, None, out, dout,
                                                False, None, 0), 3))


def classifier_train_run(arch: str, folder: str, out_dir: str,
                         device: str = "cuda") -> dict:
    """classifier_train.main() at the arch's yaml for CLS_TRAIN_STEPS
    steps, then `auto` resumes from its final checkpoint for one more."""
    from karanta_tpu_torch.training import checkpoint as ckpt
    from karanta_tpu_torch.training import classifier_train as ct
    from karanta_tpu_torch.utils.tree import flatten_tree

    steps = CLS_TRAIN_STEPS[arch]
    argv = [CLS_YAML.format(arch), "--dataset_dir", folder, "--output_dir",
            out_dir, "--device", device]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with ClassifierProbe() as probe:
        metrics = ct.main(argv + ["--max_steps", str(steps)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not math.isfinite(metrics["loss"]) or not probe.changed():
        raise AssertionError(f"classifier train {arch}: loss "
                             f"{metrics['loss']}, {probe.changed()} leaves "
                             f"changed")
    want = {"flash_attention": CLS_FLASH[arch]}
    bad = [s["launches"] for s in probe.steps if s["launches"] != want]
    if len(probe.steps) != steps or bad:
        raise AssertionError(f"classifier train {arch}: {len(probe.steps)} "
                             f"steps, launches {bad}, expected {want} a step")
    last = ckpt.get_last_checkpoint(out_dir)
    restored, meta = ckpt.restore_checkpoint(last, probe.state)
    saved, back = flatten_tree(probe.state), flatten_tree(restored)
    if meta.get("step") != steps or any(
            not torch.equal(back[k], v) for k, v in saved.items()):
        raise AssertionError(f"classifier train {arch}: checkpoint {last} "
                             f"does not read back bit-equal")
    # the resumed step runs warm: it is the one profiled
    with ClassifierProbe(profile=True) as resumed:
        ct.main(argv + ["--max_steps", str(steps + 1),
                        "--resume_from_checkpoint", "auto"])
    if [s["start"] for s in resumed.steps] != [steps]:
        raise AssertionError(f"classifier train {arch}: auto resume ran "
                             f"steps from {[s['start'] for s in resumed.steps]}")
    n = CLS_BATCH[arch]
    later = probe.steps[1:]
    step_ms = sum(s["ms"] for s in later) / len(later)
    iter_ms = sum(s["gap_ms"] for s in later) / len(later)
    stats = dict(steps=steps, loss=metrics["loss"],
                 eval_accuracy=metrics.get("eval_accuracy"),
                 changed_leaves=probe.changed(), step_ms=step_ms,
                 iteration_ms=iter_ms, images_per_s=n / iter_ms * 1e3,
                 first_step_ms=probe.steps[0]["ms"], busy=resumed.busy,
                 busy_share_of_step=resumed.busy["busy_ms"] / step_ms,
                 busy_share_of_iteration=resumed.busy["busy_ms"] / iter_ms,
                 peak_gib=peak, launches_per_step=want)
    log(f"[classify train] {arch} (batch {n}): loss {metrics['loss']:.4f}, "
        f"step {step_ms:.1f} ms, iteration with the host's batch "
        f"{iter_ms:.1f} ms ({stats['images_per_s']:.1f} images/s), card "
        f"busy {resumed.busy['busy_ms']:.1f} ms of a profiled "
        f"{resumed.busy['step_ms']:.1f} ms step "
        f"({100 * resumed.busy['share']:.1f}%; "
        f"{100 * stats['busy_share_of_step']:.1f}% of an unprofiled step, "
        f"{100 * stats['busy_share_of_iteration']:.1f}% of an iteration), "
        f"peak {peak:.2f} GiB, {want} a step; checkpoint bit-equal, auto "
        f"resume from step {steps}")
    return stats


def classifier_tiny_check(dev) -> dict:
    """The tiny SegFormer and ViT in float32, card against CPU from the same
    weights and batch: the loss and every gradient leaf of one step, and
    every parameter after 3 steps of the trainer's AdamW. The key biases'
    exact gradient is zero, so their gradients are rounding noise, held to
    the tree's scale, and Adam scales that noise to the learning rate: an
    early Adam step moves a leaf by at most its learning rate, so their
    parameters are held within twice the steps' summed rates (0 + 1 + 0.5
    learning rates: 3 learning rates) and reported."""
    from karanta_tpu_torch.models.classifier.convert import get_arch
    from karanta_tpu_torch.training import classifier_train as ct
    from karanta_tpu_torch.training import train_step as ts
    from karanta_tpu_torch.training.optimizer import (make_adamw,
                                                      make_lr_schedule)
    from karanta_tpu_torch.utils.tree import flatten_tree

    out = {}
    for arch, per_fwd in (("segformer", 2), ("vit", 2)):
        spec = get_arch(arch)
        cfg = spec.tiny()
        params_cpu = spec.init(cfg, CLS_SEED, device="cpu")
        g = torch.Generator().manual_seed(CLS_SEED)
        x = torch.randn((4, cfg.image_size, cfg.image_size, 3), generator=g)
        y = torch.tensor([0, 1, 1, 0])
        loss_fn = ct.classifier_loss(spec.forward, cfg)
        res = {}
        for device in ("cpu", dev):
            params = tree_map(lambda t, _: t.to(device, copy=True),
                              params_cpu)
            kernels.reset_launches()
            loss, _, grads = ts.value_and_grad(
                loss_fn, params, x.to(device), y.to(device))
            launches = kernels.LAUNCHES["flash_attention"]
            opt = make_adamw(make_lr_schedule("cosine", TINY_TRAIN_LR, 1,
                                              TINY_TRAIN_STEPS), 0.01,
                             decay_all_leaves=True)
            state = opt.init(params)
            step = ct.make_train_step(spec.forward, cfg, opt)
            for _ in range(TINY_TRAIN_STEPS):
                params, state, _, _ = step(params, state, x.to(device),
                                           y.to(device))
            res[str(device)] = (float(loss), {k: v.cpu() for k, v in
                                              grads.items()},
                                {k: v.cpu() for k, v in
                                 flatten_tree(params).items()}, launches)
        (lc, gc_, pc, nc), (lg, gg, pg, ng) = res["cpu"], res[str(dev)]
        if nc or ng != per_fwd:
            raise AssertionError(f"tiny {arch}: {ng} flash launches on the "
                                 f"card ({per_fwd} expected), {nc} on the CPU")
        check(f"tiny {arch} train loss card vs CPU (relative)",
              abs(lc - lg) / abs(lc), TINY_TRAIN_TOL)
        top = max(float(v.abs().max()) for v in gc_.values())
        gerr = max(float((gg[k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-2 * top)
                   for k, v in gc_.items())
        check(f"tiny {arch} grads card vs CPU (max abs err / max(max |grad| "
              f"of the leaf, 1e-2 of the tree's), every leaf)", gerr,
              TINY_TRAIN_TOL)
        perrs = {k: float((pg[k] - v).abs().max()) for k, v in pc.items()}
        bk = max(e for k, e in perrs.items() if k.endswith("bk"))
        perr = max(e for k, e in perrs.items() if not k.endswith("bk"))
        check(f"tiny {arch} params after {TINY_TRAIN_STEPS} AdamW steps card "
              f"vs CPU (max abs, every leaf but the key biases)", perr,
              TINY_TRAIN_TOL)
        check(f"tiny {arch} key biases after the steps (max abs)", bk,
              3 * TINY_TRAIN_LR)
        out[arch] = dict(loss_rel_err=abs(lc - lg) / abs(lc), grad_err=gerr,
                         param_err=perr, key_bias_err=bk, launches=ng)
    return out


def phase_classifiers(device: str = "cuda") -> dict:
    """Phase 13: kernel #2's float32 instance at the classifiers' shapes,
    the four archs served, the SegFormer and ViT trainers at their yamls,
    the attention backward beside the kernel's forward, and the tiny
    card-vs-CPU training check."""
    import tempfile

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(CLS_SEED)
    t0 = time.perf_counter()
    log("[classify] kernel #2 float32 at the classifiers' shapes")
    flash = kernel_flash_f32_classifiers(dev, gen)
    serving = phase_classifier_serving(device)
    # the process's first profiler run starts CUPTI, seconds that
    # would land in the profiled training step: start it here
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).sum()
            torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="classifier_")
    try:
        folder = classifier_folder(root)
        training = {arch: classifier_train_run(
            arch, folder, os.path.join(root, f"run_{arch}"), device)
            for arch in CLS_TRAIN_STEPS}
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    shapes = classifier_flash_shapes()
    backward = {name: attention_bwd_ms(dev, gen, *shapes[name])
                for name in ("segformer_stage1", "vit")}
    for name, row in backward.items():
        log(f"[classify train] attention at {name} {shapes[name]}: kernel "
            f"forward {row['forward_ms']:.3f} ms, plain backward "
            f"{row['backward_ms']:.3f} ms")
    gc.collect()
    torch.cuda.empty_cache()
    tiny = classifier_tiny_check(dev)
    return dict(flash_f32=flash, serving=serving, training=training,
                attention_backward=backward, tiny=tiny,
                seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 14: batched prefill, the W8A8 vision tower, the in-process entry
# points
# ---------------------------------------------------------------------------

B14_PAGES = 8
B14_SLOTS = 8
# batched against per-page prefill. The decoder at batch K is bit-equal to
# batch 1 on equal vision tokens (checked); the vision tower's bf16 GEMMs at
# K x 5,120 rows round differently from 5,120, so the batched encode's
# tokens differ from the single encode's, by less than two bf16 roundings
# normwise (VISION_NORM_TOL = 2^-8, checked); the random-weight W8A8 decoder
# turns that into a page's logits difference: half an ulp of noise on the
# single encode's tokens moves the logits 1.8-1.9e-2 normwise (an H100 80GB
# HBM3 at 700 W; measured again each run as the noise floor), so the logits
# bound is 1.5x that floor's top, 3e-2, and not the decode streams' 2e-2
VISION_NORM_TOL = 2.0 ** -8
PREFILL_NORM_TOL = 3e-2
SINGLE_PAGE_TOKENS = 16
CONVERT_PDFS = 2


def batched_engine(params, cfg, quantize, **over) -> Engine:
    """Phase 14's engine: 7B, int8 weights, W8A8, int8 KV, 1,920 rows, 8
    slots, chunk 8, the smoke's prefill buckets."""
    ecfg = EngineConfig(
        max_batch_size=B14_SLOTS, max_seq_len=1920, decode_chunk=CHUNK,
        prefill_buckets=(512, 1024, 1408), image_token_buckets=(2048,),
        dtype=torch.bfloat16, quantize=quantize, kv_quantize="int8",
        act_quant="int8", **over)
    return Engine(params, cfg, NoStopTokenizer(), ecfg, device="cuda")


def page_requests(pages: list, max_tokens: int, tag: str = "page") -> list:
    return [GenRequest(messages=page_messages(png), max_tokens=max_tokens,
                       temperature=0.0, request_id=f"{tag}-{i}")
            for i, png in enumerate(pages)]


def batched_wave(label: str, engine, cfg, pages: list, warm: list) -> dict:
    """generate over the pages after a warm-up wave (BATCHED_PAGES pages x 2
    tokens, so a batched engine warms its batched path): launches, decode
    steps and verify passes of the counted run, its wall time, peak memory
    and the KARANTA_ENGINE_TIMING accumulators."""
    engine.generate(page_requests(warm, 2, "warm"))
    torch.cuda.synchronize()
    counts = instrument(engine)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(page_requests(pages, MAX_TOKENS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    vocab = cfg.text.vocab_size
    for r in results:
        if len(r.token_ids) != MAX_TOKENS or not all(
                0 <= t < vocab for t in r.token_ids):
            raise AssertionError(f"[batched {label}] {r.request_id}: bad "
                                 f"tokens {r.token_ids}")
    timing = engine.timing
    out = dict(pages_per_s=len(pages) / wall, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               decode_steps=counts["decode_steps"],
               verify_passes=counts["verify_passes"], launches=launches,
               prepare_wait_ms=timing["prep_wait"] / len(pages) * 1e3,
               prepare_ms=timing["prepare"] / len(pages) * 1e3,
               tokens=[r.token_ids for r in results])
    log(f"[batched {label}] {len(pages)} pages x {MAX_TOKENS} tokens in "
        f"{wall:.3f}s: {out['pages_per_s']:.4f} pages/s; "
        f"{out['decode_steps']} decode steps, {out['verify_passes']} verify "
        f"passes; prepare {out['prepare_ms']:.1f} ms/page in the pool, the "
        f"main thread waited {out['prepare_wait_ms']:.1f} ms/page; peak "
        f"{out['peak_gib']:.2f} GiB; launches {launches}")
    return out


def check_batched_launches(label: str, cfg, wave: dict, n_encodes: int
                           ) -> None:
    """#1 once a vision window layer and #2 once a full layer and a decoder
    layer, per encode (a page, or a batched group); #3 once a layer a decode
    step, #4 once a layer a verify pass."""
    n_full = len(cfg.vision.fullatt_block_indexes)
    layers = cfg.text.num_layers
    want = {"window_attention": (cfg.vision.depth - n_full) * n_encodes,
            "flash_attention": (n_full + layers) * n_encodes,
            "paged_decode_append_quant": layers * wave["decode_steps"],
            "paged_decode_append_multi_quant":
                layers * wave["verify_passes"]}
    check_launches(f"batched {label}", wave["launches"], want)


@contextlib.contextmanager
def vision_encoder(replace=None, record=None):
    """Within the block the vision encoder records each call's (args,
    kwargs, output) in `record` and, with `replace`, returns that tensor
    instead of encoding."""
    from karanta_tpu_torch.models.qwen25_vl import vision as vis

    encode = vis.encode_image

    def wrapped(*args, **kwargs):
        out = encode(*args, **kwargs) if replace is None else replace
        if record is not None:
            record.append((args, kwargs, out))
        return out

    vis.encode_image = wrapped
    try:
        yield
    finally:
        vis.encode_image = encode


def prefill_logits(engine, pages: list, group: int) -> tuple:
    """(pages, V) float32 first-token logits, one prefill a page (group 1)
    or one prefill_batch a group, and the vision encoder's calls."""
    reqs = page_requests(pages, 1)
    out, calls = [], []
    with vision_encoder(record=calls):
        for i in range(0, len(reqs), group):
            prepared = [engine.prepare(r) for r in reqs[i:i + group]]
            if group == 1:
                logits = engine.prefill(prepared[0])[0][None]
            else:
                logits = engine.prefill_batch(prepared)[0]
            out.append(logits.float())
    return torch.cat(out), calls


def check_batched_prefill(engine, pages: list, single: tuple,
                          batched: tuple) -> dict:
    """Where batched and per-page prefill part, page by page: the batched
    encode's tokens against the single encode's (within VISION_NORM_TOL),
    the per-page prefill run on the batched encode's tokens against
    prefill_batch's logits (bit-equal: the decoder at batch K is batch 1's
    arithmetic), and the noise floor, the per-page prefill's logits with
    half an ulp of uniform noise on its own vision tokens. Then the logits
    (within PREFILL_NORM_TOL, greedy tokens equal where the margin is
    clear)."""
    (logits_a, calls_a), (logits_b, calls_b) = single, batched
    enc_a, enc_b = ([c[2] for c in calls] for calls in (calls_a, calls_b))
    prepared = engine.prepare(page_requests(pages[:1], 1)[0])
    feed = prepared.image_feeds[0]
    ext = torch.from_numpy(
        feed["extract"][:feed["layout"].num_merged]).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    vision, floor = [], []
    for i, png in enumerate(pages):
        group, j = divmod(i, BATCHED_PAGES)
        pm = enc_b[group].shape[0] // BATCHED_PAGES
        tokens_b = enc_b[group][j * pm:(j + 1) * pm]
        want = enc_a[i][ext].float()
        vision.append(float((tokens_b[ext].float() - want).norm()
                            / want.norm()))
        req = page_requests([png], 1)[0]
        with vision_encoder(replace=tokens_b):
            logits = engine.prefill(engine.prepare(req))[0].float()
        if not torch.equal(logits, logits_b[i]):
            raise AssertionError(
                f"[batched] page {i}: per-page prefill on the batched "
                f"encode's tokens is not bit-equal to prefill_batch's "
                f"(max diff {float((logits - logits_b[i]).abs().max())})")
        noise = (torch.rand(enc_a[i].shape, generator=gen, device="cuda")
                 - 0.5) * 2.0 ** -7
        noisy = (enc_a[i].float() * (1 + noise)).to(enc_a[i].dtype)
        with vision_encoder(replace=noisy):
            logits = engine.prefill(engine.prepare(req))[0].float()
        floor.append(float((logits - logits_a[i]).norm()
                           / logits_a[i].norm()))
    log(f"[batched] vision tokens, batched vs single encode, normwise "
        f"{[f'{x:.3e}' for x in vision]} (bound {VISION_NORM_TOL:.3e}); "
        f"the decoder on equal tokens: prefill_batch bit-equal to per-page "
        f"prefill on every page; noise floor (half an ulp on the vision "
        f"tokens) {[f'{x:.3e}' for x in floor]}")
    if not max(vision) <= VISION_NORM_TOL:
        raise AssertionError(f"[batched] vision tokens differ "
                             f"{max(vision):.3e} > {VISION_NORM_TOL:.3e}")
    norms = compare_logits("batched B vs A", logits_a, logits_b,
                           PREFILL_NORM_TOL)
    return dict(logits_vs_A=norms, vision_vs_single=vision,
                noise_floor=floor)


def compare_logits(label: str, want: torch.Tensor, got: torch.Tensor,
                   bound) -> list:
    """Per page: the normwise difference (within `bound` when given) and,
    where want's top-2 margin exceeds twice the largest difference, equal
    greedy tokens."""
    norms, faults = [], []
    for i, (w, g) in enumerate(zip(want, got)):
        diff = float((g - w).norm() / w.norm())
        top2 = torch.topk(w, 2).values
        margin = float(top2[0] - top2[1])
        max_diff = float((g - w).abs().max())
        if bound is not None and not diff <= bound:
            faults.append(f"page {i}: logits differ {diff:.3e} normwise > "
                          f"{bound}")
        if bound is not None and margin > 2 * max_diff and \
                int(w.argmax()) != int(g.argmax()):
            faults.append(f"page {i}: greedy tokens differ at a top-2 "
                          f"margin {margin:.3e}")
        norms.append(diff)
    log(f"[{label}] prefill logits normwise difference per page "
        f"{[f'{x:.3e}' for x in norms]} (max {max(norms):.3e}"
        f"{'' if bound is None else f', bound {bound:g}'})")
    if faults:
        raise AssertionError(f"[{label}] " + "; ".join(faults))
    return norms


def encode_ms(visual, cfg, call) -> float:
    """ms a page of the vision encode of a recorded batched call (args,
    kwargs, output), with the weights `visual`."""
    from karanta_tpu_torch.models.qwen25_vl import vision as vis

    args, kwargs, _ = call
    return cuda_ms(lambda: vis.encode_image(visual, cfg.vision, *args[2:],
                                            **kwargs), 3, warmup=1) / \
        kwargs["n_images"]


def device_busy_ms(fn) -> float:
    """The device time of fn() by torch.profiler (sum of the kernels' self
    time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def prefill_insert_ms(engine, pages: list) -> dict:
    """prefill+insert ms a page at K = 1, 2 and 4 (host clock around work
    that ends in a synchronize, mean of 2 calls) and the device time of one
    call by torch.profiler."""
    out = {}
    for k in (1, 2, BATCHED_PAGES):
        walls, busy = [], None
        for rep in range(3):
            group = [engine.prepare(r)
                     for r in page_requests(pages[rep * k % len(pages):][:k],
                                            MAX_TOKENS)]
            slots = list(range(k))

            def call():
                if k == 1:
                    engine.prefill_insert(0, group[0])
                else:
                    engine.prefill_insert_batch(group, slots)

            torch.cuda.synchronize()
            if rep == 2:
                busy = device_busy_ms(call)
            else:
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            for slot in slots:
                engine.free_slot(slot)
        out[f"K={k}"] = {"ms_per_page": float(np.mean(walls)) / k,
                         "device_ms_per_page": busy / k}
        log(f"[batched] prefill+insert at K={k}: "
            f"{out[f'K={k}']['ms_per_page']:.2f} ms a page (host clock), "
            f"{out[f'K={k}']['device_ms_per_page']:.2f} ms a page on the "
            f"device (torch.profiler)")
    return out


def phase_batched(cfg) -> dict:
    """Phase 14 at qwen2.5-vl-7b (full width and depth, random int8
    weights, W8A8, int8 KV, 8 slots, 1,920 rows, 8 distinct 1288x994 pages
    x 24 tokens, KARANTA_IMG_CACHE_MB=0): A per-page prefill; B
    prefill_batch=4 (#1 56 and #2 64 launches against A's 224 and 256;
    check_batched_prefill against A page by page); C B with
    the W8A8 vision tower (its logits' distance from B's, the encode's ms a
    page, peak memory); D B with speculation (#4 launches); prefill+insert
    ms a page at K = 1, 2, 4; prepare ms a page in the pool against its
    wait. Then the in-process entry points: single_page at 7B, and the OCR
    bench harness's karanta_engine method on the tiny preset (the
    harness's 4,000-token page budget with 7B random weights, which never
    stop, would run for minutes; the 7B engine path is phase 14's and
    single_page's), its outputs scored by the port's bench/scoring.py."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    params, quantize = init_params_bench(cfg, torch.bfloat16, "int8",
                                         device=dev)
    pages = [make_page_png(seed=400 + i) for i in range(B14_PAGES)]
    warm = [make_page_png(seed=450 + i) for i in range(BATCHED_PAGES)]
    stats = {}
    os.environ["KARANTA_ENGINE_TIMING"] = "1"
    try:
        a = batched_engine(params, cfg, quantize)
        stats["A"] = batched_wave("A prefill_batch=1", a, cfg, pages, warm)
        check_batched_launches("A", cfg, stats["A"], B14_PAGES)
        single = prefill_logits(a, pages, 1)
        del a
        b = batched_engine(params, cfg, quantize,
                           prefill_batch=BATCHED_PAGES)
        stats["B"] = batched_wave(f"B prefill_batch={BATCHED_PAGES}", b, cfg,
                                  pages, warm)
        check_batched_launches("B", cfg, stats["B"],
                               B14_PAGES // BATCHED_PAGES)
        batched = prefill_logits(b, pages, BATCHED_PAGES)
        stats["B"].update(check_batched_prefill(b, pages, single, batched))
        stats["B"]["tokens_equal_A"] = stats["B"]["tokens"] == \
            stats["A"]["tokens"]
        stats["prefill_insert"] = prefill_insert_ms(b, pages)
        bf16_visual = b.params["visual"]
        del b
        c = batched_engine(params, cfg, quantize,
                           prefill_batch=BATCHED_PAGES, vision_quant="int8")
        stats["C"] = batched_wave("C W8A8 vision tower", c, cfg, pages, warm)
        check_batched_launches("C", cfg, stats["C"],
                               B14_PAGES // BATCHED_PAGES)
        stats["C"]["logits_vs_B"] = compare_logits(
            "batched C vs B", batched[0],
            prefill_logits(c, pages, BATCHED_PAGES)[0], None)
        call = batched[1][0]
        stats["encode_ms_per_page"] = {
            "bf16": encode_ms(bf16_visual, cfg, call),
            "w8a8": encode_ms(c.params["visual"], cfg, call)}
        log(f"[batched] vision encode of {BATCHED_PAGES} pages: bf16 tower "
            f"{stats['encode_ms_per_page']['bf16']:.2f} ms a page, W8A8 "
            f"tower {stats['encode_ms_per_page']['w8a8']:.2f} ms a page")
        del c, call, single, batched
        d = batched_engine(params, cfg, quantize,
                           prefill_batch=BATCHED_PAGES, speculative_ngram=3)
        stats["D"] = batched_wave("D speculative", d, cfg, pages, warm)
        check_batched_launches("D", cfg, stats["D"],
                               B14_PAGES // BATCHED_PAGES)
        if stats["D"]["verify_passes"] == 0:
            raise AssertionError("[batched D] no verify pass ran")
        del d
    finally:
        os.environ.pop("KARANTA_ENGINE_TIMING", None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for wave in ("A", "B", "C", "D"):
        stats[wave].pop("tokens")
    stats["entry"] = phase_entry_points(cfg)
    stats["seconds"] = time.perf_counter() - t0
    log(f"[batched] phase 14 in {stats['seconds']:.1f}s")
    return stats


def phase_entry_points(cfg) -> dict:
    """single_page at 7B and the bench harness's karanta_engine method on
    the tiny preset, each as a subprocess on the card."""
    import tempfile

    from karanta_tpu_torch.bench.pipeline_bench import make_page_array
    from karanta_tpu_torch.bench.scoring import score_method
    from karanta_tpu_torch.data.synthetic import page_to_pdf_bytes

    out = {}
    with tempfile.TemporaryDirectory(dir=REPO) as root:
        os.makedirs(os.path.join(root, "pdfs"))
        paths = []
        for i in range(CONVERT_PDFS):
            path = os.path.join(root, "pdfs", f"doc{i}.pdf")
            with open(path, "wb") as f:
                f.write(page_to_pdf_bytes(make_page_array(700 + i)))
            paths.append(path)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "karanta_tpu_torch.inference.single_page",
             "--pdf", paths[0], "--preset", cfg.name, "--max-tokens",
             str(SINGLE_PAGE_TOKENS)], cwd=REPO, capture_output=True,
            text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"single_page exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        result = json.loads(run.stdout)
        if not (1 <= result["completion_tokens"] <= SINGLE_PAGE_TOKENS
                and result["finish_reason"] in ("stop", "length")):
            raise AssertionError(f"single_page: {result}")
        out["single_page"] = {
            "seconds": time.perf_counter() - t0,
            **{k: result[k] for k in ("model", "prompt_tokens",
                                      "completion_tokens", "finish_reason",
                                      "latency_s")}}
        log(f"[entry] single_page --preset {cfg.name}: exit 0 in "
            f"{out['single_page']['seconds']:.1f}s, {result}")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "karanta_tpu_torch.bench.convert",
             "karanta_engine:preset=tiny", "--dir", root], cwd=REPO,
            capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"bench.convert exited {run.returncode}: "
                                 f"{run.stderr[-2000:]}")
        outputs = sorted(glob.glob(os.path.join(root, "karanta_engine",
                                                "*.md")))
        if not outputs:
            raise AssertionError(f"bench.convert wrote no output: "
                                 f"{run.stdout[-500:]} {run.stderr[-2000:]}")
        tests = []
        for path in outputs:
            with open(path) as f:
                text = f.read()
            base = os.path.basename(path).split("_pg")[0]
            tests += [{"pdf": f"{base}.pdf", "page": 1, "id": f"{base}-p",
                       "type": "present", "text": text[:12]},
                      {"pdf": f"{base}.pdf", "page": 1, "id": f"{base}-a",
                       "type": "absent", "text": "\u0000never\u0000"}]
        tests.append({"pdf": "missing.pdf", "page": 1, "id": "missing",
                      "type": "present", "text": "x"})
        score = score_method(root, "karanta_engine", tests)
        if (score.passed, score.missing_outputs) != (len(tests) - 1, 1):
            raise AssertionError(f"bench scoring: {score}")
        out["convert"] = {"seconds": time.perf_counter() - t0,
                          "outputs": len(outputs), "passed": score.passed,
                          "total": score.total}
        log(f"[entry] bench.convert karanta_engine:preset=tiny over "
            f"{CONVERT_PDFS} PDFs: exit 0 in {out['convert']['seconds']:.1f}s,"
            f" {len(outputs)} outputs; scored {score.passed}/{score.total} "
            f"(one missing output on purpose)")
    return out


# ---------------------------------------------------------------------------
# phase 15: parallel serving (karanta_tpu_torch.parallel)
# ---------------------------------------------------------------------------

PAR_SEED = 15
PAR_SLOTS, PAR_PAGES, PAR_TOKENS = 4, 4, 24
PAR_TIMEOUT = 600.0     # seconds a rank waits for its peers
PAR_TIMED_PAGES = 2     # pages of the tp=2 timing
# the 4-rank 7B point at cut depth (full width): decoder layers and vision
# blocks (block 7 is a full-attention block)
PAR_2X2_LAYERS, PAR_2X2_BLOCKS = 7, 8
PAR_DECODE_CHUNKS = 2   # timed decode chunks of CHUNK steps
# the tiny engines, float32, 4 slots (2 per data group): the int8 and int4
# caches at the int8 serving point with the W8A8 tower (every prefill
# product int8, so a rank's prefill is one rank's to the bit), and the
# cache in the activations' dtype with float weights. (With the float tower
# under a W8A8 decoder, a row-parallel float32 sum in the tower one rounding
# away from one rank's flips a W8A8 activation rounding: 2.2e-3 on the tiny
# logits in the CPU rehearsal, phase 8's whole bound.)
PAR_TINY = dict(max_batch_size=PAR_SLOTS, max_seq_len=256, decode_chunk=4,
                prefill_buckets=(128, 256), dtype=torch.float32)
PAR_TINY_KINDS = {
    "int8": dict(quantize="int8", kv_quantize="int8", act_quant="int8",
                 vision_quant="int8"),
    "int4": dict(quantize="int8", kv_quantize="int4", act_quant="int8",
                 vision_quant="int8"),
    "bf16": {},
}
PAR_TINY_STEPS = 3


def par_config(preset: str):
    if preset == "tiny":
        return tiny_config(vocab_size=NoStopTokenizer().vocab_size)
    return get_config(preset)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def par_join(rank: int, world: int, url: str, data: int, model: int,
             device: str):
    """Join the ranks' group on `device` ("cuda": every rank on the card)
    and return (mesh, backend)."""
    from karanta_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                 initialize_distributed)

    os.environ["KARANTA_IMG_CACHE_MB"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = initialize_distributed(url, world, rank, device=device,
                                     timeout_s=PAR_TIMEOUT)
    mesh = create_mesh(MeshConfig(data=data, fsdp=1, model=model),
                       device="cpu" if device == "cpu" else None)
    return mesh, backend


def par_engine_cfg(dtype=torch.bfloat16, **over) -> EngineConfig:
    """The 7B points of phase 15: phase 14's engine (int8 weights, W8A8,
    int8 KV, 1,920 rows, chunk 8, the smoke's buckets) at 4 slots."""
    return EngineConfig(
        max_batch_size=PAR_SLOTS, max_seq_len=1920, decode_chunk=CHUNK,
        prefill_buckets=(512, 1024, 1408), image_token_buckets=(2048,),
        dtype=dtype, kv_quantize="int8", act_quant="int8", **over)


def par_pages(n: int) -> list:
    return [make_page_png(seed=PAR_SEED * 100 + i) for i in range(n)]


def prefill_hidden(engine, prepared) -> torch.Tensor:
    """The decoder's hidden states after the prefill of a page (its real
    rows), W8A8, on this rank's shard of the weights."""
    from karanta_tpu_torch.models.qwen25_vl import decoder as dec

    pos, kv_mask, s_pad = engine._padded_prompt(prepared.positions)
    emb = engine._prompt_embeds(prepared, 0, s_pad)
    hidden, _ = dec.prefill_forward(engine.params["text"], engine.cfg.text,
                                    emb[None], pos, kv_mask=kv_mask,
                                    act_quant=True, group=engine._tp_group)
    return hidden[0, :len(prepared.ids)]


def tiny_par_trace(engine) -> dict:
    """The tiny engine on one rank or on every rank of a mesh alike: a
    page prompt's prefill logits; four pages in the four slots, the logits
    of this rank's slots over 3 decode steps and (speculative engines) 3
    verify passes; greedy tokens of a page and of a repeating prompt."""
    rng = np.random.default_rng(0)
    pngs = [base64.b64encode(encode_png_rgb(rng.integers(
        0, 255, size=(84, 112, 3), dtype=np.uint8))).decode()
        for _ in range(PAR_SLOTS)]
    reqs = [GenRequest(messages=page_messages(png), max_tokens=8,
                       request_id=f"tiny-{i}") for i, png in enumerate(pngs)]

    def prepared(req):
        p = engine.prepare(req)
        engine.agree(p)
        return p

    out = {"prefill": engine.prefill(prepared(reqs[0]))[0].float().cpu()}
    for slot, req in enumerate(reqs):
        engine.prefill_insert(slot, prepared(req))
    steps: list = []
    engine.decode_chunk(PAR_TINY_STEPS, logits_out=steps)
    out["steps"] = torch.stack(steps).float().cpu()
    if engine.ecfg.speculative_ngram:
        passes: list = []
        engine.decode_chunk_spec(PAR_TINY_STEPS, logits_out=passes)
        out["passes"] = torch.stack(passes).float().cpu()
    for slot in range(PAR_SLOTS):
        engine.free_slot(slot)
    out["tokens"] = [r.token_ids for r in engine.generate(
        [reqs[1], GenRequest(messages=[{"role": "user",
                                        "content": "abcabcabcabcabcabc"}],
                             max_tokens=24, request_id="tiny-rep")])]
    return out


def tiny_par_all(dev, mesh=None) -> dict:
    """tiny_par_trace over the int8, int4 and bf16 points, each without
    and with speculation (gamma 3), on the card."""
    tok, cfg, _, params = tiny_setup(dev)
    out = {}
    for kind, kw in PAR_TINY_KINDS.items():
        for gamma in (0, 3):
            engine = Engine(params, cfg, tok,
                            EngineConfig(**PAR_TINY, **kw,
                                         speculative_ngram=gamma),
                            device=dev, mesh=mesh)
            out[f"{kind}/{gamma}"] = tiny_par_trace(engine)
            del engine
    return out


def par_rank_stats(engine) -> dict:
    from karanta_tpu_torch.inference.server import rank_stats

    return rank_stats(engine)


def par_generate(engine, pages: list, tokens: int) -> dict:
    """generate over the pages on every rank (after a one-page warm-up):
    the completions, this rank's launches and collective host time, and the
    wall time."""
    from karanta_tpu_torch.parallel import sharding

    engine.generate(page_requests(pages[:1], 2, "warm"))
    _sync(engine.device)
    kernels.reset_launches()
    sharding.reset_stats()
    t0 = time.perf_counter()
    results = engine.generate(page_requests(pages, tokens, "par"))
    _sync(engine.device)
    wall = time.perf_counter() - t0
    return {"tokens": [r.token_ids for r in results], "wall_s": wall,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
            "collective_s": sharding.STATS["seconds"],
            "collective_calls": sharding.STATS["calls"]}


def par_timing(engine, pages: list) -> dict:
    """Prefill+insert ms a page (the pages into the slots one by one) and
    decode ms a step (PAR_DECODE_CHUNKS chunks of CHUNK steps), with the
    share of this rank's host time inside collectives over both."""
    from karanta_tpu_torch.parallel import sharding

    reqs = page_requests(pages, PAR_TOKENS, "timed")
    prepared = []
    for r in reqs:
        prepared.append(engine.prepare(r))
        engine.agree(prepared[-1])
    _sync(engine.device)
    sharding.reset_stats()
    t0 = time.perf_counter()
    for slot, p in enumerate(prepared):
        engine.prefill_insert(slot, p)
    _sync(engine.device)
    t1 = time.perf_counter()
    coll_prefill = sharding.STATS["seconds"]
    for _ in range(PAR_DECODE_CHUNKS):
        engine.decode_chunk(CHUNK)
    _sync(engine.device)
    t2 = time.perf_counter()
    for slot in range(len(prepared)):
        engine.free_slot(slot)
    return {"prefill_insert_ms_per_page": (t1 - t0) / len(pages) * 1e3,
            "decode_ms_per_step": (t2 - t1) / (PAR_DECODE_CHUNKS * CHUNK)
            * 1e3,
            "collective_share_prefill": coll_prefill / (t1 - t0),
            "collective_share_decode": (sharding.STATS["seconds"]
                                        - coll_prefill) / (t2 - t1),
            "collective_calls": sharding.STATS["calls"]}


def par_rank_tp2(rank: int, world: int, url: str, spec: dict,
                 enc: torch.Tensor) -> dict:
    """One rank of the model=2 mesh: the tiny points, then the 7B checks:
    the W8A8 decoder's hidden state after a page's prefill on the given
    vision tokens (the one-rank encoder's), the first-token logits with the
    bf16 tower and with the W8A8 tower, #1/#2 launches of one prefill, and
    the timing of four pages."""
    from karanta_tpu_torch.models.qwen25_vl import vision as vis
    from karanta_tpu_torch.models.qwen25_vl.model import (init_params_sharded,
                                                          serving_leaf_fn)

    mesh, backend = par_join(rank, world, url, 1, world, spec["device"])
    dev, dtype = mesh.device, spec["dtype"]
    out = {"coords": mesh.coords, "backend": backend, "device": str(dev),
           "tiny": tiny_par_all(dev, mesh)}
    cfg = par_config(spec["preset"])
    params = in_turns(mesh, lambda: init_params_sharded(
        cfg, mesh, PAR_SEED, dtype, quantize="int8"))
    engine = Engine(params, cfg, NoStopTokenizer(), par_engine_cfg(dtype),
                    mesh=mesh)
    page = page_requests(par_pages(1), 1)[0]
    prepared = engine.prepare(page)
    with vision_encoder(replace=enc.to(dev)):
        out["hidden"] = prefill_hidden(engine, prepared).view(
            torch.int16).cpu()
    prepared = engine.prepare(page)
    kernels.reset_launches()
    calls: list = []
    with vision_encoder(record=calls):
        out["logits_bf16_tower"] = engine.prefill(prepared)[0].float().cpu()
    out["enc_bf16_tower"] = calls[0][2].float().cpu()
    out["prefill_launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                               if v}
    out["timing"] = par_timing(engine, par_pages(PAR_TIMED_PAGES))
    out["stats"] = par_rank_stats(engine)
    place = serving_leaf_fn(cfg, mesh, dtype, None, "int8")
    del engine
    params["visual"] = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params["visual"] = in_turns(mesh, lambda: vis.init_vision_params(
        cfg.vision, torch.Generator(device=dev).manual_seed(2 * PAR_SEED),
        dtype, dev, leaf_fn=lambda path, x: place(("visual",) + path, x)))
    engine = Engine(params, cfg, NoStopTokenizer(), par_engine_cfg(dtype),
                    mesh=mesh)
    out["logits_int8_tower"] = engine.prefill(
        engine.prepare(page))[0].float().cpu()
    return out


def par_cut_config(cfg):
    """The config at PAR_2X2_LAYERS decoder layers and PAR_2X2_BLOCKS
    vision blocks, widths unchanged."""
    import dataclasses

    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_layers=PAR_2X2_LAYERS),
        vision=dataclasses.replace(cfg.vision, depth=PAR_2X2_BLOCKS))


def par_rank_dp2tp2(rank: int, world: int, url: str, spec: dict) -> dict:
    """One rank of the data=2 x model=2 mesh: the tiny points, then the 7B
    int8 point at cut depth (par_cut_config) with speculation at its CLI
    default serving four pages."""
    from karanta_tpu_torch.models.qwen25_vl.model import init_params_sharded

    mesh, backend = par_join(rank, world, url, 2, 2, spec["device"])
    dev, dtype = mesh.device, spec["dtype"]
    out = {"coords": mesh.coords, "backend": backend,
           "tiny": tiny_par_all(dev, mesh)}
    cfg = par_cut_config(par_config(spec["preset"]))
    params = in_turns(mesh, lambda: init_params_sharded(
        cfg, mesh, PAR_SEED, dtype, quantize="int8"))
    engine = Engine(params, cfg, NoStopTokenizer(),
                    par_engine_cfg(dtype, speculative_ngram=3), mesh=mesh)
    out["wave"] = par_generate(engine, par_pages(PAR_PAGES), PAR_TOKENS)
    out["stats"] = par_rank_stats(engine)
    return out


def check_tiny_par(label: str, ref: dict, ranks: list, slots: int) -> float:
    """Each rank's tiny traces against the one-rank engine's: greedy tokens
    equal, the prefill's logits and this rank's slots' logits of every
    decode step and verify pass within TINY_LOGIT_TOL x max |logit|."""
    worst = 0.0
    for r in ranks:
        bl = r["tiny"][next(iter(r["tiny"]))]["steps"].shape[1]
        lo = r["coords"]["data"] * bl
        for key, want in ref.items():
            got = r["tiny"][key]
            if got["tokens"] != want["tokens"]:
                raise AssertionError(f"[parallel {label}] rank "
                                     f"{r['coords']} {key}: greedy tokens "
                                     f"{got['tokens']} != one rank's "
                                     f"{want['tokens']}")
            pairs = [("prefill", want["prefill"], got["prefill"])]
            pairs += [(f"decode step {i + 1}", want["steps"][i, lo:lo + bl],
                       got["steps"][i]) for i in range(PAR_TINY_STEPS)]
            if "passes" in want:
                pairs += [(f"verify pass {i + 1}",
                           want["passes"][i, lo:lo + bl], got["passes"][i])
                          for i in range(PAR_TINY_STEPS)]
            for stage, w, g in pairs:
                scale = max(float(w.abs().max()), 1.0)
                err = float((w - g).abs().max())
                if not err <= TINY_LOGIT_TOL * scale:
                    raise AssertionError(
                        f"[parallel {label}] {key} {stage} logits: max abs "
                        f"err {err} > {TINY_LOGIT_TOL} x {scale}")
                worst = max(worst, err / scale)
    log(f"[parallel {label}] tiny int8/int4/bf16 caches, gamma 0 and 3: "
        f"greedy tokens equal one rank's on every rank; prefill, "
        f"{PAR_TINY_STEPS} decode-step and {PAR_TINY_STEPS} verify-pass "
        f"logits within {worst:.3e} x max|logit| (limit {TINY_LOGIT_TOL})")
    return worst


def _mb(x) -> str:
    return "n/a" if x is None else f"{x:.0f}"


def check_rank_launches(label: str, stats: list, names: tuple) -> dict:
    """Each rank launched each of `names`; returns rank -> launches."""
    per = {}
    for st in stats:
        missing = [n for n in names if not st["launches"].get(n)]
        if missing:
            raise AssertionError(f"[parallel {label}] rank {st['rank']} "
                                 f"launched no {missing}: {st['launches']}")
        per[st["rank"]] = st["launches"]
    return per


def phase_parallel(cfg, device: str = "cuda",
                   dtype=torch.bfloat16) -> dict:
    """Phase 15: the port's engine and server on a (data, model) mesh of
    ranks that share this card over gloo (NCCL refuses two ranks on one
    device). The tiny config at model=2 and 2x2 against one rank; the 7B
    checks at model=2 against one rank on the same seeded weights; the 7B
    int8 point at 2x2 through generate; the 7B server at tp=2 from its CLI
    serving four pages over HTTP."""
    from karanta_tpu_torch.models.qwen25_vl.model import init_params
    from karanta_tpu_torch.ops.quantization import (quantize_decoder_params,
                                                    quantize_vision_params)

    dev = torch.device(device)
    spec = {"preset": "tiny" if cfg.name.endswith("tiny") else cfg.name,
            "device": device, "dtype": dtype}
    t_phase = time.perf_counter()
    log("[parallel] ranks share cuda:0 and talk over gloo (host-staged "
        "collectives); with a card per rank the same code takes NCCL")
    stats: dict = {}
    # one-rank references: the tiny points, then the 7B prefill
    ref_tiny = tiny_par_all(dev)
    params = init_params(cfg, PAR_SEED, dtype, device=dev)
    params["text"] = quantize_decoder_params(params["text"])
    engine = Engine(params, cfg, NoStopTokenizer(), par_engine_cfg(dtype),
                    device=dev)
    page = page_requests(par_pages(1), 1)[0]
    calls: list = []
    with vision_encoder(record=calls):
        ref_logits_bf16 = engine.prefill(engine.prepare(page))[0].float()
    enc = calls[0][2]
    prepared = engine.prepare(page)
    with vision_encoder(replace=enc):
        ref_hidden = prefill_hidden(engine, prepared)
    del engine
    params["visual"] = quantize_vision_params(params["visual"])
    engine = Engine(params, cfg, NoStopTokenizer(), par_engine_cfg(dtype),
                    device=dev)
    ref_logits_int8 = engine.prefill(engine.prepare(page))[0].float()
    del engine, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[parallel] one-rank references in "
        f"{time.perf_counter() - t_phase:.1f}s")

    # model=2: two spawned ranks
    t0 = time.perf_counter()
    ranks = run_ranks(par_rank_tp2, 2, (spec, enc.cpu()),
                      timeout_s=PAR_TIMEOUT)
    log(f"[parallel tp=2] two ranks in {time.perf_counter() - t0:.1f}s, "
        f"backend {ranks[0]['backend']}, devices "
        f"{[r['device'] for r in ranks]}")
    stats["tiny_tp2_worst"] = check_tiny_par("tp=2", ref_tiny, ranks,
                                             PAR_SLOTS)
    want_hidden = ref_hidden.view(torch.int16).cpu()
    for r in ranks:
        if not torch.equal(r["hidden"], want_hidden):
            n = int((r["hidden"] != want_hidden).sum())
            raise AssertionError(f"[parallel tp=2] rank {r['coords']}: the "
                                 f"W8A8 decoder's hidden state differs from "
                                 f"one rank's in {n} entries")
        if not torch.equal(r["logits_int8_tower"], ref_logits_int8.cpu()):
            raise AssertionError(f"[parallel tp=2] rank {r['coords']}: W8A8 "
                                 f"tower first-token logits differ from one "
                                 f"rank's (max abs "
                                 f"{max_err(r['logits_int8_tower'], ref_logits_int8.cpu())})")
        nw = normwise(r["logits_bf16_tower"], ref_logits_bf16.cpu())
        stats.setdefault("bf16_tower_tokens_normwise", []).append(
            normwise(r["enc_bf16_tower"], enc.float().cpu()))
        log(f"[parallel tp=2] rank {r['coords']['model']}: bf16 tower's "
            f"vision tokens {stats['bf16_tower_tokens_normwise'][-1]:.3e} "
            f"normwise from one rank's, first-token logits {nw:.3e}")
        if not nw <= PREFILL_NORM_TOL:
            raise AssertionError(f"[parallel tp=2] bf16 tower logits "
                                 f"{nw} normwise from one rank's > "
                                 f"{PREFILL_NORM_TOL}")
        stats.setdefault("bf16_tower_normwise", []).append(nw)
    log(f"[parallel tp=2] 7B: W8A8 decoder hidden state after prefill "
        f"bit-equal to one rank's on equal vision tokens; W8A8 tower "
        f"first-token logits bit-equal; bf16 tower logits "
        f"{stats['bf16_tower_normwise']} normwise (limit "
        f"{PREFILL_NORM_TOL})")
    stats["tp2_prefill_launches"] = check_rank_launches(
        "tp=2 prefill", [{"rank": i, "launches": r["prefill_launches"]}
                         for i, r in enumerate(ranks)],
        ("window_attention", "flash_attention"))
    stats["tp2_timing"] = [r["timing"] for r in ranks]
    stats["tp2_ranks"] = [r["stats"] for r in ranks]
    for r in ranks:
        tm = r["timing"]
        log(f"[parallel tp=2] rank {r['coords']['model']} (two ranks sharing "
            f"one card over gloo; not a tensor-parallel speed-up): "
            f"prefill+insert {tm['prefill_insert_ms_per_page']:.1f} ms a "
            f"page, decode {tm['decode_ms_per_step']:.2f} ms a step (B=4), "
            f"collectives {100 * tm['collective_share_prefill']:.1f}% of "
            f"prefill host time, {100 * tm['collective_share_decode']:.1f}% "
            f"of decode; kv heads {r['stats']['kv_heads']}, peak RSS "
            f"{_mb(r['stats']['peak_rss_mb'])} MB, card peak "
            f"{_mb(r['stats']['card_peak_mb'])} MB (the load, rank by "
            f"rank), held {_mb(r['stats']['card_held_mb'])} MB")
    del ranks
    gc.collect()

    # data=2 x model=2: four spawned ranks
    t0 = time.perf_counter()
    ranks = run_ranks(par_rank_dp2tp2, 4, (spec,), timeout_s=PAR_TIMEOUT)
    log(f"[parallel 2x2] four ranks in {time.perf_counter() - t0:.1f}s")
    stats["tiny_2x2_worst"] = check_tiny_par("2x2", ref_tiny, ranks,
                                             PAR_SLOTS)
    waves = [r["wave"] for r in ranks]
    vocab = cfg.text.vocab_size
    for w in waves:
        if w["tokens"] != waves[0]["tokens"] or not all(
                len(t) == PAR_TOKENS and all(0 <= x < vocab for x in t)
                for t in w["tokens"]):
            raise AssertionError("[parallel 2x2] ranks returned different "
                                 "or malformed completions")
    stats["dp2tp2_launches"] = check_rank_launches(
        "2x2 7B", [{"rank": i, "launches": w["launches"]}
                   for i, w in enumerate(waves)],
        ("window_attention", "flash_attention",
         "paged_decode_append_multi_quant"))
    stats["dp2tp2"] = [{k: v for k, v in w.items() if k != "tokens"}
                       for w in waves]
    stats["dp2tp2_ranks"] = [r["stats"] for r in ranks]
    log(f"[parallel 2x2] 7B width at cut depth ({PAR_2X2_LAYERS} of "
        f"{cfg.text.num_layers} decoder layers, {PAR_2X2_BLOCKS} of "
        f"{cfg.vision.depth} vision blocks), int8 point, gamma 3: "
        f"{PAR_PAGES} pages x {PAR_TOKENS} tokens on every rank in "
        f"{[round(w['wall_s'], 3) for w in waves]} s; launches per rank "
        f"{stats['dp2tp2_launches']}; card MB per rank, peak "
        f"{[_mb(r['stats']['card_peak_mb']) for r in ranks]}, held "
        f"{[_mb(r['stats']['card_held_mb']) for r in ranks]}; peak RSS MB "
        f"{[_mb(r['stats']['peak_rss_mb']) for r in ranks]}")
    del ranks
    gc.collect()

    # the server CLI at tp=2, this process rank 0
    engine = served_engine(
        ["--preset", spec["preset"], "--quantize", "int8", "--kv-quantize",
         "int8", "--act-quant", "int8", "--max-batch-size", str(PAR_SLOTS),
         "--decode-chunk", str(CHUNK), "--tensor-parallel-size", "2",
         *(["--device", "cpu"] if device == "cpu" else [])])
    pages = par_pages(PAR_PAGES)
    # a speculative wave (#4, one page as an SSE stream), then a wave that
    # opts out of speculation (#3)
    waves = [[page_body(pages[0], max_tokens=PAR_TOKENS),
              page_body(pages[1], stream=True, max_tokens=PAR_TOKENS)],
             [page_body(png, max_tokens=PAR_TOKENS, speculative=False)
              for png in pages[2:]]]
    with serving(engine) as (server, port):
        if http_call(port, "GET", "/health")[0] != 200:
            raise AssertionError("/health did not answer 200")
        engine.rank_stats(reset=True)
        t0 = time.perf_counter()
        for bodies in waves:
            post_pages(port, bodies, PAR_TOKENS)
        wall = time.perf_counter() - t0
        served = engine.rank_stats()
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    if any(p.is_alive() for p in engine._workers):
        raise AssertionError("[parallel served] a worker rank outlived the "
                             "server")
    stats["served_launches"] = check_rank_launches(
        "served tp=2", served, ("window_attention", "flash_attention",
                                "paged_decode_append_quant",
                                "paged_decode_append_multi_quant"))
    stats["served"] = dict(pages_per_s=PAR_PAGES / wall, wall_s=wall,
                           spec_tokens_per_pass=metrics.get(
                               "spec_tokens_per_pass"),
                           ranks=served)
    log(f"[parallel served tp=2] {PAR_PAGES} pages x {PAR_TOKENS} tokens "
        f"over HTTP (one SSE) in {wall:.3f}s, all 200; launches per rank "
        f"{stats['served_launches']}; per rank kv heads "
        f"{[st['kv_heads'] for st in served]}, collective host s "
        f"{[round(st['collective_s'], 3) for st in served]}, peak RSS MB "
        f"{[_mb(st['peak_rss_mb']) for st in served]}, card MB peak while "
        f"serving {[_mb(st['card_peak_mb']) for st in served]}, held "
        f"{[_mb(st['card_held_mb']) for st in served]}")
    del server, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[parallel] phase 15 in {stats['seconds']:.1f}s")
    return stats


# ---------------------------------------------------------------------------
# phase 16: parallel training
# ---------------------------------------------------------------------------

PT_SEED = 16
PT_TIMEOUT = 600.0      # seconds a rank waits for its peers
PT_LR = 1e-3
PT_TINY_DOCS = 4        # the tiny global batch: four rows
PT_LOSS_TOL = 1e-5      # tiny float32: loss vs one rank, relative
PT_TINY_TOL = 2e-4      # tiny float32: gradients and parameters, rtol/atol
PT_CLI_TOL = 1e-5       # the 2-process CLI loss vs one process, relative
PT_3B_LOSS_TOL = 1e-2   # the cut 3B step, bf16: loss vs one rank, relative
PT_3B_NORM_TOL = 2e-2   # and the global gradient norm
PT_3B_LAYERS, PT_3B_BLOCKS = 6, 8   # of 36 decoder layers, 32 blocks
PT_3B_ROWS = 2
# (label, mesh, config, cases): each tiny case against one rank on the card
PT_TINY_CASES = (
    ("data=2", {"data": 2}, "tiny", (dict(optimizer="adamw", grad_accum=2),)),
    ("fsdp=2", {"fsdp": 2}, "tiny", (dict(optimizer="adamw", grad_accum=1),
                                     dict(optimizer="muon", grad_accum=1))),
    ("model=2", {"model": 2}, "tiny", (dict(optimizer="adamw",
                                            grad_accum=1),)),
    ("seq=2", {"seq": 2}, "tiny", (dict(optimizer="adamw", grad_accum=1,
                                        sp=True),)),
    ("pipe=2", {"pipe": 2}, "tiny4", (dict(optimizer="adamw", grad_accum=1,
                                           pp_micro=2),)),
)
PT_3B_MESHES = (("data=2", {"data": 2}, {}), ("fsdp=2", {"fsdp": 2}, {}),
                ("seq=2", {"seq": 2}, {"sp": True}),
                ("model=2", {"model": 2}, {}))


def pt_config(name: str):
    """The tiny config, its 4-layer variant, or the 3B preset cut to
    PT_3B_LAYERS decoder layers and PT_3B_BLOCKS vision blocks."""
    import dataclasses

    if name == "3b":
        cfg = get_config(TRAIN_PRESET)
        return dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, num_layers=PT_3B_LAYERS),
            vision=dataclasses.replace(cfg.vision, depth=PT_3B_BLOCKS))
    cfg = tiny_config(vocab_size=ByteTokenizer().vocab_size)
    if name == "tiny4":
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_layers=4))
    return cfg


def pt_tiny_corpus(root: str) -> str:
    """PT_TINY_DOCS digit pages whose transcripts differ in length (the
    rows' token counts differ)."""
    from karanta_tpu_torch.data.synthetic import make_corpus

    rng = np.random.default_rng(PT_SEED)
    texts = ["".join(rng.choice(list("0123456789"), size=n))
             for n in (3, 7, 5, 9)[:PT_TINY_DOCS]]
    make_corpus(root, PT_TINY_DOCS, seed=PT_SEED, texts=texts)
    return root


PT_TINY_PIPELINE = [
    {"name": "PDF2ImageStep", "target_longest_image_dim": 128},
    {"name": "FetchPageData"},
    {"name": "StaticLengthDocumentAnchoring", "target_anchor_text_len": 1000},
    {"name": "FinetuningPrompt"}, {"name": "PlainTextFormat"},
    {"name": "InstructUserMessages", "prompt_first": True},
    {"name": "Tokenizer"}]


def pt_batch(cfg, root: str, pipeline: list, tokenizer, rows: int,
             max_length: int) -> dict:
    """The first `rows` samples of a corpus collated as the trainer does
    (run-wide buckets), as host tensors."""
    from karanta_tpu_torch.training.data import DataCollator, LocalDataset
    from karanta_tpu_torch.training.train import to_device_batch

    samples = LocalDataset(root, pipeline_steps=pipeline,
                           tokenizer=tokenizer, vision_cfg=cfg.vision,
                           max_length=max_length).build(num_workers=1)
    grid, seq = DataCollator.fit_buckets(samples)
    batch = DataCollator(cfg.vision, fixed_seq=seq, fixed_grid=grid)(
        samples[:rows])
    return to_device_batch(batch, "cpu")


def pt_data(root: str) -> dict:
    """Phases 16 and 17's training data under `root`: the tiny corpus
    (its directory and its PT_TINY_DOCS-row batch) and PT_3B_ROWS rows of
    phase 12's synthetic pages for the cut 3B, tokenized by a BPE tokenizer
    trained here (host tensors)."""
    import yaml

    from karanta_tpu_torch.inference.tokenizer import HFTokenizer

    tiny_root = pt_tiny_corpus(os.path.join(root, "tiny"))
    tiny_batch = pt_batch(pt_config("tiny"), tiny_root, PT_TINY_PIPELINE,
                          ByteTokenizer(), PT_TINY_DOCS, 2048)
    data3b = train_corpus(os.path.join(root, "3b"))
    os.makedirs(os.path.join(root, "tok"))
    tok_dir = bpe_tokenizer_dir(os.path.join(root, "tok"))
    with open(TRAIN_YAML) as f:
        train_yaml = yaml.safe_load(f)
    batch3b = pt_batch(pt_config("3b"), data3b, train_yaml["pipeline"],
                       HFTokenizer(tok_dir), PT_3B_ROWS,
                       train_yaml["max_length"])
    return {"root": root, "tiny_root": tiny_root, "tiny_batch": tiny_batch,
            "3b_batch": batch3b}


def pt_step(mesh, cfg, make_params, batch: dict, case: dict,
            remat: bool = False) -> dict:
    """One make_train_step step on `mesh` from whole parameters
    (make_params(), sharded here), the global batch on the host: loss,
    tokens, global grad norm, the step's ms, host seconds and calls in
    collectives, peak card MB (the parameters, the optimizer state and the
    step's own; what the process held before is not counted) and #1/#2
    launches; with case["whole"] also
    the whole gradients of the first microbatch and the whole parameters
    after the step (float32, host)."""
    from karanta_tpu_torch.parallel import sharding
    from karanta_tpu_torch.training.optimizer import make_optimizer
    from karanta_tpu_torch.training.train_step import (create_train_state,
                                                       make_train_step,
                                                       value_and_grad)
    from karanta_tpu_torch.utils.tree import flatten_tree

    base = torch.cuda.memory_allocated()
    opt = make_optimizer(case["optimizer"], case.get("lr", PT_LR))
    pp = case.get("pp_micro", 0)
    step = make_train_step(
        cfg, opt, remat=remat, grad_accum=case["grad_accum"],
        sp_mesh=mesh if case.get("sp") else None,
        pp_mesh=mesh if pp else None, pp_micro=max(pp, 1), mesh=mesh)
    place = step.plan.placement
    params = place.shard(make_params())
    out: dict = {}
    if case.get("whole"):
        accum = case["grad_accum"]
        first = {k: (v[:, :v.shape[1] // accum] if k == "positions"
                     else v[:v.shape[0] // accum]) for k, v in batch.items()}
        _, _, grads = value_and_grad(step.loss_fn, params, first)
        step.plan.reduce_grads(grads)
        out["grads"] = {k: place.whole(k, g).float().cpu()
                        for k, g in grads.items()}
        del grads
    state = create_train_state(params, opt)
    del params
    _sync(mesh.device)
    torch.cuda.reset_peak_memory_stats()
    sharding.reset_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    _sync(mesh.device)
    sec = time.perf_counter() - t0
    out.update(loss=float(metrics["loss"]), tokens=int(metrics["tokens"]),
               grad_norm=float(metrics["grad_norm"]), ms=sec * 1e3,
               collective_s=sharding.STATS["seconds"],
               collective_share=sharding.STATS["seconds"] / sec,
               collective_calls=sharding.STATS["calls"],
               peak_mb=(torch.cuda.max_memory_allocated() - base) / 2**20,
               launches={k: kernels.LAUNCHES[k] for k in
                         ("window_attention", "flash_attention")})
    if case.get("whole"):
        out["params"] = {k: place.whole(k, x).float().cpu()
                         for k, x in flatten_tree(state.params).items()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pt_tiny_params(name: str) -> dict:
    """The tiny config's seeded float32 parameters, on the host."""
    return init_params(pt_config(name), PT_SEED, torch.float32, device="cpu")


def pt_3b_params(dev):
    return init_params(pt_config("3b"), PT_SEED, torch.bfloat16, device=dev)


def pt_rank(rank: int, world: int, url: str, spec: dict) -> dict:
    """One rank of phase 16: every tiny case on its mesh, then one step of
    the cut 3B at each of PT_3B_MESHES, each mesh built in turn over the
    same group (ranks on one card over gloo)."""
    from karanta_tpu_torch.device import float32_reductions, no_tf32
    from karanta_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                 initialize_distributed)

    no_tf32()
    float32_reductions()
    device = spec["device"]
    backend = initialize_distributed(url, world, rank, device=device,
                                     timeout_s=PT_TIMEOUT)
    out = {"backend": backend, "tiny": {}, "3b": {}}

    def mesh_of(dims):
        return create_mesh(MeshConfig(**{"data": 1, **dims}),
                           device="cpu" if device == "cpu" else None)

    for label, dims, name, cases in PT_TINY_CASES:
        mesh = mesh_of(dims)
        cfg = pt_config(name)
        out["tiny"][label] = [pt_step(
            mesh, cfg, lambda: tree_map(
                lambda x, _: x.to(mesh.device, copy=True),
                spec["tiny_params"][name]),
            spec["tiny_batch"], dict(c, whole=True)) for c in cases]
    cfg = pt_config("3b")
    for label, dims, extra in PT_3B_MESHES:
        mesh = mesh_of(dims)
        out["3b"][label] = pt_step(
            mesh, cfg, lambda: pt_3b_params(mesh.device), spec["3b_batch"],
            dict(optimizer="adamw", grad_accum=1, lr=1e-5, **extra),
            remat=True)
        out["3b"][label]["coords"] = mesh.coords
    return out


def pt_check_tiny(label: str, case: dict, ref: dict, got: list) -> float:
    """Each rank's tiny step against one rank's: loss within PT_LOSS_TOL
    relative, every gradient leaf and every parameter after the step
    within PT_TINY_TOL (rtol and atol). The key biases' exact gradient is
    zero (a shift of every key leaves the softmax unchanged): their Adam
    updates are rounding noise times the learning rate, held within 3
    learning rates. Returns the worst parameter difference."""
    worst = 0.0
    for r, g in enumerate(got):
        err = abs(g["loss"] - ref["loss"]) / abs(ref["loss"])
        if not err <= PT_LOSS_TOL:
            raise AssertionError(f"[train parallel {label}] rank {r}: loss "
                                 f"{g['loss']} vs one rank {ref['loss']}")
        for kind in ("grads", "params"):
            for path, w in ref[kind].items():
                d = (g[kind][path] - w).abs()
                if kind == "params" and path.endswith("attn/bk"):
                    ok = float(d.max()) <= 3 * PT_LR
                else:
                    ok = bool((d <= PT_TINY_TOL + PT_TINY_TOL
                               * w.abs()).all())
                if not ok:
                    raise AssertionError(
                        f"[train parallel {label}] rank {r} {kind} {path}: "
                        f"max abs err {float(d.max())}")
                if kind == "params":
                    worst = max(worst, float(d.max()))
    log(f"[train parallel {label} {case['optimizer']}] ranks' loss "
        f"{[g['loss'] for g in got]} vs one rank {ref['loss']}; every "
        f"gradient and parameter within {PT_TINY_TOL:g} (worst parameter "
        f"{worst:.2e}); launches a step per rank "
        f"{[g['launches'] for g in got]}")
    return worst


def pt_expected_launches(cfg, rows: int) -> dict:
    """#1/#2 launches of one remat step over `rows` rows on a rank: each
    vision block once a row (the tower encodes row by row) and each decoder
    layer once over the rows, in the forward and again in the
    recompute."""
    n_full = sum(i < cfg.vision.depth
                 for i in cfg.vision.fullatt_block_indexes)
    return {"window_attention": 2 * (cfg.vision.depth - n_full) * rows,
            "flash_attention": 2 * (n_full * rows + cfg.text.num_layers)}


PT_3B_LOCAL_ROWS = {"data=2": 1, "fsdp=2": 1, "seq=2": 2, "model=2": 2}


def train_cli_launch(base: list, out_dir: str, world: int,
                     extra: list) -> list:
    """Start the trainer's entry point as `world` processes (one joins no
    group), argv `base` + the output dir + `extra`; returns the processes."""
    from karanta_tpu_torch.parallel.launch import free_port

    url = f"tcp://127.0.0.1:{free_port()}"
    procs = []
    for pid in range(world):
        argv = base + ["--output_dir", out_dir] + extra
        if world > 1:
            argv += ["--num_processes", str(world), "--process_id",
                     str(pid), "--coordinator_address", url]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "karanta_tpu_torch.training.train",
             *argv], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def train_cli_finish(procs: list, label: str) -> list:
    """Wait for the trainer processes; each one's last logged metrics.
    Raises on a nonzero exit or a hang."""
    import ast

    metrics = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=PT_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"[train cli {label}] timed out")
        if p.returncode:
            raise AssertionError(f"[train cli {label}] exit "
                                 f"{p.returncode}:\n{text[-3000:]}")
        logged = [ast.literal_eval(line[line.index("{'step'"):])
                  for line in text.splitlines() if "{'step'" in line]
        metrics.append(logged[-1])
    return metrics


def train_cli_base(root: str, work: str, device: str) -> list:
    """The CLI runs' common argv: the tiny config, float32, the tiny
    pipeline over `root`, no checkpoints between steps, no eval."""
    yaml_path = os.path.join(work, "tiny.yaml")
    with open(yaml_path, "w") as f:
        json.dump({"pipeline": PT_TINY_PIPELINE, "max_length": 2048}, f)
    return [yaml_path, "--dataset_root", root, "--model_name_or_path",
            "tiny", "--dtype", "float32", "--gradient_accumulation_steps",
            "1", "--logging_steps", "1", "--checkpointing_steps", "0",
            "--eval_steps", "0", "--learning_rate", str(PT_LR),
            "--warmup_steps", "0", "--seed", str(PT_SEED),
            *(["--device", "cpu"] if device == "cpu" else [])]


def pt_cli(root: str, device: str = "cuda") -> dict:
    """The trainer's entry point as two processes at data = 2 (ranks on
    the card over gloo), and one process at data = 1 on the same global
    batch, side by side; then the two-process checkpoint resumed at
    fsdp = 2 for a fourth step. Tiny config, float32, 3 steps."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="pt_cli_")
    base = train_cli_base(root, work, device)
    t0 = time.perf_counter()
    run2, run1 = os.path.join(work, "two"), os.path.join(work, "one")
    two = train_cli_launch(base, run2, 2, [
        "--max_steps", "3", "--mesh_data", "2",
        "--per_device_train_batch_size", "1"])
    one = train_cli_launch(base, run1, 1, [
        "--max_steps", "3", "--mesh_data", "1",
        "--per_device_train_batch_size", "2"])
    m2 = train_cli_finish(two, "data=2")
    m1 = train_cli_finish(one, "one process")
    if not (m2[0]["step"] == m2[1]["step"] == 3 and
            m2[0]["loss"] == m2[1]["loss"]):
        raise AssertionError(f"[train cli] the ranks logged {m2}")
    err = abs(m2[0]["loss"] - m1[0]["loss"]) / abs(m1[0]["loss"])
    if not err <= PT_CLI_TOL:
        raise AssertionError(f"[train cli] 2-process loss {m2[0]['loss']} "
                             f"vs one process {m1[0]['loss']}")
    done = glob.glob(os.path.join(run2, "step_*", "COMPLETED"))
    if [os.path.basename(os.path.dirname(p)) for p in done] != ["step_3"]:
        raise AssertionError(f"[train cli] checkpoints {done}")
    m3 = train_cli_finish(train_cli_launch(base, run2, 2, [
        "--max_steps", "4", "--mesh_data", "1", "--mesh_fsdp", "2",
        "--per_device_train_batch_size", "2", "--resume_from_checkpoint",
        "auto"]), "resume at fsdp=2")
    if not (m3[0]["step"] == m3[1]["step"] == 4
            and m3[0]["loss"] == m3[1]["loss"]):
        raise AssertionError(f"[train cli] the resumed ranks logged {m3}")
    wall = time.perf_counter() - t0
    log(f"[train cli] 2 processes at data=2 on the card: step-3 loss "
        f"{m2[0]['loss']:.6f} on both ranks, one process {m1[0]['loss']:.6f}"
        f" ({err:.1e} relative, limit {PT_CLI_TOL:g}); one COMPLETED "
        f"checkpoint (step_3); resumed at fsdp=2 to step 4 (loss "
        f"{m3[0]['loss']:.6f} on both ranks); {wall:.1f}s")
    shutil.rmtree(work, ignore_errors=True)
    return dict(loss_2proc=m2[0]["loss"], loss_1proc=m1[0]["loss"],
                rel_err=err, resumed_loss=m3[0]["loss"], wall_s=wall)


def kernel_flash_sp(cfg, dev, gen) -> dict:
    """#2 at a sequence-parallel rank's shapes of the 3B decoder: 1,536
    queries at q_offset 0 and 1,536 over 3,072 gathered keys with SP_LIVE
    live, causal, 16 heads over 2 kv heads and (model = 2 as well) 8 over
    1: the forward against the plain version at the bf16 limit, two calls
    bit-equal, dq/dk/dv of the autograd function within GRAD_TOL of float32
    autograd, and kernel, device (CUDA graph), plain and SDPA ms beside the
    bound."""
    t = pt_config("3b").text
    out = {"bf16_resources": A.flash_attention_info(t.head_dim)}
    log(f"  flash bf16 D={t.head_dim}: {out['bf16_resources']}")
    for heads, kvh in ((t.num_heads, t.num_kv_heads),
                       (t.num_heads // 2, t.num_kv_heads // 2)):
        for q_off in (0, SP_Q):
            label = (f"sp (1,{SP_Q},{heads}/{kvh},{t.head_dim}) "
                     f"q_offset={q_off}")
            q, k, v, mask = _flash_case(dev, gen, 1, SP_Q, SP_K, heads, kvh,
                                        t.head_dim, torch.bfloat16, SP_LIVE)
            with torch.no_grad():
                if not torch.equal(
                        A.flash_attention(q, k, v, mask, causal=True,
                                          q_offset=q_off),
                        A.flash_attention(q, k, v, mask, causal=True,
                                          q_offset=q_off)):
                    raise AssertionError(f"{label}: two calls differ")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa_mask = _sdpa_mask(SP_Q, SP_K, SP_LIVE, True, dev, q_off)
            row = _per_rank_row(
                label, lambda: A.flash_attention(q, k, v, mask, causal=True,
                                                 q_offset=q_off),
                lambda: A.flash_attention_plain(q, k, v, mask, causal=True,
                                                q_offset=q_off),
                flash_work(SP_Q, SP_K, heads, kvh, t.head_dim, [SP_LIVE],
                           True, q_off),
                lib=lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True),
                graph=True)
            dout = torch.randn_like(q.float()).bfloat16()
            row["autograd"] = autograd_check(
                label, lambda q, k, v: A.attention(q, k, v, kv_mask=mask,
                                                   causal=True,
                                                   q_offset=q_off),
                lambda q, k, v: A.mha_reference(q, k, v, kv_mask=mask,
                                                causal=True, q_offset=q_off),
                (q, k, v), dout)
            out[f"h{heads}_kv{kvh}_q{q_off}"] = row
    return out


def phase_parallel_training(device: str = "cuda") -> dict:
    """Phase 16: (a) the trainer's CLI as two processes at data = 2, one
    process on the same global batch and a resume at fsdp = 2 (pt_cli);
    (b) the tiny float32 step at data = 2 (grad-accum 2 over rows of
    unequal token counts), fsdp = 2 (AdamW, Muon), model = 2, seq = 2 and
    pipe = 2 (4 layers, 2 microbatches) against one rank on the card;
    (c) the 3B preset at full width cut to PT_3B_LAYERS decoder layers and
    PT_3B_BLOCKS vision blocks, bf16 with remat, phase 12's synthetic
    pages, one step at data = 2, fsdp = 2, seq = 2 and model = 2 against
    its one-rank step. (b) and (c) share one spawn of two ranks on the
    card over gloo."""
    import tempfile

    from karanta_tpu_torch.device import float32_reductions, no_tf32
    from karanta_tpu_torch.parallel.mesh import create_mesh

    dev = torch.device(device)
    # the trainer's precision switches, here as in the ranks (pt_rank)
    no_tf32()
    float32_reductions()
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    stats: dict = {"card": smi}
    root = tempfile.mkdtemp(prefix="pt_")
    data = pt_data(root)
    tiny_root, tiny_batch, batch3b = (data[k] for k in (
        "tiny_root", "tiny_batch", "3b_batch"))
    stats["cli"] = pt_cli(tiny_root, device)

    # one rank's references, on the card
    counts = (tiny_batch["labels"] != -100).sum(1).tolist()
    if len(set(counts[:2])) < 2 and len(set(counts[2:])) < 2:
        raise AssertionError(f"tiny rows of equal token counts {counts}")
    cfg3b = pt_config("3b")
    one = create_mesh(device=device)
    tiny_params = {name: pt_tiny_params(name) for name in ("tiny", "tiny4")}
    ref_tiny = {label: [pt_step(one, pt_config(name), lambda n=name: tree_map(
        lambda x, _: x.to(dev, copy=True), tiny_params[n]), tiny_batch,
        dict(c, whole=True)) for c in cases]
        for label, _, name, cases in PT_TINY_CASES}
    ref_3b = pt_step(one, cfg3b, lambda: pt_3b_params(dev), batch3b,
                     dict(optimizer="adamw", grad_accum=1, lr=1e-5),
                     remat=True)
    stats["3b_one_rank"] = ref_3b
    log(f"[train parallel 3B] {TRAIN_PRESET} at full width, "
        f"{PT_3B_LAYERS} of 36 decoder layers and {PT_3B_BLOCKS} of 32 "
        f"vision blocks, {PT_3B_ROWS} rows x "
        f"{tuple(batch3b['token_ids'].shape)[1]} tokens, bf16, remat; one "
        f"rank: loss {ref_3b['loss']:.5f}, grad norm "
        f"{ref_3b['grad_norm']:.5f}, {ref_3b['ms']:.1f} ms, peak "
        f"{ref_3b['peak_mb']:.0f} MB; card: {smi}")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(pt_rank, 2, ({
        "tiny_params": {k: tree_map(lambda x, _: x.cpu(), v)
                        for k, v in tiny_params.items()},
        "tiny_batch": tiny_batch, "3b_batch": batch3b, "device": device},),
        timeout_s=PT_TIMEOUT)
    log(f"[train parallel] two ranks in {time.perf_counter() - t0:.1f}s, "
        f"backend {ranks[0]['backend']}")
    stats["tiny_worst_param_err"] = 0.0
    for label, _, _, cases in PT_TINY_CASES:
        for i, c in enumerate(cases):
            stats["tiny_worst_param_err"] = max(
                stats["tiny_worst_param_err"], pt_check_tiny(
                    label, c, ref_tiny[label][i],
                    [r["tiny"][label][i] for r in ranks]))
    stats["3b"] = {}
    for label, _, _ in PT_3B_MESHES:
        got = [r["3b"][label] for r in ranks]
        if got[0]["loss"] != got[1]["loss"]:
            raise AssertionError(f"[train parallel 3B {label}] the ranks' "
                                 f"losses differ: {got[0]['loss']} vs "
                                 f"{got[1]['loss']}")
        lerr = abs(got[0]["loss"] - ref_3b["loss"]) / abs(ref_3b["loss"])
        nerr = abs(got[0]["grad_norm"] - ref_3b["grad_norm"]) / \
            ref_3b["grad_norm"]
        if not (lerr <= PT_3B_LOSS_TOL and nerr <= PT_3B_NORM_TOL):
            raise AssertionError(
                f"[train parallel 3B {label}] loss {got[0]['loss']} "
                f"({lerr:.2e} relative, limit {PT_3B_LOSS_TOL}), grad norm "
                f"{got[0]['grad_norm']} ({nerr:.2e}, limit {PT_3B_NORM_TOL})"
                f" against one rank's")
        want = pt_expected_launches(cfg3b, PT_3B_LOCAL_ROWS[label])
        for r, g in enumerate(got):
            if g["launches"] != want:
                raise AssertionError(f"[train parallel 3B {label}] rank {r} "
                                     f"launched {g['launches']}, expected "
                                     f"{want}")
        stats["3b"][label] = dict(loss_rel_err=lerr, grad_norm_rel_err=nerr,
                                  ranks=got)
        log(f"[train parallel 3B {label}] loss {got[0]['loss']:.5f} on both "
            f"ranks ({lerr:.2e} from one rank), grad norm "
            f"{got[0]['grad_norm']:.5f} ({nerr:.2e}); per rank: "
            + "; ".join(
                f"{g['ms']:.1f} ms a step, collectives {g['collective_s']:.2f}"
                f" s = {100 * g['collective_share']:.1f}% in "
                f"{g['collective_calls']} calls, peak {g['peak_mb']:.0f} MB"
                for g in got) + f"; launches a step per rank {want}")
    stats["data"] = data  # phase 17 trains on the same rows
    stats["launches"] = {label: [r["3b"][label]["launches"] for r in ranks]
                         for label, _, _ in PT_3B_MESHES}
    stats["seconds"] = time.perf_counter() - t_phase
    log(f"[train parallel] phase 16 in {stats['seconds']:.1f}s")
    return stats


# ---------------------------------------------------------------------------
# phase 17: LoRA and QLoRA over fsdp and model, the bulk fan-out and the
# teacher tools against the 7B server, the closed loop
# ---------------------------------------------------------------------------

PL_RANK, PL_TINY_RANK = 16, 4   # adapter ranks: the trainer's default; tiny
PL_MESHES = (("fsdp=2", {"fsdp": 2}), ("model=2", {"model": 2}))
PL_KINDS = ("lora", "qlora")
# b starts at this (not the trainer's 0) so that every factor has a gradient
PL_B_INIT = {"tiny": 1e-2, "3b": 1e-3}
BULK_TOKENS = SERVED_TOKENS     # tokens a page: random weights never stop
CL_ARGV = ["--train-pages", "8", "--chars", "1", "--eval-pages", "8",
           "--eval-from-train", "--steps", "500", "--lr", "0.001"]
CL_MAX_CER, CL_MIN_EXACT, CL_PAGES = 0.15, 6, 8
CL_TIMEOUT = 600


def pl_step(mesh, cfg, make_params, batch: dict, qlora: bool, rank: int,
            b_init: float, remat: bool = False, whole: bool = False) -> dict:
    """One make_lora_train_step step (AdamW) on `mesh`: the base from
    make_params() (whole, NF4 for QLoRA, then this rank's slices:
    lora_base_placement), rank-`rank` factors whole, the global batch on
    the host. Returns loss, tokens, grad norm, ms, collectives' host
    seconds, share and calls, peak card MB (from the parameters on) and
    #1/#2 launches; with `whole`, the factors after the step (float32,
    host)."""
    from karanta_tpu_torch.parallel import sharding
    from karanta_tpu_torch.training import lora as tl
    from karanta_tpu_torch.training.optimizer import make_optimizer
    from karanta_tpu_torch.training.train_step import create_train_state
    from karanta_tpu_torch.utils.tree import flatten_tree

    mem0 = torch.cuda.memory_allocated()
    params = make_params()
    template = tl.init_lora_params(
        params, rank, torch.Generator(device=mesh.device).manual_seed(
            PT_SEED), alpha=16.0)
    for group in ("attn", "mlp"):
        for f in template[group].values():
            f["b"] += b_init
    if qlora:
        params = tl.quantize_base_nf4(params)
    base = tl.lora_base_placement(cfg, mesh, qlora).shard(params)
    del params
    opt = make_optimizer("adamw", PT_LR)
    step = tl.make_lora_train_step(cfg, opt, remat=remat, mesh=mesh)
    state = create_train_state(tl.trainable_lora(template), opt)
    gc.collect()
    _sync(mesh.device)
    torch.cuda.reset_peak_memory_stats()
    sharding.reset_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, base, template, batch)
    _sync(mesh.device)
    sec = time.perf_counter() - t0
    out = dict(loss=float(metrics["loss"]), tokens=int(metrics["tokens"]),
               grad_norm=float(metrics["grad_norm"]), ms=sec * 1e3,
               collective_s=sharding.STATS["seconds"],
               collective_share=sharding.STATS["seconds"] / sec,
               collective_calls=sharding.STATS["calls"],
               peak_mb=(torch.cuda.max_memory_allocated() - mem0) / 2**20,
               launches={k: kernels.LAUNCHES[k] for k in
                         ("window_attention", "flash_attention")})
    if whole:
        out["factors"] = {k: v.float().cpu()
                          for k, v in flatten_tree(state.params).items()}
    del state, base, template
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pl_cases(mesh, spec: dict) -> dict:
    """Every LoRA case of phase 17 on `mesh`: the tiny float32 LoRA and
    QLoRA steps (factors kept) and the cut 3B's (bf16, remat)."""
    out = {}
    for kind in PL_KINDS:
        out[("tiny", kind)] = pl_step(
            mesh, pt_config("tiny"), lambda: tree_map(
                lambda x, _: x.to(mesh.device, copy=True),
                spec["tiny_params"]), spec["tiny_batch"], kind == "qlora",
            PL_TINY_RANK, PL_B_INIT["tiny"], whole=True)
    for kind in PL_KINDS:
        out[("3b", kind)] = pl_step(
            mesh, pt_config("3b"), lambda: pt_3b_params(mesh.device),
            spec["3b_batch"], kind == "qlora", PL_RANK, PL_B_INIT["3b"],
            remat=True)
    return out


def pl_rank(rank: int, world: int, url: str, spec: dict) -> dict:
    """One rank of phase 17(a): pl_cases at each of PL_MESHES, the meshes
    built in turn over one group (ranks on one card over gloo)."""
    from karanta_tpu_torch.device import float32_reductions, no_tf32
    from karanta_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                 initialize_distributed)

    no_tf32()
    float32_reductions()
    device = spec["device"]
    backend = initialize_distributed(url, world, rank, device=device,
                                     timeout_s=PT_TIMEOUT)
    out = {"backend": backend}
    for label, dims in PL_MESHES:
        mesh = create_mesh(MeshConfig(**{"data": 1, **dims}),
                           device="cpu" if device == "cpu" else None)
        out[label] = pl_cases(mesh, spec)
    return out


def pl_expected_launches(cfg, rows: int) -> dict:
    """#1/#2 launches of one LoRA remat step over `rows` rows on a rank:
    the frozen vision tower once a row (nothing to recompute), each decoder
    layer once over the rows in the forward and again in the recompute."""
    n_full = sum(i < cfg.vision.depth
                 for i in cfg.vision.fullatt_block_indexes)
    return {"window_attention": (cfg.vision.depth - n_full) * rows,
            "flash_attention": n_full * rows + 2 * cfg.text.num_layers}


def pl_check(label: str, kind: str, ref: dict, got: list, cfg,
             rows: int) -> dict:
    """A mesh's tiny and 3B steps against one rank's (the tiny ones' loss
    within PT_LOSS_TOL and factors within PT_TINY_TOL; the 3B ones' loss
    within PT_3B_LOSS_TOL, grad norm within PT_3B_NORM_TOL, the ranks'
    losses equal, the expected #1/#2 launches); returns the 3B numbers."""
    tiny_ref, tiny = ref[("tiny", kind)], [g[("tiny", kind)] for g in got]
    worst = 0.0
    for r, g in enumerate(tiny):
        err = abs(g["loss"] - tiny_ref["loss"]) / abs(tiny_ref["loss"])
        if not err <= PT_LOSS_TOL:
            raise AssertionError(f"[lora {label} tiny {kind}] rank {r}: "
                                 f"loss {g['loss']} vs {tiny_ref['loss']}")
        for path, w in tiny_ref["factors"].items():
            d = (g["factors"][path] - w).abs()
            if not bool((d <= PT_TINY_TOL + PT_TINY_TOL * w.abs()).all()):
                raise AssertionError(f"[lora {label} tiny {kind}] rank {r} "
                                     f"{path}: max abs err {float(d.max())}")
            worst = max(worst, float(d.max()))
    log(f"[lora {label} tiny {kind}] ranks' loss "
        f"{[g['loss'] for g in tiny]} vs one rank {tiny_ref['loss']}; every "
        f"factor within {PT_TINY_TOL:g} after AdamW (worst {worst:.2e})")
    one, big = ref[("3b", kind)], [g[("3b", kind)] for g in got]
    if big[0]["loss"] != big[1]["loss"]:
        raise AssertionError(f"[lora {label} 3B {kind}] the ranks' losses "
                             f"differ: {big[0]['loss']} vs {big[1]['loss']}")
    lerr = abs(big[0]["loss"] - one["loss"]) / abs(one["loss"])
    nerr = abs(big[0]["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    if not (lerr <= PT_3B_LOSS_TOL and nerr <= PT_3B_NORM_TOL):
        raise AssertionError(
            f"[lora {label} 3B {kind}] loss {big[0]['loss']} ({lerr:.2e} "
            f"relative, limit {PT_3B_LOSS_TOL}), grad norm "
            f"{big[0]['grad_norm']} ({nerr:.2e}, limit {PT_3B_NORM_TOL}) "
            f"against one rank's")
    want = pl_expected_launches(cfg, rows)
    for r, g in enumerate(big):
        if g["launches"] != want:
            raise AssertionError(f"[lora {label} 3B {kind}] rank {r} "
                                 f"launched {g['launches']}, expected {want}")
    log(f"[lora {label} 3B {kind}] rank {PL_RANK}, loss {big[0]['loss']:.5f}"
        f" on both ranks ({lerr:.2e} from one rank), grad norm "
        f"{big[0]['grad_norm']:.5f} ({nerr:.2e}); per rank: " + "; ".join(
            f"{g['ms']:.1f} ms a step, collectives {g['collective_s']:.2f} s"
            f" = {100 * g['collective_share']:.1f}% in "
            f"{g['collective_calls']} calls, peak {g['peak_mb']:.0f} MB"
            for g in big) + f"; launches a step per rank {want}")
    return dict(tiny_worst_factor_err=worst, loss_rel_err=lerr,
                grad_norm_rel_err=nerr, ranks=big)


def pl_cli(root: str, device: str) -> dict:
    """The trainer's entry point with use_lora: two processes at fsdp = 2
    beside one process on the same two-row global batch (tiny, float32, 3
    steps): the ranks' losses equal, and within PT_CLI_TOL of one
    process's."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="pl_cli_")
    base = train_cli_base(root, work, device) + [
        "--use_lora", "true", "--lora_rank", str(PL_TINY_RANK),
        "--max_steps", "3", "--mesh_data", "1",
        "--per_device_train_batch_size", "2"]
    t0 = time.perf_counter()
    two = train_cli_launch(base, os.path.join(work, "two"), 2,
                           ["--mesh_fsdp", "2"])
    one = train_cli_launch(base, os.path.join(work, "one"), 1, [])
    m2 = train_cli_finish(two, "lora fsdp=2")
    m1 = train_cli_finish(one, "lora one process")
    if not (m2[0]["step"] == m2[1]["step"] == 3
            and m2[0]["loss"] == m2[1]["loss"]):
        raise AssertionError(f"[lora cli] the ranks logged {m2}")
    err = abs(m2[0]["loss"] - m1[0]["loss"]) / abs(m1[0]["loss"])
    if not err <= PT_CLI_TOL:
        raise AssertionError(f"[lora cli] 2-process loss {m2[0]['loss']} "
                             f"vs one process {m1[0]['loss']}")
    wall = time.perf_counter() - t0
    log(f"[lora cli] use_lora, 2 processes at fsdp=2: step-3 loss "
        f"{m2[0]['loss']:.6f} on both ranks, one process "
        f"{m1[0]['loss']:.6f} ({err:.1e} relative, limit {PT_CLI_TOL:g}); "
        f"{wall:.1f}s")
    shutil.rmtree(work, ignore_errors=True)
    return dict(loss_2proc=m2[0]["loss"], loss_1proc=m1[0]["loss"],
                rel_err=err, wall_s=wall)


def phase_lora_parallel(data: dict, device: str = "cuda") -> dict:
    """Phase 17(a): the LoRA CLI (pl_cli); one rank's LoRA and QLoRA steps
    on the card (tiny float32 and the cut 3B); one spawn of two ranks that
    runs them at fsdp = 2 and at model = 2 (pl_rank); the checks of
    pl_check."""
    from karanta_tpu_torch.device import float32_reductions, no_tf32
    from karanta_tpu_torch.parallel.mesh import create_mesh

    no_tf32()
    float32_reductions()
    stats = {"cli": pl_cli(data["tiny_root"], device)}
    spec = {"tiny_params": pt_tiny_params("tiny"),
            "tiny_batch": data["tiny_batch"], "3b_batch": data["3b_batch"],
            "device": device}
    ref = pl_cases(create_mesh(device=device), spec)
    for kind in PL_KINDS:
        r = ref[("3b", kind)]
        log(f"[lora one rank 3B {kind}] rank {PL_RANK}: loss "
            f"{r['loss']:.5f}, grad norm {r['grad_norm']:.5f}, "
            f"{r['ms']:.1f} ms, peak {r['peak_mb']:.0f} MB, launches "
            f"{r['launches']}")
    stats["one_rank"] = {kind: ref[("3b", kind)] for kind in PL_KINDS}
    t0 = time.perf_counter()
    ranks = run_ranks(pl_rank, 2, (spec,), timeout_s=PT_TIMEOUT)
    log(f"[lora] two ranks in {time.perf_counter() - t0:.1f}s, backend "
        f"{ranks[0]['backend']}")
    cfg3b = pt_config("3b")
    stats["meshes"] = {}
    for label, _ in PL_MESHES:
        for kind in PL_KINDS:
            stats["meshes"][f"{label} {kind}"] = pl_check(
                label, kind, ref, [r[label] for r in ranks], cfg3b,
                PT_3B_LOCAL_ROWS[label])
    return stats


def bulk_requests(root: str, pdf_dir: str) -> int:
    """vLLM-format request files from the PDFs by the port's
    data/create_batch_data_prompts.py (two pages a PDF at most, the
    pipeline's 1,288-pixel render), each page's budget cut to BULK_TOKENS;
    returns the number of requests."""
    from karanta_tpu_torch.constants import PIPELINE_IMAGE_DIM
    from karanta_tpu_torch.data.create_batch_data_prompts import \
        build_requests

    n = build_requests(pdf_dir, root, "smoke", flavor="vllm",
                       pages_per_pdf=2, requests_per_file=4,
                       target_dim=PIPELINE_IMAGE_DIM)
    for path in glob.glob(os.path.join(root, "*.jsonl")):
        with open(path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        for line in lines:
            line["body"]["max_tokens"] = BULK_TOKENS
        with open(path, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))
    return n


def bulk_results(out_dir: str) -> list:
    found = []
    for path in glob.glob(os.path.join(out_dir, "*", "results", "*.json")):
        with open(path) as f:
            found.append(json.load(f))
    return found


def teacher_tools(engine, port: int, pdf: str, root: str) -> dict:
    """Phase 17(c): data/test_prompts.py and bench/create_tests.py through
    get_client("openai", ..., base_url=) against the server on one page
    each. test_prompts asks for BULK_TOKENS tokens; create_tests (whose
    requests ask for 2,000) gets a transcription that fills the context but
    BULK_TOKENS rows, so that the server's clamp to the context ends it
    there. Each runs to its end and writes its output (test_prompts its
    report on stdout, create_tests its tests file)."""
    from karanta_tpu_torch.bench import create_tests
    from karanta_tpu_torch.constants import CREATE_TEST_PROMPT_PATH
    from karanta_tpu_torch.data.test_prompts import run_prompt_test
    from karanta_tpu_torch.prompts.templates import load_prompt_template

    url = f"http://127.0.0.1:{port}/v1"
    t0 = time.perf_counter()
    out = run_prompt_test(pdf, 1, "openai", "smoke", base_url=url,
                          max_tokens=BULK_TOKENS)
    if out["completion_tokens"] != BULK_TOKENS or \
            n_tokens(out["response"]) != BULK_TOKENS:
        raise AssertionError(f"[teacher test_prompts] {out}")
    prompt_s = time.perf_counter() - t0

    def prompt_len(text: str) -> int:
        prompt = load_prompt_template(
            create_tests.PROMPT_KEYS["present"],
            CREATE_TEST_PROMPT_PATH).render({
                "num_tests": 3, "pdf_name": "page.pdf", "page": 1,
                "transcription": text, "base_text": ""})
        return len(engine.prepare(GenRequest(
            messages=[{"role": "user", "content": prompt}],
            max_tokens=1)).ids)

    # one token a character (the byte tokenizer, ASCII)
    room = engine.ecfg.max_seq_len - 1 - BULK_TOKENS
    text = "0123456789 " * ((room - prompt_len("")) // 11 + 1)
    text = text[:room - prompt_len("")]
    if prompt_len(text) != room:
        raise AssertionError(f"[teacher create_tests] prompt of "
                             f"{prompt_len(text)} tokens, wanted {room}")
    gt = os.path.join(root, "gt")
    os.makedirs(gt)
    with open(os.path.join(gt, "page_pg1.md"), "w") as f:
        f.write(text)
    tests_path = os.path.join(root, "tests.jsonl")
    served = json.loads(http_call(port, "GET", "/metrics")[1])[
        "requests_served"]
    t0 = time.perf_counter()
    create_tests.main(["--transcriptions", gt, "--output", tests_path,
                       "--provider", "openai", "--model", "smoke",
                       "--base-url", url, "--kinds", "present",
                       "--per-page", "3"])
    tests_s = time.perf_counter() - t0
    served = json.loads(http_call(port, "GET", "/metrics")[1])[
        "requests_served"] - served
    if not os.path.exists(tests_path) or served != 1:
        raise AssertionError(f"[teacher create_tests] {served} requests, "
                             f"output {os.path.exists(tests_path)}")
    with open(tests_path) as f:
        n_tests = sum(1 for _ in f)
    log(f"[teacher] test_prompts: {out['prompt_tokens']} prompt and "
        f"{out['completion_tokens']} completion tokens in {prompt_s:.2f}s; "
        f"create_tests: one request of {room} prompt tokens answered in "
        f"{tests_s:.2f}s, {n_tests} tests parsed from a random-weight "
        f"answer (its text is not JSON)")
    return dict(test_prompts_s=prompt_s, prompt_tokens=out["prompt_tokens"],
                create_tests_s=tests_s, create_tests_tests=n_tests)


def phase_bulk(cfg) -> dict:
    """Phase 17(b) and (c): the server CLI's engine at the int8 point
    (phase 5's flags) served in process; the port's bulk CLI over it and a
    port on which nothing listens, with request files that
    create_batch_data_prompts builds from phase 9's PDFs; then the teacher
    tools against the same server."""
    import shutil
    import tempfile

    from karanta_tpu_torch.bulk.main import amain, parse_args

    root = tempfile.mkdtemp(prefix="bulk_")
    pdfs = pipeline_corpus(os.path.join(root, "pdfs"))
    reqs = os.path.join(root, "reqs")
    n_req = bulk_requests(reqs, os.path.dirname(pdfs[0]))
    if not 1 <= n_req <= 8:
        raise AssertionError(f"[bulk] {n_req} requests")
    engine = served_engine(
        ["--preset", "qwen2.5-vl-7b", "--quantize", "int8", "--kv-quantize",
         "int8", "--act-quant", "int8", "--max-batch-size", "4",
         "--decode-chunk", "8"])
    counts = instrument(engine)
    dead = f"http://127.0.0.1:{_free_port()}"
    with serving(engine) as (server, port):
        live = f"http://127.0.0.1:{port}"
        args = parse_args(["--input", reqs, "--output",
                           os.path.join(root, "out"), "--servers", dead,
                           live])
        kernels.reset_launches()
        t0 = time.perf_counter()
        jobs = asyncio.run(amain(args))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        served = json.loads(http_call(port, "GET", "/metrics")[1])[
            "requests_served"]
        jobs2 = asyncio.run(amain(args))  # resume: every result exists
        served2 = json.loads(http_call(port, "GET", "/metrics")[1])[
            "requests_served"]
        teacher = teacher_tools(engine, port, pdfs[0], root)
    for label, js in (("first run", jobs), ("resume", jobs2)):
        done = sum(j["status_counts"].get("completed", 0) for j in js)
        other = [j["status_counts"] for j in js
                 if set(j["status_counts"]) - {"completed"}]
        if done != n_req or other:
            raise AssertionError(f"[bulk {label}] {done} of {n_req} tasks "
                                 f"completed: {[j['status_counts'] for j in js]}")
    if served != n_req or served2 != served:
        raise AssertionError(f"[bulk] the server answered {served} requests "
                             f"on the first run and {served2 - served} on "
                             f"the resume (want {n_req} and 0)")
    results = bulk_results(os.path.join(root, "out"))
    if len(results) != n_req or {r["server"] for r in results} != {live}:
        raise AssertionError(f"[bulk] {len(results)} results from "
                             f"{sorted({r['server'] for r in results})}")
    for r in results:
        text = r["response"]["choices"][0]["message"]["content"]
        if n_tokens(text) != BULK_TOKENS:
            raise AssertionError(f"[bulk] {r['custom_id']}: "
                                 f"{n_tokens(text)} tokens")
    want = expected_prefill_launches(cfg, n_req, counts["prefix_builds"])
    check_launches("bulk", launches, {k: want[k] for k in want})
    if not (launches["paged_decode_append_quant"]
            or launches["paged_decode_append_multi_quant"]):
        raise AssertionError(f"[bulk] no decode or verify kernel: "
                             f"{launches}")
    latency = sorted(r["latency_s"] for r in results)
    median = latency[len(latency) // 2] if len(latency) % 2 else \
        (latency[len(latency) // 2 - 1] + latency[len(latency) // 2]) / 2
    log(f"[bulk] {n_req} pages x {BULK_TOKENS} tokens through the router "
        f"(live server + a dead port) in {wall:.3f}s: "
        f"{n_req / wall:.4f} pages/s, median task latency {median:.3f}s; "
        f"every task completed on {live}; the resume made no request; "
        f"{counts['verify_passes']} verify passes, {counts['decode_steps']} "
        f"decode steps, {counts['prefix_hits']} prefix hits")
    del server, engine
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return dict(pages=n_req, pages_per_s=n_req / wall, wall_s=wall,
                median_latency_s=median, launches=launches,
                verify_passes=counts["verify_passes"],
                decode_steps=counts["decode_steps"],
                prefix_hits=counts["prefix_hits"], teacher=teacher)


def closed_loop_start(device: str = "cuda") -> tuple:
    """Phase 17(d), started: `python -m karanta_tpu_torch.bench.closed_loop`
    with tests/test_closed_loop.py's arguments (8 pages, 1 character, 500
    steps, lr 1e-3) as a subprocess on the card. Returns (process, root,
    start time) for closed_loop_finish."""
    import tempfile

    root = tempfile.mkdtemp(prefix="closed_loop_")
    argv = [sys.executable, "-m", "karanta_tpu_torch.bench.closed_loop",
            "--root", root, *CL_ARGV,
            *(["--device", "cpu"] if device == "cpu" else [])]
    # its output to a file: a pipe that nobody reads while (a)-(c) run
    # would fill and stop it
    log_file = open(os.path.join(root, "closed_loop.log"), "w")
    # a session of its own: closed_loop_kill stops it with its server
    proc = subprocess.Popen(argv, cwd=REPO, stdout=log_file,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    log_file.close()
    return proc, root, time.perf_counter()


def closed_loop_kill(started: tuple) -> None:
    """Stop a started closed loop and every process it started."""
    import signal

    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def closed_loop_finish(started: tuple) -> dict:
    """Phase 17(d)'s checks: exit 0, 8 pages read back, mean CER <=
    CL_MAX_CER and at least CL_MIN_EXACT exact matches; its training
    seconds, steps/s and final loss from the trainer's line."""
    import shutil

    proc, root, t0 = started
    try:
        proc.wait(timeout=max(1.0, CL_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        closed_loop_kill(started)
        raise AssertionError(f"[closed loop] not done in {CL_TIMEOUT}s")
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "closed_loop.log")) as f:
        out = f.read()
    if proc.returncode:
        raise AssertionError(f"[closed loop] exit {proc.returncode}:\n"
                             f"{out[-4000:]}")
    with open(os.path.join(root, "scores.json")) as f:
        scores = json.load(f)
    trained = re.search(r"trained (\d+) steps in ([\d.]+)s \(([\d.]+) "
                        r"steps/s\): loss=([\d.]+)", out)
    if trained is None:
        raise AssertionError(f"[closed loop] no training line:\n"
                             f"{out[-2000:]}")
    if not (scores["pages"] == CL_PAGES and
            scores["mean_cer"] <= CL_MAX_CER and
            scores["exact_match"] >= CL_MIN_EXACT):
        raise AssertionError(f"[closed loop] {scores} (want {CL_PAGES} "
                             f"pages, mean CER <= {CL_MAX_CER}, >= "
                             f"{CL_MIN_EXACT} exact)")
    stats = dict(scores, train_s=float(trained.group(2)),
                 steps_per_s=float(trained.group(3)),
                 final_loss=float(trained.group(4)), wall_s=wall)
    log(f"[closed loop] {' '.join(CL_ARGV)}: trained "
        f"{trained.group(1)} steps in {stats['train_s']}s "
        f"({stats['steps_per_s']} steps/s, loss {stats['final_loss']}); "
        f"{scores['pages']} pages, mean CER {scores['mean_cer']:.4f}, "
        f"{scores['exact_match']} exact; {wall:.1f}s from its start")
    shutil.rmtree(root, ignore_errors=True)
    return stats


def phase_last_modules(cfg, data: dict, started: tuple,
                       device: str = "cuda") -> dict:
    """Phase 17: (a) phase_lora_parallel, (b) and (c) phase_bulk, then (d)
    the closed loop's end. The closed loop's 500 tiny steps are host-bound
    (about 3.6 steps/s on the card alone), so its process (`started`,
    closed_loop_start) starts before phase 16 and runs beside phases 16
    and 17 on the same card; their times hold that neighbour."""
    import shutil

    t0 = time.perf_counter()
    try:
        stats = {"lora": phase_lora_parallel(data, device)}
        shutil.rmtree(data["root"], ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        stats["bulk"] = phase_bulk(cfg)
    except BaseException:
        closed_loop_kill(started)
        raise
    t2 = time.perf_counter()
    stats["closed_loop"] = closed_loop_finish(started)
    t3 = time.perf_counter()
    stats["seconds"] = dict(lora=t1 - t0, bulk=t2 - t1,
                            closed_loop_wait=t3 - t2, total=t3 - t0)
    log(f"[last modules] phase 17 in {t3 - t0:.1f}s (LoRA {t1 - t0:.1f}, "
        f"bulk and teacher {t2 - t1:.1f}, then the closed loop's end "
        f"{t3 - t2:.1f}; the closed loop ran beside phases 16 and 17)")
    return stats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one page's prefill, one decode chunk and "
                             "two verify passes of each served engine with "
                             "torch.profiler and print the breakdowns")
    args = parser.parse_args(argv)
    # every page pays its decode: phases that time host preparation must not
    # hit the decoded-image cache (re-prepared pages would)
    os.environ["KARANTA_IMG_CACHE_MB"] = "0"

    t_last = [time.perf_counter()]

    def mark(label: str) -> None:
        """Log the seconds since the previous mark (the phases' budget)."""
        now = time.perf_counter()
        log(f"[time] {label}: {now - t_last[0]:.1f}s")
        t_last[0] = now

    kind = phase_card()
    phase_build()
    mark("phases 1-2, build")
    dev = torch.device("cuda")
    cfg = get_config("qwen2.5-vl-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    log("[kernels] each kernel vs its plain version at the 7B shapes")
    rows = [kernel_window(cfg, dev, gen), kernel_flash(cfg, dev, gen),
            kernel_decode(cfg, dev, gen, BATCH),
            kernel_decode_multi(cfg, dev, gen), kernel_append(cfg, dev, gen),
            kernel_q4(cfg, dev, gen), kernel_multi_q4(cfg, dev, gen),
            *kernel_read_only(cfg, dev, gen)]
    torch.cuda.empty_cache()
    per_rank = kernel_per_rank(cfg, dev, gen)
    torch.cuda.empty_cache()
    mark("phase 3, kernels")
    stream_rows, ab_stats, barrier_us = phase_decode_streams(cfg, dev, gen)
    rows += stream_rows
    mark("phase 3, decode streams")
    main_stats = phase_main_path(cfg, dev, args.profile)
    int8_stats = phase_served_int8(cfg, args.profile)
    int4_stats = phase_served_int4(cfg, args.profile)
    default_stats = phase_served_defaults(cfg, args.profile)
    mark("phases 4-7, engine and served")
    for kv in ("int8", "int4"):
        phase_tiny(dev, kv)
    phase_tiny_stacked(dev)
    mark("phase 8, tiny")
    pipeline_stats = phase_pipeline(cfg, kind)
    mark("phase 9, pipeline")
    loading_stats = phase_loading(cfg)
    mark("phase 10, loading")
    guided_stats = phase_guided_logprobs(cfg)
    mark("phase 11, guided and logprobs")
    training_stats = phase_training(args.profile)
    training_launches = training_stats["full"]["adamw"]["launches_per_step"]
    mark("phase 12, training")
    classifier_stats = phase_classifiers()
    mark("phase 13, classifiers")
    batched_stats = phase_batched(cfg)
    mark("phase 14, batched prefill")
    parallel_stats = phase_parallel(cfg)
    mark("phase 15, parallel serving")
    flash_sp = kernel_flash_sp(cfg, dev, gen)
    torch.cuda.empty_cache()
    # phase 17's closed loop, started here: it runs beside phases 16-17
    closed_loop = closed_loop_start()
    try:
        ptrain_stats = phase_parallel_training()
    except BaseException:
        closed_loop_kill(closed_loop)
        raise
    mark("phase 16, parallel training")
    last_stats = phase_last_modules(cfg, ptrain_stats.pop("data"),
                                    closed_loop)
    mark("phase 17, LoRA over meshes, bulk, teacher tools, closed loop")
    par_launches = {"tp=2 prefill, per rank": parallel_stats[
        "tp2_prefill_launches"],
        "2x2 generate, per rank": parallel_stats["dp2tp2_launches"],
        "served tp=2, per rank": parallel_stats["served_launches"]}
    # each kernel's launches on the path that runs it; kernel #8 is on no
    # path (the JAX package calls it from its tests only)
    paths = {
        "window_attention": ("engine", main_stats["launches"]),
        "flash_attention": ("engine", main_stats["launches"]),
        "paged_decode_append_quant": ("engine", main_stats["launches"]),
        "paged_decode_append_multi_quant": ("served int8",
                                            int8_stats["launches"]),
        "paged_decode_append": ("served defaults, per-step wave",
                                default_stats["per-step"]["launches"]),
        "paged_decode_append_q4": ("served int4, per-step wave",
                                   int4_stats["per-step"]["launches"]),
        "paged_decode_append_multi_q4": (
            "served int4, speculative wave",
            int4_stats["speculative"]["launches"]),
        "paged_decode_attention_stacked": (
            "served defaults, stacked wave",
            default_stats["stacked"]["launches"]),
        # one launch per chained step or call at B = 80
        "dense_stream": ("decode-stream A/B",
                         ab_stats[f"B={AB_BATCH}"]["dense_stream"]
                         ["launches"]),
        "decode_megakernel": ("decode-stream A/B",
                              ab_stats[f"B={AB_BATCH}"]["megakernel"]
                              ["launches"]),
    }
    for row in rows:
        if row["name"] == "flash_attention":
            # the float32 instance on the classifiers' paths (phase 13)
            row["classifier_f32"] = classifier_stats["flash_f32"]
            row["classifier_launches"] = {
                **{f"{arch} batch": e["launches"].get("flash_attention", 0)
                   for arch, e in classifier_stats["serving"].items()},
                **{f"{arch} training step": e["launches_per_step"]
                   ["flash_attention"]
                   for arch, e in classifier_stats["training"].items()}}
        path, launches = paths.get(row["name"], (None, {}))
        row["launches"] = launches.get(row["name"], 0)
        row["path"] = path
        row["pipeline_launches"] = pipeline_stats["bench"]["launches"].get(
            row["name"], 0)
        row["forced_launches"] = pipeline_stats["forced"]["launches"].get(
            row["name"], 0)
        row["guided_launches"] = guided_stats["launches"].get(row["name"], 0)
        row["training_launches_per_step"] = training_launches.get(
            row["name"], 0)
        row["batched_launches"] = {
            wave: batched_stats[wave]["launches"].get(row["name"], 0)
            for wave in ("A", "B", "C", "D")}
        # one rank's shapes of tensor-parallel serving (phase 3) and the
        # launches of each rank of phase 15's paths
        row["per_rank"] = per_rank.get(row["name"])
        row["parallel_launches"] = {
            path: {rank: counts.get(row["name"], 0)
                   for rank, counts in per.items()}
            for path, per in par_launches.items()}
        # phase 16: a 3B step's launches on each rank of each mesh
        row["parallel_training_launches_per_step"] = {
            label: [counts.get(row["name"], 0) for counts in per]
            for label, per in ptrain_stats["launches"].items()}
        # phase 17: a cut-3B LoRA or QLoRA step's launches on each rank of
        # each mesh, and the bulk fan-out's over the 7B server
        row["lora_training_launches_per_step"] = {
            key: [g["launches"].get(row["name"], 0) for g in e["ranks"]]
            for key, e in last_stats["lora"]["meshes"].items()}
        row["bulk_launches"] = last_stats["bulk"]["launches"].get(
            row["name"], 0)
        if row["name"] == "flash_attention":
            row["sequence_parallel"] = flash_sp
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)}"
            f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"{row['launches']} launches ({path}), "
            f"{row['pipeline_launches']} in the pipeline bench, "
            f"{row['forced_launches']} in the teacher-forced bench, "
            f"{row['guided_launches']} in the guided/logprobs wave, "
            f"{row['training_launches_per_step']} a 3B training step")
    log(json.dumps({"main_path": {k: v for k, v in main_stats.items()
                                  if k != "launches"},
                    "served_int8": int8_stats,
                    "served_int4": int4_stats,
                    "served_defaults": default_stats,
                    "decode_stream_ab": {
                        key: {name: {k: v for k, v in e.items()
                                     if k != "launches"}
                              for name, e in per.items()}
                        for key, per in ab_stats.items()},
                    "stream_barrier_us": barrier_us,
                    "pipeline": {
                        "entry": pipeline_stats["entry"],
                        "bench": {k: v for k, v in
                                  pipeline_stats["bench"].items()
                                  if k not in ("launches", "detail")},
                        "forced": {k: v for k, v in
                                   pipeline_stats["forced"].items()
                                   if k not in ("launches", "detail")},
                        "seconds": pipeline_stats["seconds"]},
                    "loading": loading_stats,
                    "guided_logprobs": {k: v for k, v in guided_stats.items()
                                        if k != "launches"},
                    "training": training_stats,
                    "classifiers": classifier_stats,
                    "batched": {k: ({kk: vv for kk, vv in v.items()
                                     if kk != "launches"}
                                    if k in ("A", "B", "C", "D") else v)
                                for k, v in batched_stats.items()},
                    "parallel": {k: v for k, v in parallel_stats.items()
                                 if not k.endswith("launches")},
                    "parallel_training": {
                        k: v for k, v in ptrain_stats.items()
                        if k != "launches"},
                    "last_modules": {
                        "lora": last_stats["lora"],
                        "bulk": {k: v for k, v in last_stats["bulk"].items()
                                 if k != "launches"},
                        "closed_loop": last_stats["closed_loop"],
                        "seconds": last_stats["seconds"]}}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
