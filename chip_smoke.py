"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # and torch.profiler stage breakdowns

Phases (any failed check raises and the script exits non-zero):

1. card: name, power limit, TF32 off for float32 products;
2. build: nvcc builds the nine kernel sources from
   karanta_tpu_torch/kernels/csrc, one process per source, all at once;
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
   the int8 decode kernel at the decode A/B point, B = 80 with every slot
   filled to 1,650 of 1,920 rows, each checked against its plain version;
   beside the append kernel, SDPA over the bucket with the new row
   scattered, for context); the split decode kernels' device time without
   the host's
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
   a plain one; guided and unguided slots decode side by side.

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
from karanta_tpu_torch.bench.stream_trace import (AB_BUCKET, AB_FILL,
                                                  STREAM_CHECK_LENS,
                                                  stream_inputs)
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
    t0 = time.perf_counter()
    secs = build_all()
    log(f"[build] {', '.join(f'{k} {v:.1f}s' for k, v in secs.items())}; "
        f"wall {time.perf_counter() - t0:.1f}s")


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

    t_k = cuda_ms(lambda: A.window_attention_kernel_call(
        q, k, v, w, mask, cos=cos, sin=sin), 20)
    t_p = cuda_ms(lambda: A.window_attention_plain(q, k, v, w, mask, cos=cos,
                                                   sin=sin), 5)
    t_l = cuda_ms(lib, 20)
    n_bytes = 4 * s * h * d * 2 + 2 * s * d * 4 + s * 4
    flops = 4.0 * w * d * s * h
    b, by = bound_ms(n_bytes, flops)
    # the bf16 instance's rate, share of the bound and resources
    rates = {"tflops": flops / t_k * 1e-9, "bound_share": b / t_k,
             "sdpa_ratio": t_k / t_l,
             "resources": A.window_attention_info(d, w)}
    log(f"  window: kernel {t_k:.4f} ms, {rates['tflops']:.1f} TFLOP/s, "
        f"{100 * rates['bound_share']:.1f}% of the bound {b:.4f} ms; "
        f"{rates['sdpa_ratio']:.2f}x SDPA's {t_l:.4f} ms; bf16 instance "
        f"{rates['resources']}")
    return dict(name="window_attention", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/window_attention.cu",
                replaces="karanta_tpu/ops/attention.py:403",
                max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b,
                bound_by=by, library_ms=t_l, **rates)


def _flash_case(dev, gen, b, sq, sk, h, kvh, d, dtype, live_len):
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=gen, device=dev).to(dtype)
    mask = torch.zeros((b, sk), device=dev)
    mask[:, :live_len] = 1.0
    return q, k, v, mask


def _flash_work(sq, sk, h, kvh, d, live_len, causal, q_offset=0, esize=2):
    """Bytes (each input read once, output written once) and flops of the
    (query, live key) pairs this input needs."""
    if causal:
        pairs = sum(min(q_offset + i + 1, live_len) for i in range(sq))
    else:
        pairs = sq * live_len
    n_bytes = (2 * sq * h * d + 2 * sk * kvh * d) * esize + sk * 4
    return n_bytes, 4.0 * d * h * pairs


def _sdpa_mask(sq, sk, live_len, causal, dev, q_offset=0):
    m = torch.zeros((sq, sk), dtype=torch.bool, device=dev)
    m[:, :live_len] = True
    if causal:
        m &= torch.ones((sq, sk), dtype=torch.bool,
                        device=dev).tril(diagonal=q_offset)
    return m[None, None]


# the served paths' prefix continuation: a ~1,700-token page prompt whose
# first 384 tokens come from the prefix cache; the suffix's 1,316 tokens pad
# to the 2048 bucket
PREFIX_LEN, SUFFIX_LEN, SUFFIX_BUCKET = 384, 1316, 2048


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

        times[name] = (
            cuda_ms(lambda q=q, k=k, v=v, m=mask, c=causal, o=q_off:
                    A.flash_attention(q, k, v, m, causal=c, q_offset=o), 10),
            cuda_ms(lambda q=q, k=k, v=v, m=mask, c=causal, o=q_off:
                    A.flash_attention_plain(q, k, v, m, causal=c,
                                            q_offset=o), 3),
            cuda_ms(lib, 10),
            _flash_work(sq, sk, h, kvh, d, live_len, causal, q_off))
        log(f"  flash {name}: kernel {times[name][0]:.3f} ms, plain "
            f"{times[name][1]:.3f} ms, sdpa {times[name][2]:.3f} ms")
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
    # the bf16 instances' resources, as the CUDA runtime reports them
    for d in sorted({t.head_dim, vc.head_dim}):
        log(f"  flash bf16 D={d}: {A.flash_attention_info(d)}")
    # the row reports the prefill shape (28 of the 32 launches per page);
    # the vision-full and prefix numbers ride along
    rates = {}
    for name, (t_k, _, t_l, work) in times.items():
        bound, _ = bound_ms(*work)
        rates[name] = {"tflops": work[1] / t_k * 1e-9,
                       "bound_share": bound / t_k}
        log(f"  flash {name}: bound {bound:.4f} ms; kernel "
            f"{rates[name]['tflops']:.1f} TFLOP/s on the live pairs, "
            f"{100 * rates[name]['bound_share']:.1f}% of the bound; "
            f"{t_k / t_l:.2f}x SDPA's time")
    t_k, t_p, t_l, (n_bytes, flops) = times["prefill"]
    b, by = bound_ms(n_bytes, flops)
    extra = {name: {"ms": times[name][0], "plain_ms": times[name][1],
                    "library_ms": times[name][2],
                    "bound_ms": bound_ms(*times[name][3])[0], **rates[name]}
             for name in ("vision_full", "prefix")}
    return dict(name="flash_attention", route="cuda",
                source="karanta_tpu_torch/kernels/csrc/flash_attention.cu",
                replaces="karanta_tpu/ops/attention.py:235",
                max_abs_err=max(errs), ms=t_k, plain_ms=t_p, bound_ms=b,
                bound_by=by, library_ms=t_l, **rates["prefill"], **extra)


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
    rates = {"device_ms": t_dev, "bound_share": bd / t_dev,
             "resources": res,
             "b80": {"ms": t8, "device_ms": t8_dev, "bound_ms": bd8,
                     "bound_share": bd8 / t8_dev,
                     "live_gbps": n8 / t8_dev * 1e-6, "max_abs_err": err8,
                     "run_rows": res8["run_rows"]}}
    log(f"  paged_decode_append_quant B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {100 * bd / t_dev:.1f}% of the "
        f"bound {bd:.4f} ms; B={AB_BATCH}: {t8:.4f} ms ({t8_dev:.4f} "
        f"device), {100 * bd8 / t8_dev:.1f}% of its bound {bd8:.4f} ms, "
        f"{n8 / t8_dev * 1e-6:.0f} GB/s; bf16 instance {res}, runs of "
        f"{res8['run_rows']} rows at B={AB_BATCH}")
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
    page prompt's length, a longer one and M - T - 1."""
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
    rates = {"device_ms": t_dev, "live_gbps": n_bytes / t_k * 1e-6,
             "bound_share": bd / t_k, "resources": resources,
             "b32": {"ms": t3, "device_ms": t3_dev, "bound_ms": bd3,
                     "bound_share": bd3 / t3, "live_gbps": n3 / t3 * 1e-6,
                     "max_abs_err": err3, "run_rows": res3["run_rows"]}}
    log(f"  paged_decode_append_multi_quant B={batch}: kernel {t_k:.4f} ms "
        f"({t_dev:.4f} ms of device time), {rates['live_gbps']:.0f} GB/s of "
        f"live bytes, {100 * rates['bound_share']:.1f}% of the bound "
        f"{bd:.4f} ms; B={b32}: {t3:.4f} ms ({t3_dev:.4f} device), "
        f"{100 * bd3 / t3:.1f}% of its bound {bd3:.4f} ms, "
        f"{n3 / t3 * 1e-6:.0f} GB/s; bf16 instance {resources}, runs of "
        f"{res3['run_rows']} rows at B={b32}")
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
AB_BATCH, AB_ITERS = 80, 20
STREAM_NORM_TOL = 2e-2  # normwise relative error after 28 layers
STREAM_CALLS = 20  # chained calls per stream device time


def normwise(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def stream_work(cfg, b: int, lens, mega: bool) -> tuple[float, float]:
    """Bytes (each input read once, each output written once: the int8
    weights with their scales, norms and biases, the activations, and for
    the megakernel the live K/V rows with their scales and the new rows) and
    flops (the products, and the megakernel's attention over cache_len + 1
    rows) of one call."""
    t = cfg.text
    n, h, ff, d, kvh = t.num_layers, t.hidden_size, t.intermediate_size, \
        t.head_dim, t.num_kv_heads
    qd, qkv = t.num_heads * d, t.num_heads * d + 2 * kvh * d
    weights = n * (h * qkv + qd * h + 3 * h * ff)
    n_bytes = (weights + 4 * n * (qkv + 2 * h + 2 * ff) + 2 * n * (2 * h + qkv)
               + 2 * b * h * 2)
    flops = 2.0 * b * weights
    if mega:
        n_bytes += (2 * b * d * 4 + b * 4
                    + n * kvh * (d + 2) * 2 * (sum(lens) + b))
        flops += 4.0 * d * t.num_heads * n * sum(x + 1 for x in lens)
    else:
        n_bytes += n * b * (h + qkv) * 2  # attention outputs in, qkv out
    return n_bytes, flops


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
    per barrier (7 a layer for #11, 5 for #10) is an upper bound, since it
    includes each phase's own least time."""
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
    out = {"megakernel": t_mega * 1e3 / (7 * n + 0.0),
           "dense_stream": t_dense * 1e3 / (5 * n + 0.0),
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
            res = ST.trace_call(traced, call, t.num_layers)
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
    lay = text["layers"]
    w16 = [[lay[g][n]["int8_q"][i].t().to(torch.bfloat16)
            for g, n in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                         ("attn", "wo"), ("mlp", "gate"), ("mlp", "up"),
                         ("mlp", "down"))] for i in range(t.num_layers)]
    h_mid = (torch.randn((b, t.intermediate_size), generator=gen, device=dev)
             * 0.3).bfloat16()

    def cublas_products():
        for ws in w16:
            for w in ws[:3]:
                x @ w.t()
            attn[0] @ ws[3].t()
            x @ ws[4].t()
            x @ ws[5].t()
            h_mid @ ws[6].t()

    t_lib10 = cuda_ms(cublas_products, 5)
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


def post_pages(port: int, bodies: list) -> list:
    """POST the bodies concurrently. Checks each answer: status 200, and
    SERVED_TOKENS tokens, from the usage count and from the text; a stream
    ends with a finish_reason chunk and [DONE], and its deltas put together
    spell SERVED_TOKENS tokens. Returns the completion texts."""
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
            n_usage = SERVED_TOKENS
        else:
            data = json.loads(raw)
            text = data["choices"][0]["message"]["content"]
            n_usage = data["usage"]["completion_tokens"]
        if n_usage != SERVED_TOKENS or n_tokens(text) != SERVED_TOKENS:
            raise AssertionError(f"a response has {n_usage} / "
                                 f"{n_tokens(text)} tokens, expected "
                                 f"{SERVED_TOKENS}")
        texts.append(text)
    return texts


def served_engine(argv: list):
    """The engine the server CLI builds from argv (random weights), with a
    tokenizer that counts tokens in the text (CountingTokenizer)."""
    t0 = time.perf_counter()
    engine, _ = build_engine_from_args(make_arg_parser().parse_args(argv))
    engine.tok = CountingTokenizer()
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
    from karanta_tpu_torch.pipeline import render_pool, runner
    from karanta_tpu_torch.utils.metrics import MetricsKeeper

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
    runner.metrics = MetricsKeeper()  # the bench line counts this run only
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
    from karanta_tpu_torch.pipeline import render_pool, runner
    from karanta_tpu_torch.utils.metrics import MetricsKeeper

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
    runner.metrics = MetricsKeeper()  # the bench line counts this run only
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace one page's prefill, one decode chunk and "
                             "two verify passes of each served engine with "
                             "torch.profiler and print the breakdowns")
    args = parser.parse_args(argv)

    kind = phase_card()
    phase_build()
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
    stream_rows, ab_stats, barrier_us = phase_decode_streams(cfg, dev, gen)
    rows += stream_rows
    main_stats = phase_main_path(cfg, dev, args.profile)
    int8_stats = phase_served_int8(cfg, args.profile)
    int4_stats = phase_served_int4(cfg, args.profile)
    default_stats = phase_served_defaults(cfg, args.profile)
    for kv in ("int8", "int4"):
        phase_tiny(dev, kv)
    phase_tiny_stacked(dev)
    pipeline_stats = phase_pipeline(cfg, kind)
    loading_stats = phase_loading(cfg)
    guided_stats = phase_guided_logprobs(cfg)
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
        path, launches = paths.get(row["name"], (None, {}))
        row["launches"] = launches.get(row["name"], 0)
        row["path"] = path
        row["pipeline_launches"] = pipeline_stats["bench"]["launches"].get(
            row["name"], 0)
        row["forced_launches"] = pipeline_stats["forced"]["launches"].get(
            row["name"], 0)
        row["guided_launches"] = guided_stats["launches"].get(row["name"], 0)
        log(f"  {row['name']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)}"
            f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"{row['launches']} launches ({path}), "
            f"{row['pipeline_launches']} in the pipeline bench, "
            f"{row['forced_launches']} in the teacher-forced bench, "
            f"{row['guided_launches']} in the guided/logprobs wave")
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
                                        if k != "launches"}}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
