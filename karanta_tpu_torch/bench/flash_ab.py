"""Kernel #2's bf16 instance (``ops/attention.py flash_attention``) at every
bf16 shape ``chip_smoke.py`` times, from this tree's source and, with
``--baseline DIR`` (repeatable), from other ``csrc`` directories (an
earlier commit's kernels, or a copy of this tree's with one constant
edited), in turns: each baseline, this tree twice, the baselines in
reverse order.

    python -m karanta_tpu_torch.bench.flash_ab
    python -m karanta_tpu_torch.bench.flash_ab --baseline /path/to/old/csrc
    python -m karanta_tpu_torch.bench.flash_ab --baseline A/csrc --baseline B/csrc
    python -m karanta_tpu_torch.bench.flash_ab --only vision,prefill

Shapes (Qwen2.5-VL-7B unless named): the decoder prefill (1, 1408, 28/4,
128) causal, 1,390 live keys; the vision full layers (1, 5120, 16, 80)
with the bench page's scattered validity mask; the prefix continuation
(queries over the 2,048-row suffix bucket, keys 384 + 2,048, q_offset 384,
1,700 live); batched prefill's (4, 5120, 16, 80) and (4, 1408, 28/4, 128);
one rank's heads at tp = 2 and 4; a sequence-parallel rank of the 3B
decoder, (1, 1536, 16/2 and 8/1, 128) over 3,072 gathered keys, 2,950
live, at q_offset 0 and 1,536. Each shape is checked against the plain
version at the bf16 limit (2^-7 |want| + 2^-9 max|want|) and timed on the
device: 20 calls captured in a CUDA graph and replayed, so the wrapper's
host time is left out; SDPA with the same masks beside it, and the bound
(flops of the live pairs at 989 TFLOP/s, or bytes at 3.35 TB/s). One line
per shape and source, then one JSON object. Needs a CUDA device.

With ``--kernel 3`` the same turns time kernel #3's bf16 instance
(``ops/decode_attention.py paged_decode_append_quant``, the int8-cache
decode step) from each source's ``decode_append_quant.cu`` at the 7B decode
shapes (one layer of a two-layer cache, M = 1,920, D = 128, G = 7): B = 4
with the smoke's lengths 0/700/1919/1390, B = 16 and 32 with lengths from a
seed, B = 80 with every slot filled to 1,650 rows, and one rank's kv heads
at tp = 2 and 4 (KVH 2 and 1, B = 4, lengths 0/700/1390/1915). Each source
runs with its library's own run rule: ``quant_run_rows`` with the library's
blocks per SM and most runs where its ``karanta_decode_append_quant_info``
reports rows a chunk (this kernel's design), else the rule of the split
body's int8 instance that it replaced (``SPLIT_RULE``); each
output is held to the plain version at the bf16 limit and its four caches
bit-equal; the bound is the bytes (the live rows and their scales, the new
rows read and written, q and the output) at 3.35 TB/s.

    python -m karanta_tpu_torch.bench.flash_ab --kernel 3 --baseline old/csrc

With ``--kernel 4`` or ``--kernel 7`` the same turns time the bf16
instance of the int8 verify kernel (#4, ``paged_decode_append_multi_quant``,
from each source's ``decode_append_multi_quant.cu``) or of the int4 one (#7,
``paged_decode_append_multi_q4``, ``decode_append_multi_q4.cu``) at the 7B
verify pass's shapes (one layer of a two-layer cache, D = 128, G = 7, T =
4): ``chip_smoke.py``'s B = 4 over 4,096 tokens (lengths 0/1700/2100/4091)
and its ragged B = 32 (#4) or B = 8 (#7), #4 at B = 80 with every slot
filled to 1,650 of 1,920 rows and at T = 2, and one rank's kv heads at tp =
2 and 4 (KVH 2 and 1, B = 4 over the smoke's per-rank caches). Each source
runs with its library's own run rule: the resident-run rule
(``resident_run``) where its info entry reports rows a chunk (the Hopper
body), else the rule of the split body it replaced (``SPLIT_VERIFY_RULES``);
outputs are held to the plain version at the bf16 limit and the caches
bit-equal; the bound is the bytes (``verify_work``) at 3.35 TB/s.

    python -m karanta_tpu_torch.bench.flash_ab --kernel 4 --baseline old/csrc

With ``--kernel 6`` the same turns time the bf16 instance of the int4
decode kernel (#6, ``paged_decode_append_q4``, from each source's
``decode_append_q4.cu``) at ``chip_smoke.py``'s #6 shapes (7B heads, D =
128, G = 7, one layer of a two-layer cache): B = 4 over 2,048 tokens
(lengths 0/700/1919/1390), the served int4 point's B = 8 over 4,096 tokens
with the smoke's ragged lengths, one rank's kv heads at tp = 2 and 4 (KVH 2
and 1, B = 4 over 2,048 tokens), and B = 32 and 80 with ragged lengths over
4,096 tokens from a seed. Each source runs with its library's own run
rule, as for #4 and #7 (the split body's: ``SPLIT_VERIFY_RULES``, one live
block an SM); the bound is ``verify_work`` at T = 1.

    python -m karanta_tpu_torch.bench.flash_ab --kernel 6 --baseline old/csrc

With ``--kernel 1`` the same turns time the bf16 instance of the window
kernel (#1, ``window_attention_kernel_call``, from each source's
``window_attention.cu``) at the vision window layers' shapes: the bench
page's window-ordered tokens at the 7B tower's width, (1, 5120, 16, 80) with
W = 64, the page's validity mask and its rope (``page``), the same without
rope (``page_norope``, the training forward), four pages concatenated
(``pages4``, batched prefill) and one rank's heads at tp = 2 and 4 (``tp2``,
``tp4``); each output is held to the plain version at the bf16 limit on the
rows whose window has a live key, SDPA over the windows (rope applied
beforehand) is timed beside it, and the bound is ``window_work``'s bytes
at 3.35 TB/s or flops at 989 TFLOP/s.

    python -m karanta_tpu_torch.bench.flash_ab --kernel 1 --baseline old/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from karanta_tpu_torch.bench.verify_runs import graph_ms, verify_work
from karanta_tpu_torch.kernels import build
from karanta_tpu_torch.models.qwen25_vl.config import get_config
from karanta_tpu_torch.models.qwen25_vl.layout import build_vision_layout
from karanta_tpu_torch.ops import attention as A
from karanta_tpu_torch.ops.image_prep import plan_image

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_BYTES = 3.35e12
# the served paths' prefix continuation: a ~1,700-token page prompt whose
# first 384 tokens come from the prefix cache; the suffix's 1,316 tokens pad
# to the 2048 bucket
PREFIX_LEN, SUFFIX_LEN, SUFFIX_BUCKET = 384, 1316, 2048
# sequence parallelism's per-rank shape: a 3,072-token row of the 3B
# decoder split over seq = 2, keys gathered whole, the corpus' first row's
# live keys
SP_Q, SP_K, SP_LIVE = 1536, 3072, 2950
# batched prefill: live keys of each page of a group. The vision full
# layers: the bench page's valid mask (None), then pages with fewer and more
# live tokens (scattered); the decoder prefill: ragged prompt lengths down
# to one
BATCHED_VISION_LIVE = (None, 3600, 5120, 900)
BATCHED_PREFILL_LIVE = (1390, 700, 1408, 1)


FLASH_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                  + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
DECODE_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def baseline_libs(csrcs: list, source: str = "flash_attention") -> dict:
    """Each csrc/<source>.cu, built in parallel with the port's nvcc flags
    into the build directory and loaded; keyed by the directory's name (its
    parent's if that is ``csrc``)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, libs = [], {}
    for csrc in csrcs:
        digest = hashlib.sha1(" ".join(build.NVCC_FLAGS).encode())
        for src in (csrc / f"{source}.cu", *sorted(csrc.glob("*.cuh"))):
            digest.update(src.read_bytes())
        out = build.BUILD_DIR / f"lib{source}-baseline-{digest.hexdigest()[:12]}.so"
        name = csrc.name if csrc.name != "csrc" else csrc.parent.name
        while name in libs:
            name += "'"
        libs[name] = out
        if not out.exists():
            procs.append(subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                 str(csrc / f"{source}.cu")]))
    for proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed: {proc.args}")
    return {name: ctypes.CDLL(str(out)) for name, out in libs.items()}


def baseline_fns(csrcs: list) -> dict:
    """karanta_flash_attention of each csrc/flash_attention.cu."""
    fns = {}
    for name, lib in baseline_libs(csrcs).items():
        fn = lib.karanta_flash_attention
        fn.restype = ctypes.c_int
        fn.argtypes = FLASH_ARGTYPES
        fns[name] = fn
    return fns


def flash_work(sq, sk, h, kvh, d, lives, causal, q_offset=0):
    """Bytes (each input read once, output written once) and flops of the
    (query, live key) pairs, summed over the batch's kv lengths (the live
    keys counted, not their places)."""
    pairs = 0
    for live in lives:
        if causal:
            pairs += sum(min(q_offset + i + 1, live) for i in range(sq))
        else:
            pairs += sq * live
    b = len(lives)
    n_bytes = b * ((2 * sq * h * d + 2 * sk * kvh * d) * 2 + sk * 4)
    return n_bytes, 4.0 * d * h * pairs


def shapes(dev, gen) -> dict:
    """name -> (q, k, v, mask, causal, q_offset, sdpa mask, work)."""
    cfg = get_config("qwen2.5-vl-7b")
    t, vc = cfg.text, cfg.vision
    page = torch.from_numpy(build_vision_layout(plan_image(1288, 994),
                                                vc).valid).to(dev)
    s_vis = page.numel()

    def case(b, sq, sk, h, kvh, d, lives, causal, q_off=0, vision=False):
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, sk, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, sk, kvh, d), generator=gen, device=dev).bfloat16()
        mask = torch.zeros((b, sk), device=dev)
        for i, live in enumerate(lives):
            if vision and live is None:
                mask[i] = page
            elif vision:
                idx = torch.randperm(sk, generator=gen, device=dev)
                mask[i, idx[:live]] = 1.0
            else:
                mask[i, :live] = 1.0
        sdpa = (mask > 0)[:, None, None, :]
        if causal:
            sdpa = sdpa & torch.ones((sq, sk), dtype=torch.bool, device=dev
                                     ).tril(diagonal=q_off)[None, None]
        counts = [int(x) for x in mask.sum(-1).tolist()]
        return (q, k, v, mask, causal, q_off, sdpa,
                flash_work(sq, sk, h, kvh, d, counts, causal, q_off))

    th, tk, td = t.num_heads, t.num_kv_heads, t.head_dim
    out = {
        "prefill": lambda: case(1, 1408, 1408, th, tk, td, [1390], True),
        "vision": lambda: case(1, s_vis, s_vis, vc.num_heads, vc.num_heads,
                               vc.head_dim, [None], False, vision=True),
        "prefix": lambda: case(1, SUFFIX_BUCKET, PREFIX_LEN + SUFFIX_BUCKET,
                               th, tk, td, [PREFIX_LEN + SUFFIX_LEN], True,
                               PREFIX_LEN),
        "vision_batched": lambda: case(
            4, s_vis, s_vis, vc.num_heads, vc.num_heads, vc.head_dim,
            list(BATCHED_VISION_LIVE), False, vision=True),
        "prefill_batched": lambda: case(4, 1408, 1408, th, tk, td,
                                        list(BATCHED_PREFILL_LIVE), True),
    }
    for tp in (2, 4):
        vh, h, kvh = vc.num_heads // tp, th // tp, tk // tp
        out[f"vision_tp{tp}"] = (lambda vh=vh: case(
            1, s_vis, s_vis, vh, vh, vc.head_dim, [None], False,
            vision=True))
        out[f"prefill_tp{tp}"] = (lambda h=h, kvh=kvh: case(
            1, 1408, 1408, h, kvh, td, [1390], True))
        out[f"prefix_tp{tp}"] = (lambda h=h, kvh=kvh: case(
            1, SUFFIX_BUCKET, PREFIX_LEN + SUFFIX_BUCKET, h, kvh, td,
            [PREFIX_LEN + SUFFIX_LEN], True, PREFIX_LEN))
    t3 = get_config("qwen2.5-vl-3b").text
    for h, kvh in ((t3.num_heads, t3.num_kv_heads),
                   (t3.num_heads // 2, t3.num_kv_heads // 2)):
        for q_off in (0, SP_Q):
            out[f"sp_h{h}_q{q_off}"] = (lambda h=h, kvh=kvh, q_off=q_off: case(
                1, SP_Q, SP_K, h, kvh, t3.head_dim, [SP_LIVE], True, q_off))
    return out


# kernel #3: the 7B decode step over one layer of the int8 cache
DECODE_M, DECODE_D, DECODE_G, DECODE_KVH = 1920, 128, 7, 4
DECODE_SMOKE_LENS = [0, 700, 1919, 1390]
DECODE_RANK_LENS = [0, 700, 1390, 1915]
DECODE_AB_FILL = 1650
# the run rule of #3's earlier bf16 instance (decode_split.cuh's int8 body,
# since deleted; a baseline built from an older csrc still has it):
# runs of 256 to 1,024 rows, two blocks an SM
SPLIT_RULE = (256, 1024, 2)


def decode_work(b: int, kvh: int, h: int, d: int, lens: list) -> int:
    """Bytes kernel #3 must move in one call: each live cache row's K and V
    bytes and their two bf16 scales read once, the new rows and scales read
    and written, q read and the output written."""
    live = sum(lens)
    return (kvh * live * (d + 2) * 2 + b * kvh * (d + 2) * 2 * 2
            + 2 * b * h * d * 2)


def decode_shapes() -> dict:
    """name -> (B, KVH, lengths); the ragged lengths from a seed."""
    gen = torch.Generator().manual_seed(5)

    def ragged(b):
        return sorted(torch.randint(0, DECODE_M - 1, (b,),
                                    generator=gen).tolist())

    return {"b4": (4, DECODE_KVH, DECODE_SMOKE_LENS),
            "b16": (16, DECODE_KVH, ragged(16)),
            "b32": (32, DECODE_KVH, ragged(32)),
            "b80": (80, DECODE_KVH, [DECODE_AB_FILL] * 80),
            "tp2": (4, DECODE_KVH // 2, DECODE_RANK_LENS),
            "tp4": (4, DECODE_KVH // 4, DECODE_RANK_LENS)}


def decode_case(b: int, kvh: int, lens: list, gen: torch.Generator):
    """Kernel #3's inputs over a two-layer 7B cache (int8 rows, bf16 scales)
    and the plain version's output and caches at layer 1."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows
    from karanta_tpu_torch.ops import decode_attention as DA

    dev, d = torch.device("cuda"), DECODE_D

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    kq, ks = quantize_kv_rows(rows((2, b, kvh, DECODE_M, d)))
    vq, vs = quantize_kv_rows(rows((2, b, kvh, DECODE_M, d)))
    nkq, nks = quantize_kv_rows(rows((b, kvh, d)))
    nvq, nvs = quantize_kv_rows(rows((b, kvh, d)))
    q = rows((b, 1, kvh * DECODE_G, d)).bfloat16()
    new = (nkq, nvq, nks.bfloat16(), nvs.bfloat16())
    caches = [kq, vq, ks.bfloat16(), vs.bfloat16()]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want_caches = [c.clone() for c in caches]
    want = DA.paged_decode_append_quant_plain(q, *new, *want_caches, 1,
                                              lens_t)
    return q, new, caches, lens_t, want, want_caches


def decode_launcher(fn, q, new, caches, lens_t, run: int):
    """One call of a #3 C entry `fn` with `run` rows over copies of the
    caches: (call, output, the copies). The partials have room for the
    records of either Hopper body (#3's own, or the verify body's at
    T = 1)."""
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.ops import decode_attention as DA

    b, _, h, d = q.shape
    kvh = caches[0].shape[2]
    partials, counters = DA._split_workspace(
        q, b * kvh, -(-DECODE_M // run), DA.MULTI_PARTIAL_ROWS)
    out = torch.empty_like(q)
    work = [c.clone() for c in caches]
    # the call holds the tensors: the pointers alone would not keep them
    tensors = (q, *new, *work, lens_t, out, partials, counters)
    args = [kernels.ptr(x) for x in tensors]

    def call(tensors=tensors):
        kernels.raise_on_error("#3", fn(
            *args, b, kvh, h // kvh, DECODE_M, d, 1, run, d ** -0.5,
            kernels.DTYPE_CODES[torch.bfloat16],
            kernels.stream_ptr(q.device)))

    return call, out, work


def decode_ab(others: dict, wanted: list, smi: str) -> dict:
    """Kernel #3 from this tree and from each baseline library, in turns."""
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.ops import decode_attention as DA

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    d, g = DECODE_D, DECODE_G
    info_this = DA.paged_decode_append_quant_info(d, g)
    print(f"  this tree bf16 #3: {info_this}", flush=True)
    # per source: its entry, its most runs a slot, and its blocks per SM
    # when it is this kernel's design (else None: the split body's rule)
    trees = {"this": (DA._decode_fns()[0], info_this["max_runs"],
                      info_this["blocks_per_sm"])}
    for name, lib in others.items():
        fn = lib.karanta_decode_append_quant
        fn.restype = ctypes.c_int
        fn.argtypes = DECODE_ARGTYPES
        info_fn = lib.karanta_decode_append_quant_info
        info_fn.restype = ctypes.c_int
        info_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        buf = (ctypes.c_int * 16)()
        kernels.raise_on_error("decode_append_quant_info", info_fn(d, g, buf))
        print(f"  {name} bf16 #3: registers {buf[0]}, spills {buf[1]}, "
              f"shared {buf[2]}, blocks/SM {buf[3]}, max runs {buf[4]}, "
              f"rows a chunk {buf[5]}", flush=True)
        trees[name] = (fn, buf[4], buf[3] if buf[5] else None)
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (b, kvh, lens) in decode_shapes().items():
        if wanted and name not in wanted:
            continue
        q, new, caches, lens_t, want, want_caches = decode_case(b, kvh, lens,
                                                                gen)
        n_bytes = decode_work(b, kvh, kvh * g, d, lens)
        bound = n_bytes / PEAK_BYTES * 1e3
        row = {"batch": b, "kv_heads": kvh, "live_rows": sum(lens),
               "bound_ms": bound, "ms": {}, "worst": {}, "run_rows": {}}
        for tree in order:
            fn, max_runs, per_sm = trees[tree]
            if per_sm is not None:
                run = DA.quant_run_rows(b, kvh, DECODE_M, per_sm * n_sm,
                                        max_runs)
            else:
                lo, hi, split_per_sm = SPLIT_RULE
                run = split_run_rows(b, kvh, DECODE_M, n_sm, lo, hi,
                                     max_runs, blocks_per_sm=split_per_sm)
            row["run_rows"][tree] = run
            call, out, work = decode_launcher(fn, q, new, caches, lens_t, run)
            call()
            torch.cuda.synchronize()
            for x, y, part in zip(work, want_caches, ("k", "v", "ks", "vs")):
                if not torch.equal(x, y):
                    raise AssertionError(f"#3 {name} {tree}: cache {part} "
                                         f"differs from the plain version")
            row["worst"].setdefault(tree, []).append(check_bf16(out, want))
            row["ms"].setdefault(tree, []).append(graph_ms(call))
            del work
        for tree, times in row["ms"].items():
            best = min(times)
            print(f"  #3 {name} B={b} KVH={kvh} ({sum(lens)} live rows) "
                  f"{tree}: {', '.join(f'{x:.4f}' for x in times)} ms "
                  f"(runs of {row['run_rows'][tree]}); bound {bound:.4f} ms, "
                  f"{100 * bound / best:.1f}% of it, "
                  f"{n_bytes / best * 1e-6:.0f} GB/s; worst err/limit "
                  f"{max(row['worst'][tree]):.3f}", flush=True)
        results[name] = row
        del q, new, caches, want_caches
        torch.cuda.empty_cache()
    return {"card": smi, "decode_quant_bf16": results,
            "resources": info_this}


# kernels #4 and #7: one layer of the 7B verify pass over the int8 or int4
# cache (chip_smoke.py's shapes); #6: one layer of the 7B decode step over
# the int4 cache, on #7's body at T = 1
VERIFY_D, VERIFY_G, VERIFY_KVH, VERIFY_T, VERIFY_M = 128, 7, 4, 4, 4096
VERIFY_SOURCES = {"4": "decode_append_multi_quant",
                  "7": "decode_append_multi_q4", "6": "decode_append_q4"}
VERIFY_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# the run rules of the split bodies that the Hopper body replaced
# (verify_split.cuh for #4 and #7, decode_split.cuh for #6): runs of lo to
# hi rows (#4) or tokens (#7, #6), at most that many live blocks an SM at
# half-full slots
SPLIT_VERIFY_RULES = {"4": (256, 1024, 0.5), "7": (256, 2048, 0.5),
                      "6": (256, 1024, 1)}


def split_run_rows(b: int, kvh: int, m: int, n_sm: int, lo: int, hi: int,
                   max_runs: int, blocks_per_sm: float = 0.5) -> int:
    """The run-length rule of the split bodies, for their libraries timed as
    baselines: the shortest run of cache rows (or tokens), a power of two
    from lo to hi, that gives at most blocks_per_sm live blocks an SM when
    the B slots of KVH kv heads are half full (B * KVH * ceil(M / 2 / run)
    blocks); longer if a slot would otherwise have more than max_runs runs
    (what the last block can merge)."""
    run = lo
    while run < hi and b * kvh * -(-m // (2 * run)) > blocks_per_sm * n_sm:
        run *= 2
    while -(-m // run) > max_runs:
        run *= 2
    return run


def verify_argtypes(kernel: str) -> list:
    """The C entry's argument types: #6's takes no T (the decode kernels'
    signature)."""
    return DECODE_ARGTYPES if kernel == "6" else VERIFY_ARGTYPES


def verify_shapes(kernel: str) -> dict:
    """name -> (B, KVH, T, M tokens, lengths); ragged lengths from the
    smoke's seeds."""
    if kernel == "6":
        return q4_decode_shapes()
    m, tq = VERIFY_M, VERIFY_T

    def ragged(b, seed):
        rng = np.random.default_rng(seed)
        return [0, m - tq - 1] + sorted(int(x) for x in rng.integers(
            1, m - tq - 1, b - 2))

    smoke = [0, 1700, 2100, m - tq - 1]
    out = {"b4": (4, VERIFY_KVH, tq, m, smoke)}
    if kernel == "4":
        out["b32"] = (32, VERIFY_KVH, tq, m, ragged(32, 11))
        out["b80"] = (80, VERIFY_KVH, tq, DECODE_M, [DECODE_AB_FILL] * 80)
        out["t2"] = (4, VERIFY_KVH, 2, m, [0, 1700, 2100, m - 3])
        rank_m = DECODE_M
    else:
        out["b8"] = (8, VERIFY_KVH, tq, m, ragged(8, 13))
        rank_m = 2048
    rank = [0, 700, 1390, rank_m - tq - 1]
    for tp in (2, 4):
        out[f"tp{tp}"] = (4, VERIFY_KVH // tp, tq, rank_m, rank)
    return out


def q4_decode_shapes() -> dict:
    """#6's shapes (T = 1): the smoke's B = 4 over 2,048 tokens and B = 8
    over 4,096 with its ragged lengths (seed 17, chip_smoke.py kernel_q4),
    one rank's kv heads (its per-rank rows), and B = 32 and 80 ragged over
    4,096 tokens."""
    def ragged(b, m, seed):
        rng = np.random.default_rng(seed)
        return [0, m - 1] + sorted(int(x) for x in rng.integers(1, m - 1,
                                                                 b - 2))

    out = {"b4": (4, VERIFY_KVH, 1, 2048, [0, 700, 1919, 1390]),
           "b8": (8, VERIFY_KVH, 1, VERIFY_M, ragged(8, VERIFY_M, 17))}
    for tp in (2, 4):
        out[f"tp{tp}"] = (4, VERIFY_KVH // tp, 1, 2048, [0, 700, 1390, 2043])
    for b, seed in ((32, 19), (80, 23)):
        out[f"b{b}"] = (b, VERIFY_KVH, 1, VERIFY_M, ragged(b, VERIFY_M, seed))
    return out


def verify_case(kernel: str, b: int, kvh: int, tq: int, m: int, lens: list,
                gen: torch.Generator):
    """#4's, #7's or #6's inputs over a two-layer 7B cache (bf16 scales) and
    the plain version's output and caches at layer 1."""
    from karanta_tpu_torch.models.qwen25_vl.decoder import (
        q4_pack_prefill, quantize_kv_rows, quantize_kv_rows_q4)
    from karanta_tpu_torch.ops import decode_attention as DA

    dev, d = torch.device("cuda"), VERIFY_D

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    quant = quantize_kv_rows if kernel == "4" else quantize_kv_rows_q4
    lead = (b,) if kernel == "6" else (b, tq)
    nkq, nks = quant(rows(lead + (kvh, d)))
    nvq, nvs = quant(rows(lead + (kvh, d)))
    q = rows((b, tq, kvh * VERIFY_G, d)).bfloat16()
    new = (nkq, nvq, nks.bfloat16(), nvs.bfloat16())
    if kernel == "4":
        kq, ks = quantize_kv_rows(rows((2, b, kvh, m, d)))
        vq, vs = quantize_kv_rows(rows((2, b, kvh, m, d)))
        caches = [kq, vq, ks, vs]
        plain = DA.paged_decode_append_multi_quant_plain
    else:
        caches = list(q4_pack_prefill(rows((2, b, kvh, m, d)),
                                      rows((2, b, kvh, m, d))))
        plain = (DA.paged_decode_append_q4_plain if kernel == "6"
                 else DA.paged_decode_append_multi_q4_plain)
    caches[2], caches[3] = caches[2].bfloat16(), caches[3].bfloat16()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want_caches = [c.clone() for c in caches]
    want = plain(q, *new, *want_caches, 1, lens_t)
    return q, new, caches, lens_t, want, want_caches


def verify_launcher(kernel: str, fn, q, new, caches, lens_t, run: int):
    """One call of a #4, #7 or #6 C entry `fn` with runs of `run` rows (#4)
    or tokens (#7, #6) over copies of the caches: (call, output, the
    copies)."""
    from karanta_tpu_torch import kernels
    from karanta_tpu_torch.ops import decode_attention as DA

    b, tq, h, d = q.shape
    kvh, stored = caches[0].shape[2], caches[0].shape[3]
    tokens = stored * (1 if kernel == "4" else 2)
    partials, counters = DA._split_workspace(
        q, b * kvh, -(-tokens // run), DA.MULTI_PARTIAL_ROWS)
    out = torch.empty_like(q)
    work = [c.clone() for c in caches]
    # the call holds the tensors: the pointers alone would not keep them
    tensors = (q, *new, *work, lens_t, out, partials, counters)
    args = [kernels.ptr(x) for x in tensors]

    shape = ((b, kvh, h // kvh, stored, d) if kernel == "6"
             else (b, tq, kvh, h // kvh, stored, d))

    def call(tensors=tensors):
        kernels.raise_on_error(f"#{kernel}", fn(
            *args, *shape, 1, run, d ** -0.5,
            kernels.DTYPE_CODES[torch.bfloat16],
            kernels.stream_ptr(q.device)))

    return call, out, work


def verify_info(lib, kernel: str, nq: int) -> list:
    """The first 8 entries of a library's #4, #7 or #6 info at (D, nq): a
    split body's library fills 5 (no rows a chunk)."""
    from karanta_tpu_torch import kernels

    name = f"karanta_{VERIFY_SOURCES[kernel]}_info"
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    buf = (ctypes.c_int * 16)()
    kernels.raise_on_error(name, fn(VERIFY_D, nq, buf))
    return list(buf[:10])


def verify_run(kernel: str, info: list, b: int, kvh: int, m: int,
               n_sm: int) -> int:
    """A library's run rule from its own info: the resident-run rule of the
    Hopper body where it reports rows a chunk, else the split body's."""
    from karanta_tpu_torch.ops import decode_attention as DA

    if info[5]:
        rule = {"4": DA.multi_quant_run_rows, "7": DA.multi_q4_run_tokens,
                "6": DA.q4_run_tokens}[kernel]
        return rule(b, kvh, m, info[3] * n_sm, info[4])
    lo, hi, per_sm = SPLIT_VERIFY_RULES[kernel]
    return split_run_rows(b, kvh, m, n_sm, lo, hi, info[4],
                          blocks_per_sm=per_sm)


def verify_ab(kernel: str, others: dict, wanted: list, smi: str) -> dict:
    """Kernel #4, #7 or #6 from this tree and from each baseline library, in
    turns."""
    from karanta_tpu_torch.kernels import build as kbuild

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    source = VERIFY_SOURCES[kernel]
    entry = "karanta_" + source
    libs = {"this": kbuild.library(source), **others}
    fns = {}
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = verify_argtypes(kernel)
        fns[name] = fn
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device=dev).manual_seed(0)
    results, resources = {}, {}
    for name, (b, kvh, tq, m, lens) in verify_shapes(kernel).items():
        if wanted and name not in wanted:
            continue
        nq = VERIFY_G * tq
        infos = {tree: verify_info(libs[tree], kernel, nq) for tree in libs}
        for tree, info in infos.items():
            if (tree, nq) not in resources:
                resources[(tree, nq)] = info
                print(f"  {tree} bf16 #{kernel} NQ={nq}: registers {info[0]}, "
                      f"spills {info[1]}, shared {info[2]}, blocks/SM "
                      f"{info[3]}, max runs {info[4]}, rows a chunk "
                      f"{info[5]}, stages {info[6]}, consumer warps "
                      f"{info[7]}", flush=True)
        q, new, caches, lens_t, want, want_caches = verify_case(
            kernel, b, kvh, tq, m, lens, gen)
        n_bytes = verify_work(b, kvh, kvh * VERIFY_G, VERIFY_D, tq, lens,
                              8 if kernel == "4" else 4)
        bound = n_bytes / PEAK_BYTES * 1e3
        row = {"batch": b, "kv_heads": kvh, "tokens": tq, "m": m,
               "live_tokens": sum(lens), "bound_ms": bound, "ms": {},
               "worst": {}, "run": {}}
        for tree in order:
            run = verify_run(kernel, infos[tree], b, kvh, m, n_sm)
            row["run"][tree] = run
            call, out, work = verify_launcher(kernel, fns[tree], q, new,
                                              caches, lens_t, run)
            call()
            torch.cuda.synchronize()
            for x, y, part in zip(work, want_caches, ("k", "v", "ks", "vs")):
                if not torch.equal(x, y):
                    raise AssertionError(f"#{kernel} {name} {tree}: cache "
                                         f"{part} differs from the plain "
                                         f"version")
            row["worst"].setdefault(tree, []).append(check_bf16(out, want))
            row["ms"].setdefault(tree, []).append(graph_ms(call))
            del work
        for tree, times in row["ms"].items():
            best = min(times)
            print(f"  #{kernel} {name} B={b} KVH={kvh} T={tq} M={m} "
                  f"({sum(lens)} live tokens) {tree}: "
                  f"{', '.join(f'{x:.4f}' for x in times)} ms (runs of "
                  f"{row['run'][tree]}); bound {bound:.4f} ms, "
                  f"{100 * bound / best:.1f}% of it, "
                  f"{n_bytes / best * 1e-6:.0f} GB/s; worst err/limit "
                  f"{max(row['worst'][tree]):.3f}", flush=True)
        results[name] = row
        del q, new, caches, want_caches
        torch.cuda.empty_cache()
    return {"card": smi, f"verify_{kernel}_bf16": results,
            "resources": {f"{tree} NQ={nq}": info
                          for (tree, nq), info in resources.items()}}


# kernel #1: the 7B vision tower's window layers over the bench page
WINDOW_D, WINDOW_H, WINDOW_W = 80, 16, 64
# name -> (pages concatenated, heads, rope)
WINDOW_SHAPES = {"page": (1, WINDOW_H, True), "page_norope": (1, WINDOW_H, False),
                 "pages4": (4, WINDOW_H, True), "tp2": (1, WINDOW_H // 2, True),
                 "tp4": (1, WINDOW_H // 4, True)}
WINDOW_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def window_work(b: int, s: int, h: int, d: int, w: int, lives, rope: bool):
    """Bytes #1 must move in one call (q, k and v read and the output
    written once, cos/sin read once with rope, the mask) and the flops of
    its (query, live key) pairs (4 D H a pair: every query of a window with
    each live key of its window; a window with no live key has none).
    lives: the (b, s) kv mask, or None where every key is live."""
    if lives is None:
        live = np.full((b * s // w,), w)
    else:
        live = (np.asarray(lives, dtype=np.float64).reshape(b * s // w, w)
                > 0).sum(-1)
    pairs = int(w * live.sum())
    n_bytes = (4 * b * s * h * d * 2 + (2 * b * s * d * 4 if rope else 0)
               + (b * s * 4 if lives is not None else 0))
    return n_bytes, 4.0 * d * h * pairs


def window_case(pages: int, h: int, rope: bool, gen: torch.Generator):
    """#1's inputs over `pages` concatenated bench pages (each with its valid
    mask and rope, cos/sin rounded through bf16 as the tower holds them),
    the plain version's output and the rows whose window has a live key."""
    from karanta_tpu_torch.ops.rotary import vision_rope_cos_sin

    dev = torch.device("cuda")
    layout = build_vision_layout(plan_image(1288, 994),
                                 get_config("qwen2.5-vl-7b").vision)
    s = pages * len(layout.valid)
    q, k, v = (torch.randn((1, s, h, WINDOW_D), generator=gen, device=dev)
               .bfloat16() for _ in range(3))
    mask = torch.from_numpy(np.concatenate([layout.valid] * pages)).to(dev)
    mask = mask.float()[None].contiguous()
    cos = sin = None
    if rope:
        pos = torch.from_numpy(np.concatenate([layout.pos_hw] * pages)).to(dev)
        cos, sin = vision_rope_cos_sin(pos, WINDOW_D)
        cos = cos.bfloat16().float()[None].contiguous()
        sin = sin.bfloat16().float()[None].contiguous()
    want = A.window_attention_plain(q, k, v, WINDOW_W, mask, cos=cos, sin=sin)
    rows = (mask.reshape(1, s // WINDOW_W, WINDOW_W).amax(-1) > 0
            ).repeat_interleave(WINDOW_W, 1)
    return q, k, v, mask, cos, sin, want, rows


def window_launcher(fn, q, k, v, mask, cos, sin):
    """One call of a #1 C entry `fn` at W = 64: (call, output)."""
    from karanta_tpu_torch import kernels

    b, s, h, d = q.shape
    out = torch.empty_like(q)
    # the call holds the tensors: the pointers alone would not keep them
    tensors = (q, k, v, mask, cos, sin, out)
    args = [kernels.ptr(x) for x in tensors]

    def call(tensors=tensors):
        kernels.raise_on_error("#1", fn(
            *args, b, s, h, d, WINDOW_W, d ** -0.5,
            kernels.DTYPE_CODES[torch.bfloat16], kernels.stream_ptr(q.device)))

    return call, out


def window_info(lib) -> list:
    """A library's #1 info at (80, 64): 10 entries (the Hopper body), 5 from
    PR 6's body (registers, spills, shared bytes, blocks an SM, heads a
    block), the rest 0."""
    from karanta_tpu_torch import kernels

    fn = lib.karanta_window_attention_info
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    buf = (ctypes.c_int * 16)()
    kernels.raise_on_error("window_attention_info",
                           fn(WINDOW_D, WINDOW_W, buf))
    return list(buf[:10])


def window_ab(others: dict, wanted: list, smi: str) -> dict:
    """Kernel #1 from this tree and from each baseline library, in turns,
    beside SDPA over the windows."""
    from karanta_tpu_torch.ops.rotary import apply_rope

    libs = {"this": build.library("window_attention"), **others}
    fns, resources = {}, {}
    for name, lib in libs.items():
        fn = lib.karanta_window_attention
        fn.restype = ctypes.c_int
        fn.argtypes = WINDOW_ARGTYPES
        fns[name] = fn
        resources[name] = window_info(lib)
        print(f"  {name} bf16 #1 (80, 64): {resources[name]}", flush=True)
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    results = {}
    for name, (pages, h, rope) in WINDOW_SHAPES.items():
        if wanted and name not in wanted:
            continue
        q, k, v, mask, cos, sin, want, rows = window_case(pages, h, rope, gen)
        b, s, _, d = q.shape
        n_bytes, flops = window_work(b, s, h, d, WINDOW_W, mask.cpu().numpy(),
                                     rope)
        bound = max(n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
        qr, kr = apply_rope(q, k, cos, sin) if rope else (q, k)
        qw, kw, vw = (x.reshape(s // WINDOW_W, WINDOW_W, h, d).transpose(1, 2)
                      .contiguous() for x in (qr, kr, v))
        mw = mask.reshape(s // WINDOW_W, 1, 1, WINDOW_W) > 0

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qw, kw, vw, attn_mask=mw)

        row = {"shape": list(q.shape), "rope": rope, "bound_ms": bound,
               "bytes": n_bytes, "flops": flops, "ms": {}, "worst": {}}
        for tree in order:
            call, out = window_launcher(fns[tree], q, k, v, mask, cos, sin)
            call()
            torch.cuda.synchronize()
            row["worst"].setdefault(tree, []).append(
                check_bf16(out[rows], want[rows]))
            row["ms"].setdefault(tree, []).append(graph_ms(call))
        row["sdpa_ms"] = graph_ms(sdpa)
        for tree, times in row["ms"].items():
            best = min(times)
            print(f"  #1 {name} {tuple(q.shape)} rope={rope} {tree}: "
                  f"{', '.join(f'{x:.4f}' for x in times)} ms; bound "
                  f"{bound:.4f} ms, {100 * bound / best:.1f}% of it; SDPA "
                  f"{row['sdpa_ms']:.4f} ms, {best / row['sdpa_ms']:.2f}x; "
                  f"worst err/limit {max(row['worst'][tree]):.3f}",
                  flush=True)
        results[name] = row
        del q, k, v, mask, cos, sin, want, qw, kw, vw
        torch.cuda.empty_cache()
    return {"card": smi, "window_bf16": results, "resources": resources}


def check_bf16(got, want) -> float:
    """Worst |got - want| over the bf16 limit; raises above 1."""
    got, want = got.float(), want.float()
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -9 * float(want.abs().max())
    worst = float(((got - want).abs() / limit).max())
    if not torch.isfinite(got).all() or not worst <= 1.0:
        raise AssertionError(f"error {worst:.3g}x the bf16 limit")
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", type=Path, action="append", default=[],
                        help="a csrc directory whose kernel is timed in "
                             "turns with this tree's (repeatable)")
    parser.add_argument("--only", default="",
                        help="comma-separated shape names (default: all)")
    parser.add_argument("--kernel", choices=("1", "2", "3", "4", "7", "6"),
                        default="2",
                        help="1: the window kernel, 2: the flash kernel "
                             "(default), 3: the int8 decode kernel, 4 / 7: "
                             "the int8 / int4 verify kernel, 6: the int4 "
                             "decode kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}", flush=True)
    wanted = [x for x in args.only.split(",") if x]
    if args.kernel == "1":
        result = window_ab(
            baseline_libs(args.baseline, "window_attention"), wanted, smi)
        print(json.dumps(result), flush=True)
        return 0
    if args.kernel == "3":
        result = decode_ab(
            baseline_libs(args.baseline, "decode_append_quant"), wanted, smi)
        print(json.dumps(result), flush=True)
        return 0
    if args.kernel in VERIFY_SOURCES:
        result = verify_ab(args.kernel, baseline_libs(
            args.baseline, VERIFY_SOURCES[args.kernel]), wanted, smi)
        print(json.dumps(result), flush=True)
        return 0
    this = A._flash_fn()
    others = baseline_fns(args.baseline)
    fns = {"this": this, **others}
    # in turns: each baseline, this tree twice, the baselines in reverse
    order = [*others, "this", "this", *reversed(others)]
    for d in sorted(set(A.FLASH_HEAD_DIMS)):
        print(f"  this tree bf16 D={d}: {A.flash_attention_info(d)}",
              flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, make in shapes(dev, gen).items():
        if wanted and name not in wanted:
            continue
        q, k, v, mask, causal, q_off, sdpa_mask, (n_bytes, flops) = make()
        want = A.flash_attention_plain(q, k, v, mask, causal=causal,
                                       q_offset=q_off)
        bound = max(n_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = q.shape[2] != k.shape[2]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=gqa)

        row = {"shape": list(q.shape), "kv": list(k.shape), "causal": causal,
               "q_offset": q_off, "bound_ms": bound, "ms": {}, "worst": {}}
        for tree in order:
            A._flash_fn = (lambda fn=fns[tree]: fn)
            call = (lambda: A.flash_attention(q, k, v, mask, causal=causal,
                                              q_offset=q_off))
            got = call()
            torch.cuda.synchronize()
            row["worst"].setdefault(tree, []).append(check_bf16(got, want))
            row["ms"].setdefault(tree, []).append(graph_ms(call))
        A._flash_fn = (lambda fn=this: fn)
        row["sdpa_ms"] = graph_ms(sdpa)
        for tree, times in row["ms"].items():
            best = min(times)
            print(f"  {name} {tuple(q.shape)} kv {tuple(k.shape)} {tree}: "
                  f"{', '.join(f'{x:.4f}' for x in times)} ms; bound "
                  f"{bound:.4f} ms, {100 * bound / best:.1f}% of it; SDPA "
                  f"{row['sdpa_ms']:.4f} ms, {best / row['sdpa_ms']:.2f}x; "
                  f"worst err/limit {max(row['worst'][tree]):.3f}",
                  flush=True)
        results[name] = row
        del q, k, v, mask, want, qt, kt, vt, sdpa_mask
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "flash_bf16": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
