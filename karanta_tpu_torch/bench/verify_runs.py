"""Run-length sweep of the persistent decode kernels over the quantized
caches on the card: the bf16 instances of the int8 verify kernel (#4,
``ops/decode_attention.py paged_decode_append_multi_quant``), the int4
verify kernel (#7, ``paged_decode_append_multi_q4``), the int8 decode
kernel (#3, ``paged_decode_append_quant``) and the int4 decode kernel (#6,
``paged_decode_append_q4``).

    python -m karanta_tpu_torch.bench.verify_runs
    python -m karanta_tpu_torch.bench.verify_runs --kernel 7
    python -m karanta_tpu_torch.bench.verify_runs --kernel 3 --batches 4,80
    python -m karanta_tpu_torch.bench.verify_runs --kernel 6
    python -m karanta_tpu_torch.bench.verify_runs --kernel 4 --smoke-shapes

At the Qwen2.5-VL-7B shapes (D = 128, G = 7, KVH = 4; #4 and #7: T = 4
over a 4,096-token cache; #3: one row over the engine's 1,920-row cache;
#6: one token over the served int4 point's 4,096-token cache) and each
batch size, the kernel runs with each run length (rows for #4 and #3,
tokens for #7 and #6) through its C entry, is checked against the plain
version (the bf16 rule), and is timed on the device: 20 calls captured in a
CUDA graph and replayed, so the wrapper's host time is left out. Batch 4
takes the smoke's lengths; #3 and #4 at batch 80 fill every slot to 1,650
rows (the decode A/B point's fill); the others take ragged lengths from a
seed. With --smoke-shapes, #4, #7 and #6 run instead at the shapes that
``chip_smoke.py`` and ``bench.flash_ab`` time (``flash_ab.verify_shapes``:
the smoke's B = 4 and ragged B = 32 (#4) or B = 8 (#7, #6) lengths over
4,096 tokens (#6: B = 4 over 2,048, and B = 32 and 80 ragged), #4 at B = 80
filled to 1,650 of 1,920 rows and at T = 2, and one rank's kv heads at tp =
2 and 4). A run length a kernel does not take (#4: not a multiple of 128
rows; #7 and #6: of 128 tokens) fails its call. One line
per shape with the time per run length and the length the wrapper's rule
picks, then one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.models.qwen25_vl.decoder import (q4_pack_prefill,
                                                        quantize_kv_rows,
                                                        quantize_kv_rows_q4)
from karanta_tpu_torch.ops import decode_attention as DA

D, G, KVH = 128, 7, 4
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# per kernel: cache tokens, fresh tokens per slot, default batches and runs
SHAPES = {"4": (4096, 4, "1,4,8,32,64,80", "256,512,1024,2048"),
          "7": (4096, 4, "1,4,8,32,64", "256,512,1024,2048,4096"),
          "3": (1920, 1, "4,16,32,80", "128,256,512,1024"),
          "6": (4096, 1, "1,4,8,32,64", "256,512,1024,2048,4096")}
SMOKE_LENS = {"4": [0, 1700, 2100, 4091], "7": [0, 1700, 2100, 4091],
              "3": [0, 700, 1919, 1390], "6": [0, 700, 1919, 1390]}
AB_FILL = 1650  # #3 and #4 at batch 80: the decode A/B point's fill


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call from a CUDA graph of `calls` calls."""
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
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def q4_live_rows(n: int) -> int:
    """Packed int4 rows that hold a token below n."""
    return (n // 64) * 32 + min(n % 64, 32)


def verify_work(b: int, kvh: int, h: int, d: int, tq: int, lens: list,
                bits: int) -> int:
    """Bytes kernel #4 (bits 8) or #7 (bits 4) must move in one call: each
    live stored row's K and V bytes and each live token's two bf16 scales
    read once, the T fresh rows and scales read and written (int4: their
    bytes), q read and the output written."""
    if bits == 8:
        old = kvh * sum(lens) * (d + 2) * 2
    else:
        old = sum(kvh * (q4_live_rows(n) * d * 2 + n * 4) for n in lens)
    return old + b * tq * kvh * (d + 2) * 4 + 2 * b * tq * h * d * 2


def case(kernel: str, b: int, kvh: int, tq: int, m: int, lens: list,
         gen: torch.Generator):
    """Inputs, the plain version's output, the C entry, its argument tail
    for one run length, the rule's pick and the bytes bound of one call, at
    B slots, KVH kv heads, T fresh tokens and M cache tokens."""
    dev = torch.device("cuda")

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    lead = (b,) if tq == 1 else (b, tq)
    quant = quantize_kv_rows_q4 if kernel in "67" else quantize_kv_rows
    nkq, nks = quant(rows(lead + (kvh, D)))
    nvq, nvs = quant(rows(lead + (kvh, D)))
    q = rows((b, tq, kvh * G, D)).bfloat16()
    new = (nkq, nvq, nks.bfloat16(), nvs.bfloat16())
    if kernel in "67":
        caches = list(q4_pack_prefill(rows((2, b, kvh, m, D)),
                                      rows((2, b, kvh, m, D))))
    else:
        kq, ks = quantize_kv_rows(rows((2, b, kvh, m, D)))
        vq, vs = quantize_kv_rows(rows((2, b, kvh, m, D)))
        caches = [kq, vq, ks, vs]
    caches[2], caches[3] = caches[2].bfloat16(), caches[3].bfloat16()
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    plain = {"4": DA.paged_decode_append_multi_quant_plain,
             "7": DA.paged_decode_append_multi_q4_plain,
             "3": DA.paged_decode_append_quant_plain,
             "6": DA.paged_decode_append_q4_plain}[kernel]
    want = plain(q, *new, *[c.clone() for c in caches], 1, lens_t).float()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if kernel == "4":
        fn = DA._multi_fns()[0]
        info = DA.paged_decode_append_multi_quant_info(D, G * tq)
        max_runs = info["max_runs"]
        rule = DA.multi_quant_run_rows(b, kvh, m, info["blocks_per_sm"] * n_sm,
                                       max_runs)

        def tail(run):
            return (b, tq, kvh, G, m, D, 1, run)
        n_bytes = verify_work(b, kvh, kvh * G, D, tq, lens, 8)
    elif kernel == "7":
        fn = DA._multi_q4_fns()[0]
        info = DA.paged_decode_append_multi_q4_info(D, G * tq)
        max_runs = info["max_runs"]
        rule = DA.multi_q4_run_tokens(b, kvh, m, info["blocks_per_sm"] * n_sm,
                                      max_runs)

        def tail(run):
            return (b, tq, kvh, G, m // 2, D, 1, run)
        n_bytes = verify_work(b, kvh, kvh * G, D, tq, lens, 4)
    elif kernel == "6":
        fn = DA._q4_fns()[0]
        info = DA.paged_decode_append_q4_info(D, G)
        max_runs = info["max_runs"]
        rule = DA.q4_run_tokens(b, kvh, m, info["blocks_per_sm"] * n_sm,
                                max_runs)

        def tail(run):
            return (b, kvh, G, m // 2, D, 1, run)
        n_bytes = (sum(kvh * (q4_live_rows(n) * D * 2 + n * 4) for n in lens)
                   + b * kvh * (D * 2 + 4) * 2 + 2 * b * kvh * G * D * 2)
    else:
        fn = DA._decode_fns()[0]
        info = DA.paged_decode_append_quant_info(D, G)
        max_runs = info["max_runs"]
        rule = DA.quant_run_rows(b, kvh, m, info["blocks_per_sm"] * n_sm,
                                 max_runs)

        def tail(run):
            return (b, kvh, G, m, D, 1, run)
        n_bytes = (kvh * sum(lens) * (D + 2) * 2 + b * kvh * (D + 2) * 4
                   + 2 * b * kvh * G * D * 2)
    return (q, new, caches, lens_t, want, fn, tail, rule, max_runs,
            n_bytes / PEAK_BYTES * 1e3)


def sweep(kernel: str, b: int, kvh: int, tq: int, m: int, lens: list,
          runs: list, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    (q, new, caches, lens_t, want, fn, tail, rule, max_runs,
     bound) = case(kernel, b, kvh, tq, m, lens, gen)
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -9 * want.abs().max()
    rows = DA.SPLIT_PARTIAL_ROWS if kernel == "3" else DA.MULTI_PARTIAL_ROWS
    out = torch.empty_like(q)
    times = {}
    for run in runs:
        if -(-m // run) > max_runs:
            continue  # more runs than the last block can merge
        partials, counters = DA._split_workspace(q, b * kvh, -(-m // run),
                                                 rows)
        args = [kernels.ptr(x) for x in (q, *new, *caches, lens_t, out,
                                          partials, counters)]

        def call():
            kernels.raise_on_error("verify_runs", fn(
                *args, *tail(run), D ** -0.5,
                kernels.DTYPE_CODES[torch.bfloat16],
                kernels.stream_ptr(dev)))

        call()
        torch.cuda.synchronize()
        worst = float(((out.float() - want).abs() / limit).max())
        if not worst <= 1.0:
            raise AssertionError(f"kernel #{kernel}, B={b}, runs of {run}: "
                                 f"error {worst:.3g}x the bf16 limit")
        times[run] = graph_ms(call)
    return {"kernel": int(kernel), "batch": b, "kv_heads": kvh,
            "tokens": tq, "m": m, "live_tokens": sum(lens),
            "device_ms": times, "bound_ms": bound, "rule_run": rule}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=sorted(SHAPES), default="4",
                        help="4: int8 verify, 7: int4 verify, 3: int8 "
                             "decode, 6: int4 decode (default 4)")
    parser.add_argument("--batches", default=None)
    parser.add_argument("--runs", default=None,
                        help="run lengths: rows (#4, #3) or tokens (#7, "
                             "#6)")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--smoke-shapes", action="store_true",
                        help="#4, #7 and #6: the smoke's and flash_ab's "
                             "shapes in place of the batch sweep")
    args = parser.parse_args(argv)
    if args.smoke_shapes and args.kernel == "3":
        parser.error("--smoke-shapes takes --kernel 4, 7 or 6")
    if not torch.cuda.is_available():
        raise SystemExit("verify_runs: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    m, tq, batches, runs = SHAPES[args.kernel]
    runs = [int(x) for x in (args.runs or runs).split(",")]
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.smoke_shapes:
        from karanta_tpu_torch.bench.flash_ab import verify_shapes
        shapes = list(verify_shapes(args.kernel).items())
    else:
        shapes = []
        for b in (int(x) for x in (args.batches or batches).split(",")):
            top = m - tq - 1 if tq > 1 else m - 1
            if b == 4:
                lens = SMOKE_LENS[args.kernel]
            elif args.kernel in "34" and b == 80:
                lens = [AB_FILL] * b
            else:
                lens = sorted(int(x) for x in rng.integers(0, top, b))
            shapes.append((f"b{b}", (b, KVH, tq, m, lens)))
    results = []
    for name, (b, kvh, tq_, m_, lens) in shapes:
        r = sweep(args.kernel, b, kvh, tq_, m_, lens, runs, gen)
        results.append({"shape": name, **r})
        print(f"#{args.kernel} {name} B={b} KVH={kvh} T={tq_} M={m_} "
              f"({r['live_tokens']} live tokens, bound "
              f"{r['bound_ms']:.4f} ms): " + ", ".join(
                  f"runs of {k}: {v:.4f} ms" for k, v in
                  r["device_ms"].items())
              + f"; the rule picks {r['rule_run']}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
