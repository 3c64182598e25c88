"""Run-length sweep of the int8 verify kernel's bf16 instance (kernel #4,
``ops/decode_attention.py paged_decode_append_multi_quant``) on the card.

    python -m karanta_tpu_torch.bench.verify_runs
    python -m karanta_tpu_torch.bench.verify_runs --batches 4,32 --runs 256,1024

At the Qwen2.5-VL-7B verify shape (D = 128, G = 7, T = 4, KVH = 4, a
4,096-row int8 cache) and each batch size, the kernel runs with each run
length through its C entry, is checked against the plain version (the bf16
rule), and is timed on the device: 20 calls captured in a CUDA graph and
replayed, so the wrapper's host time is left out. Batch 4 takes the smoke's
lengths (0, 1700, 2100, 4091); the others ragged lengths from a seed. One
line per batch with the time per run length and the length the wrapper's
rule picks, then one JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from karanta_tpu_torch import kernels
from karanta_tpu_torch.models.qwen25_vl.decoder import quantize_kv_rows
from karanta_tpu_torch.ops import decode_attention as DA

D, G, T, KVH, M = 128, 7, 4, 4, 4096
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


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


def sweep(b: int, lens: list, runs: list, gen: torch.Generator) -> dict:
    dev = torch.device("cuda")

    def rows(shape):
        return torch.randn(shape, generator=gen, device=dev)

    kq, ks = quantize_kv_rows(rows((2, b, KVH, M, D)))
    vq, vs = quantize_kv_rows(rows((2, b, KVH, M, D)))
    nkq, nks = quantize_kv_rows(rows((b, T, KVH, D)))
    nvq, nvs = quantize_kv_rows(rows((b, T, KVH, D)))
    q = rows((b, T, KVH * G, D)).bfloat16()
    new = (nkq, nvq, nks.bfloat16(), nvs.bfloat16())
    caches = [kq, vq, ks.bfloat16(), vs.bfloat16()]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = DA.paged_decode_append_multi_quant_plain(
        q, *new, *[c.clone() for c in caches], 1, lens_t).float()
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -9 * want.abs().max()
    fn, _ = DA._multi_fns()
    out = torch.empty_like(q)
    times = {}
    for run in runs:
        partials, counters = DA._split_workspace(
            q, b * KVH, -(-M // run), DA.MULTI_PARTIAL_ROWS)
        args = [kernels.ptr(x) for x in (q, *new, *caches, lens_t, out,
                                          partials, counters)]

        def call():
            kernels.raise_on_error("verify_runs", fn(
                *args, b, T, KVH, G, M, D, 1, run, D ** -0.5,
                kernels.DTYPE_CODES[torch.bfloat16],
                kernels.stream_ptr(dev)))

        call()
        torch.cuda.synchronize()
        worst = float(((out.float() - want).abs() / limit).max())
        if not worst <= 1.0:
            raise AssertionError(f"B={b}, runs of {run}: error {worst:.3g}x "
                                 f"the bf16 limit")
        times[run] = graph_ms(call)
    n_bytes = (KVH * sum(lens) * (D + 2) * 2 + b * T * KVH * (D + 2) * 4
               + 2 * b * T * KVH * G * D * 2)
    info = DA.paged_decode_append_multi_quant_info(D, G * T, b, KVH, M)
    return {"batch": b, "live_rows": sum(lens), "device_ms": times,
            "bound_ms": n_bytes / PEAK_BYTES * 1e3,
            "rule_run_rows": info["run_rows"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", default="1,4,8,32,64")
    parser.add_argument("--runs", default="256,512,1024,2048")
    parser.add_argument("--seed", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("verify_runs: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    runs = [int(x) for x in args.runs.split(",")]
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = []
    for b in (int(x) for x in args.batches.split(",")):
        lens = ([0, 1700, 2100, M - T - 1] if b == 4 else
                sorted(int(x) for x in rng.integers(0, M - T - 1, b)))
        r = sweep(b, lens, runs, gen)
        results.append(r)
        print(f"B={b} ({r['live_rows']} live rows, bound "
              f"{r['bound_ms']:.4f} ms): " + ", ".join(
                  f"runs of {k}: {v:.4f} ms" for k, v in
                  r["device_ms"].items())
              + f"; the rule picks {r['rule_run_rows']}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
