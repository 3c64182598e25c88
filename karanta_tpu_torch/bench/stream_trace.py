"""Per-phase timer trace of the decode weight streams (kernels #10
``dense_stream`` and #11 ``decode_megakernel``, ``ops/decode_stream.py``)
on the card.

    python -m karanta_tpu_torch.bench.stream_trace
    python -m karanta_tpu_torch.bench.stream_trace --csrc DIR --batches 80
    python -m karanta_tpu_torch.bench.stream_trace --json trace.json

An instrumented copy of ``decode_stream.cu`` (from ``kernels/csrc`` or DIR,
a copy of it) is built into ``kernels/build/trace-<hash>/``: thread 0 of
every block stamps ``%globaltimer`` as the block starts, as it reaches and
as it leaves each grid barrier, and as it ends. One call's stamps give, per
phase summed over the layers, the wall time from the first block's release
to the last block's arrival at the next barrier, the mean time a block
works in it, and the barriers' release time (last arrival to first
release). The wrappers' checks run unchanged: ``dense_stream_on`` and
``decode_megakernel_on`` launch through the instrumented library's entries.
The stamps cost a little, so a stream's device time is the port's own
kernel's, by CUDA events over chained calls (a call runs for milliseconds,
far longer than the host takes to issue the next). At the Qwen2.5-VL-7B
shapes that ``chip_smoke.py`` shares from here (random int8 weights, B = 4
with ragged lengths and B = 80 filled to 1,650 of 1,920 rows) it prints one
line per kernel and batch, and with ``--json PATH`` writes the numbers
there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

from karanta_tpu_torch.kernels import build
from karanta_tpu_torch.ops import decode_stream as DS
from karanta_tpu_torch.ops.rotary import mrope_cos_sin

# the JAX package's decode A/B point: the 1920-row bucket filled to 1650
# rows (at 80 slots), and the ragged lengths of the B = 4 check
AB_BUCKET, AB_FILL = 1920, 1650
STREAM_CHECK_LENS = [0, 33, 1390, AB_BUCKET - 1]
MAX_EVENTS = 512  # stamps per block
_STAMPS = """__device__ unsigned long long karanta_trace_buf[1024 * %(n)d];
__device__ int karanta_trace_n[1024];
__device__ __forceinline__ void trace_stamp() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  const int i = karanta_trace_n[blockIdx.x]++;
  if (i < %(n)d) karanta_trace_buf[blockIdx.x * %(n)d + i] = t;
}
""" % {"n": MAX_EVENTS}
_EXPORTS = """
extern "C" int karanta_trace_reset() {
  static int zeros[1024];
  return (int)cudaMemcpyToSymbol(karanta::karanta_trace_n, zeros, sizeof(zeros));
}
extern "C" int karanta_trace_read(unsigned long long* buf, int* counts) {
  cudaError_t e = cudaMemcpyFromSymbol(buf, karanta::karanta_trace_buf,
                                       sizeof(unsigned long long) * 1024 * %d);
  if (e == cudaSuccess) {
    e = cudaMemcpyFromSymbol(counts, karanta::karanta_trace_n, sizeof(int) * 1024);
  }
  return (int)e;
}
""" % MAX_EVENTS
# phases between barriers, one layer, by barriers per layer
PHASES = {5: ("rows in", "qkv+o products", "rows mid", "gate/up products",
              "down products"),
          7: ("rows in", "qkv products", "attention", "o products",
              "rows mid", "gate/up products", "down products")}


def instrument(src: str) -> str:
    """decode_stream.cu with the stamps: in grid_sync after its first block
    barrier and before its last, at the kernel's start and after its final
    row phase."""
    def stamped(m):
        body = m.group(0)
        body = body.replace("  if (threadIdx.x == 0) {\n",
                            "  if (threadIdx.x == 0) {\n    trace_stamp();\n", 1)
        head, tail = body.rsplit("    __threadfence();\n  }\n", 1)
        return (_STAMPS + head
                + "    __threadfence();\n    trace_stamp();\n  }\n" + tail)

    out, n = re.subn(r"__device__ __forceinline__ void grid_sync\(unsigned\* bar\) "
                     r"\{.*?\n\}\n", stamped, src, count=1, flags=re.S)
    if n != 1:
        raise ValueError("stream_trace: grid_sync not found")
    out, n = re.subn(r"(stream_kernel\(StreamArgs a\) \{\n)",
                     r"\1  if (threadIdx.x == 0) trace_stamp();\n", out, count=1)
    if n != 1:
        raise ValueError("stream_trace: stream_kernel not found")
    out, n = re.subn(r"(\n  row_in\(a, a\.L, smem\);\n)",
                     r"\1  __syncthreads();\n  if (threadIdx.x == 0) trace_stamp();\n",
                     out, count=1)
    if n != 1:
        raise ValueError("stream_trace: the final row phase not found")
    return out + _EXPORTS


def build_traced(csrc: Path | None = None) -> ctypes.CDLL:
    """Build (once per source) and load the instrumented library."""
    csrc = Path(csrc or build.CSRC)
    src = instrument((csrc / "decode_stream.cu").read_text())
    digest = hashlib.sha1(src.encode() + " ".join(build.NVCC_FLAGS).encode())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out_dir = build.BUILD_DIR / f"trace-{digest.hexdigest()[:12]}"
    lib = out_dir / "libdecode_stream_trace.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (out_dir / header.name).write_bytes(header.read_bytes())
        (out_dir / "decode_stream_trace.cu").write_text(src)
        tmp = lib.with_suffix(".tmp")
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                               str(out_dir / "decode_stream_trace.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"stream_trace: nvcc failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))


def stream_inputs(cfg, dev, gen, b: int, lens):
    """x (B, H) bf16, cos/sin (B, D) at positions lens, an int8 cache of
    AB_BUCKET rows (random bytes, scales in [0.002, 0.022)), lens, and the
    per-layer attention outputs (L, B, H) bf16 that #10 takes."""
    t = cfg.text
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    cos, sin = mrope_cos_sin(lens_t[None].expand(3, b), t.head_dim,
                             t.mrope_section, t.rope_theta)
    x = (torch.randn((b, t.hidden_size), generator=gen, device=dev)
         * 0.3).bfloat16()
    shape = (t.num_layers, b, t.num_kv_heads, AB_BUCKET, t.head_dim)
    caches = [torch.randint(-127, 128, shape, generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2)]
    caches += [(torch.rand(shape[:-1], generator=gen, device=dev) * 0.02
                + 0.002).bfloat16() for _ in range(2)]
    attn = (torch.randn((t.num_layers, b, t.hidden_size), generator=gen,
                        device=dev) * 0.3).bfloat16()
    return x, cos.contiguous(), sin.contiguous(), caches, lens_t, attn


def stream_calls(sp, x, cos, sin, caches, lens_t, attn, qd: int,
                 kvd: int) -> dict:
    """Each stream's call on these inputs, as a function of the ``fns`` to
    launch through (``DS.dense_stream_on``; None for the port's own
    kernel)."""
    return {"dense_stream": lambda fns: DS.dense_stream_on(fns, x, attn, sp),
            "decode_megakernel": lambda fns: DS.decode_megakernel_on(
                fns, x, cos, sin, sp, *caches, lens_t, qd, kvd)}


def events_ms(fn, iters: int = 20) -> float:
    """Mean ms of fn() over iters chained calls, by CUDA events, after two
    warm-up calls."""
    for _ in range(2):
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


def analyse(stamps: list, n_layers: int) -> dict:
    """Per-phase times (ms, summed over layers) from each block's stamps:
    start, (arrive, leave) per barrier, end."""
    n = len(stamps[0])
    if any(len(s) != n for s in stamps) or (n - 2) % 2:
        raise ValueError("stream_trace: blocks stamped unequal counts")
    n_bar = (n - 2) // 2
    per_layer = n_bar // n_layers
    names = PHASES.get(per_layer, tuple(f"phase {i}" for i in range(per_layer)))
    grid = len(stamps)
    phase = dict.fromkeys(names, 0.0)
    busy = dict.fromkeys(names, 0.0)
    release = 0.0
    prev = [s[0] for s in stamps]
    for j in range(n_bar):
        arrive = [s[1 + 2 * j] for s in stamps]
        leave = [s[2 + 2 * j] for s in stamps]
        k = names[j % per_layer]
        phase[k] += (max(arrive) - min(prev)) * 1e-6
        busy[k] += sum(a - p for a, p in zip(arrive, prev)) / grid * 1e-6
        release += (min(leave) - max(arrive)) * 1e-6
        prev = leave
    end = max(s[-1] for s in stamps)
    return {"total_ms": (end - min(s[0] for s in stamps)) * 1e-6,
            "phase_ms": phase, "mean_block_busy_ms": busy,
            "barrier_release_ms": release, "barriers": n_bar,
            "final_rows_ms": (end - min(prev)) * 1e-6, "grid": grid}


def trace_call(lib: ctypes.CDLL, call, n_layers: int) -> dict:
    """Run call(fns) (a stream's call from ``stream_calls``) once on the
    instrumented library and return its analysis."""
    fns = DS.stream_fns(lib)
    buf = (ctypes.c_ulonglong * (1024 * MAX_EVENTS))()
    counts = (ctypes.c_int * 1024)()
    call(fns)
    torch.cuda.synchronize()
    if lib.karanta_trace_reset() != 0:
        raise RuntimeError("stream_trace: reset failed")
    call(fns)
    torch.cuda.synchronize()
    if lib.karanta_trace_read(buf, counts) != 0:
        raise RuntimeError("stream_trace: read failed")
    grid = sum(1 for c in counts if c > 0)
    if any(c > MAX_EVENTS for c in counts[:grid]):
        raise ValueError("stream_trace: more stamps than MAX_EVENTS")
    stamps = [list(buf[b * MAX_EVENTS:b * MAX_EVENTS + counts[b]])
              for b in range(grid)]
    return analyse(stamps, n_layers)


def line(label: str, res: dict) -> str:
    """One line: total, each phase, the barriers' release."""
    return (f"{label}: {res['total_ms']:.3f} ms traced; "
            + ", ".join(f"{k} {v:.3f}" for k, v in res["phase_ms"].items())
            + f", barrier release {res['barrier_release_ms']:.3f} "
              f"({res['barriers']} barriers); mean block busy "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        res["mean_block_busy_ms"].items()))


def main(argv=None) -> int:
    from karanta_tpu_torch.bench.randweights import init_params_bench
    from karanta_tpu_torch.models.qwen25_vl.config import get_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", default=None,
                        help="a copy of kernels/csrc to trace instead")
    parser.add_argument("--batches", default="4,80")
    parser.add_argument("--json", default=None,
                        help="write the per-phase numbers to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_trace: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build_traced(args.csrc)
    dev = torch.device("cuda")
    cfg = get_config("qwen2.5-vl-7b")
    t = cfg.text
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = init_params_bench(cfg, torch.bfloat16, "int8", device=dev)
    sp = DS.pack_stream_params(params["text"]["layers"])
    del params
    torch.cuda.empty_cache()
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    fns = DS.stream_fns(lib)
    out = {}
    for b in (int(x) for x in args.batches.split(",")):
        lens = STREAM_CHECK_LENS if b == 4 else [AB_FILL] * b
        inputs = stream_inputs(cfg, dev, gen, b, lens)
        for name, call in stream_calls(sp, *inputs, qd, kvd).items():
            res = trace_call(lib, call, t.num_layers)
            res["events_ms"] = events_ms(lambda: call(None))
            res["instrumented_events_ms"] = events_ms(lambda: call(fns))
            out[f"{name} B={b}"] = res
            print(line(f"{name} B={b} ({res['events_ms']:.3f} ms by events; "
                       f"instrumented {res['instrumented_events_ms']:.3f})",
                       res), flush=True)
        del inputs
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
