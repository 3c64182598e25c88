"""Per-phase timer trace and A/B of the decode weight streams (kernels #10
``dense_stream`` and #11 ``decode_megakernel``, ``ops/decode_stream.py``)
on the card.

    python -m karanta_tpu_torch.bench.stream_trace
    python -m karanta_tpu_torch.bench.stream_trace --csrc DIR --batches 80
    python -m karanta_tpu_torch.bench.stream_trace --baseline OLD/csrc
    python -m karanta_tpu_torch.bench.stream_trace --repeat 9
    python -m karanta_tpu_torch.bench.stream_trace --json trace.json

An instrumented copy of ``decode_stream.cu`` (from ``kernels/csrc`` or DIR,
a copy of it) is built into ``kernels/build/trace-<hash>/``: thread 0 of
every block stamps ``%globaltimer`` as the block starts, as it reaches and
as it leaves each grid barrier, and as it ends; the product phases' producer
lane sums the time it waits for a free ring stage, and the consumers' first
thread the time it waits for a stage to land. One call's stamps give, per
phase summed over the layers, the wall time from the first block's release
to the last block's arrival at the next barrier, the mean time a block
works in it, the barriers' release time (last arrival to first release),
and the two waits (a producer that waits for free stages is held by the
consumers' issue, consumers that wait for stages by the bytes). The
wrappers' checks run unchanged: ``dense_stream_on`` and
``decode_megakernel_on`` launch through the instrumented library's entries.
The stamps cost a little, so a stream's device time is the port's own
kernel's, by CUDA events over 20 chained calls (a call runs for
milliseconds, far longer than the host takes to issue the next).

With ``--baseline DIR`` the ``decode_stream.cu`` of another ``csrc``
directory (an earlier commit's) is built as it is, and both entries of
both libraries are timed in turns at each batch: the baseline, this tree
twice, the baseline again; beside them the cuBLAS yardstick (the same 28
layers' products as 140 bf16 matrix products over weights dequantized
beforehand, ``cublas_products``), the bytes bound (``stream_work`` at 3.35
TB/s) and each body's share of it. Outputs of the two libraries are held
to each other normwise (2e-2).

With ``--repeat N`` each body is called N times on the same inputs at each
batch, and the line says how many of the later calls' outputs (x, and the
caches the megakernel appends in place) differ in a bit from the first's.

At the Qwen2.5-VL-7B shapes (random int8 weights; B = 4 with the ragged
lengths that ``chip_smoke.py`` shares from here, B = 80 and 128 filled to
1,650 of 1,920 rows) it prints one line per kernel and batch, and with
``--json PATH`` writes the numbers there. Needs a CUDA device.
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
HBM_BYTES_PER_S = 3.35e12
_STAMPS = """__device__ unsigned long long karanta_trace_buf[1024 * %(n)d];
__device__ int karanta_trace_n[1024];
__device__ unsigned long long karanta_trace_wait[1024 * 2];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void trace_stamp() {
  const unsigned long long t = trace_now();
  const int i = karanta_trace_n[blockIdx.x]++;
  if (i < %(n)d) karanta_trace_buf[blockIdx.x * %(n)d + i] = t;
}
""" % {"n": MAX_EVENTS}
_EXPORTS = """
extern "C" int karanta_trace_reset() {
  static int zeros[1024];
  static unsigned long long wzeros[2048];
  cudaError_t e = cudaMemcpyToSymbol(karanta::karanta_trace_n, zeros, sizeof(zeros));
  if (e == cudaSuccess) {
    e = cudaMemcpyToSymbol(karanta::karanta_trace_wait, wzeros, sizeof(wzeros));
  }
  return (int)e;
}
extern "C" int karanta_trace_read(unsigned long long* buf, int* counts,
                                  unsigned long long* waits) {
  cudaError_t e = cudaMemcpyFromSymbol(buf, karanta::karanta_trace_buf,
                                       sizeof(unsigned long long) * 1024 * %d);
  if (e == cudaSuccess) {
    e = cudaMemcpyFromSymbol(counts, karanta::karanta_trace_n, sizeof(int) * 1024);
  }
  if (e == cudaSuccess) {
    e = cudaMemcpyFromSymbol(waits, karanta::karanta_trace_wait,
                             sizeof(unsigned long long) * 2048);
  }
  return (int)e;
}
""" % MAX_EVENTS
# the phases between barriers of one layer, by entry (a call starts with
# "start", the counters zeroed and layer 0's first weights prefetched, and
# "prologue", x0's rows and layer 0's norm, and ends with the last layer's
# down rows). "rows": the split-K records finished into the residual, each
# row normalised by the warp that completes it.
PHASES = {"dense_stream": ("qkv+o products", "qkv and o rows + norm2",
                           "gate/up products", "down products",
                           "down rows + norm1"),
          "decode_megakernel": ("qkv products", "qkv finish", "attention",
                                "o products", "o rows + norm2",
                                "gate/up products", "down products",
                                "down rows + norm1")}
# the waits the instrumented copy times: (function, slot, who times it)
_WAITS = (("wait_free", 0, "true"), ("wait_landed", 1, "threadIdx.x == 0"))


def instrument(src: str) -> str:
    """decode_stream.cu with the stamps: in grid_sync after its first block
    barrier and before its last, at the kernel's start and end; and the
    product phases' two ring waits timed."""
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
    for name, slot, who in _WAITS:
        out, n = re.subn(
            r"(__device__ __forceinline__ void %s\(uint64_t\* bar, uint32_t parity\) "
            r"\{\n)  mbar_wait\(bar, parity\);\n" % name,
            r"\1  const unsigned long long t0 = trace_now();\n"
            r"  mbar_wait(bar, parity);\n"
            r"  if (%s) karanta_trace_wait[2 * blockIdx.x + %d] += trace_now() - t0;\n"
            % (who, slot), out, count=1)
        if n != 1:
            raise ValueError(f"stream_trace: {name} not found")
    out, n = re.subn(r"(stream_kernel\(const __grid_constant__ StreamMaps maps, "
                     r"const __grid_constant__ StreamArgs a\) \{\n)",
                     r"\1  if (threadIdx.x == 0) trace_stamp();\n", out, count=1)
    if n != 1:
        raise ValueError("stream_trace: stream_kernel not found")
    out, n = re.subn(r"\n\}  // stream_kernel\n",
                     "\n  __syncthreads();\n  if (threadIdx.x == 0) trace_stamp();\n"
                     "}  // stream_kernel\n", out, count=1)
    if n != 1:
        raise ValueError("stream_trace: the kernel's end not found")
    return out + _EXPORTS


def _build(src: str, csrc: Path, tag: str, name: str) -> ctypes.CDLL:
    """Build (once per source) and load `src` beside csrc's headers."""
    digest = hashlib.sha1(src.encode() + " ".join(build.NVCC_FLAGS).encode())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out_dir = build.BUILD_DIR / f"{tag}-{digest.hexdigest()[:12]}"
    lib = out_dir / f"lib{name}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (out_dir / header.name).write_bytes(header.read_bytes())
        (out_dir / f"{name}.cu").write_text(src)
        tmp = lib.with_suffix(".tmp")
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                               str(out_dir / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"stream_trace: nvcc failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))


def build_traced(csrc: Path | None = None) -> ctypes.CDLL:
    """Build (once per source) and load the instrumented library."""
    csrc = Path(csrc or build.CSRC)
    src = instrument((csrc / "decode_stream.cu").read_text())
    return _build(src, csrc, "trace", "decode_stream_trace")


def build_baseline(csrc: Path) -> ctypes.CDLL:
    """Build (once per source) and load another csrc's decode_stream.cu as
    it is."""
    csrc = Path(csrc)
    return _build((csrc / "decode_stream.cu").read_text(), csrc, "stream",
                  "decode_stream")


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


def dequantized_layers(layers: dict, n_layers: int) -> list:
    """Each layer's seven int8 weights dequantized to bf16, out-major (the
    cuBLAS yardstick's operands: x @ W.T)."""
    return [[layers[g][n]["int8_q"][i].t().to(torch.bfloat16)
             for g, n in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                          ("attn", "wo"), ("mlp", "gate"), ("mlp", "up"),
                          ("mlp", "down"))] for i in range(n_layers)]


def cublas_products(w16: list, x, attn0, h_mid):
    """The yardstick: the same layers' products as 7 bf16 matrix products a
    layer (x, the attention output and an (B, FF) h as inputs)."""
    def run():
        for ws in w16:
            for w in ws[:3]:
                x @ w.t()
            attn0 @ ws[3].t()
            x @ ws[4].t()
            x @ ws[5].t()
            h_mid @ ws[6].t()
    return run


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


def analyse(stamps: list, n_layers: int, name: str, waits=None) -> dict:
    """Per-phase times (ms, summed over layers) from each block's stamps:
    start, (arrive, leave) per barrier, end; the barriers end "start",
    "prologue" and then the entry's phases a layer but the last. waits:
    each block's (producer, consumer) ring waits in ns."""
    names = PHASES[name]
    order = ["start", "prologue"] + list(names) * n_layers
    n = len(stamps[0])
    if any(len(s) != n for s in stamps) or (n - 2) % 2:
        raise ValueError("stream_trace: blocks stamped unequal counts")
    n_bar = (n - 2) // 2
    if n_bar != len(order) - 1:
        raise ValueError(f"stream_trace: {n_bar} barriers, not "
                         f"{len(order) - 1} for {len(names)} phases a layer "
                         f"of {n_layers}")
    grid = len(stamps)
    phase = dict.fromkeys(("start", "prologue") + names, 0.0)
    busy = dict(phase)
    release = 0.0
    prev = [s[0] for s in stamps]
    for j, k in enumerate(order):
        arrive = ([s[1 + 2 * j] for s in stamps] if j < n_bar
                  else [s[-1] for s in stamps])
        phase[k] += (max(arrive) - min(prev)) * 1e-6
        busy[k] += sum(a - p for a, p in zip(arrive, prev)) / grid * 1e-6
        if j < n_bar:
            leave = [s[2 + 2 * j] for s in stamps]
            release += (min(leave) - max(arrive)) * 1e-6
            prev = leave
    out = {"total_ms": (max(s[-1] for s in stamps)
                        - min(s[0] for s in stamps)) * 1e-6,
           "phase_ms": phase, "mean_block_busy_ms": busy,
           "barrier_release_ms": release, "barriers": n_bar, "grid": grid}
    if waits is not None:
        products = sum(v for k, v in busy.items() if "products" in k)
        for i, who in enumerate(("producer_wait_free_ms",
                                 "consumer_wait_landed_ms")):
            out[who] = sum(w[i] for w in waits) / grid * 1e-6
            out[who.replace("_ms", "_share")] = (out[who] / products
                                                 if products else 0.0)
    return out


def trace_call(lib: ctypes.CDLL, call, name: str, n_layers: int) -> dict:
    """Run call(fns) (a stream's call from ``stream_calls``) once on the
    instrumented library and return its analysis."""
    fns = DS.stream_fns(lib)
    buf = (ctypes.c_ulonglong * (1024 * MAX_EVENTS))()
    counts = (ctypes.c_int * 1024)()
    waits = (ctypes.c_ulonglong * 2048)()
    call(fns)
    torch.cuda.synchronize()
    if lib.karanta_trace_reset() != 0:
        raise RuntimeError("stream_trace: reset failed")
    call(fns)
    torch.cuda.synchronize()
    if lib.karanta_trace_read(buf, counts, waits) != 0:
        raise RuntimeError("stream_trace: read failed")
    grid = sum(1 for c in counts if c > 0)
    if any(c > MAX_EVENTS for c in counts[:grid]):
        raise ValueError("stream_trace: more stamps than MAX_EVENTS")
    stamps = [list(buf[b * MAX_EVENTS:b * MAX_EVENTS + counts[b]])
              for b in range(grid)]
    return analyse(stamps, n_layers, name,
                   [(waits[2 * b], waits[2 * b + 1]) for b in range(grid)])


def line(label: str, res: dict) -> str:
    """One line: total, each phase, the barriers' release, the waits."""
    text = (f"{label}: {res['total_ms']:.3f} ms traced; "
            + ", ".join(f"{k} {v:.3f}" for k, v in res["phase_ms"].items())
            + f", barrier release {res['barrier_release_ms']:.3f} "
              f"({res['barriers']} barriers); mean block busy "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        res["mean_block_busy_ms"].items()))
    if "producer_wait_free_ms" in res:
        text += (f"; producer waits for a free stage "
                 f"{res['producer_wait_free_ms']:.3f} ms "
                 f"({100 * res['producer_wait_free_share']:.1f}% of the "
                 f"products), consumers wait for a stage "
                 f"{res['consumer_wait_landed_ms']:.3f} ms "
                 f"({100 * res['consumer_wait_landed_share']:.1f}%)")
    return text


def calls_differ(fn, n: int) -> int:
    """How many of calls 2..n of fn() return outputs that differ in a bit
    from the first call's."""
    first = [t.clone() for t in fn()]
    return sum(any(not torch.equal(a, b) for a, b in zip(first, fn()))
               for _ in range(n - 1))


def _normwise(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def main(argv=None) -> int:
    from karanta_tpu_torch.bench.randweights import init_params_bench
    from karanta_tpu_torch.models.qwen25_vl.config import get_config

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", default=None,
                        help="a copy of kernels/csrc to trace instead")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another csrc whose decode_stream.cu is timed "
                             "in turns with this tree's")
    parser.add_argument("--batches", default="4,80,128")
    parser.add_argument("--repeat", type=int, default=0,
                        help="call each body this many times and count the "
                             "calls whose outputs differ from the first's")
    parser.add_argument("--json", default=None,
                        help="write the per-phase numbers to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stream_trace: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build_traced(args.csrc)
    base = (DS.stream_fns(build_baseline(args.baseline))
            if args.baseline else None)
    dev = torch.device("cuda")
    cfg = get_config("qwen2.5-vl-7b")
    t = cfg.text
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = init_params_bench(cfg, torch.bfloat16, "int8", device=dev)
    layers = params["text"]["layers"]
    sp = DS.pack_stream_params(layers)
    w16 = dequantized_layers(layers, t.num_layers) if base else None
    del params, layers
    torch.cuda.empty_cache()
    qd, kvd = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    fns = DS.stream_fns(lib)
    out = {}
    for b in (int(x) for x in args.batches.split(",")):
        lens = STREAM_CHECK_LENS if b == 4 else [AB_FILL] * b
        inputs = stream_inputs(cfg, dev, gen, b, lens)
        calls = stream_calls(sp, *inputs, qd, kvd)
        if base is not None:
            # the yardstick before and after the streams' turns
            x, attn = inputs[0], inputs[5]
            h_mid = (torch.randn((b, t.intermediate_size), generator=gen,
                                 device=dev) * 0.3).bfloat16()
            yard = cublas_products(w16, x, attn[0], h_mid)
            cublas = [events_ms(yard, 5)]
        for name, call in calls.items():
            res = trace_call(lib, call, name, t.num_layers)
            res["events_ms"] = events_ms(lambda: call(None))
            res["instrumented_events_ms"] = events_ms(lambda: call(fns))
            n_bytes, flops = stream_work(cfg, b, lens,
                                         mega=name == "decode_megakernel")
            res["bound_ms"] = max(n_bytes / HBM_BYTES_PER_S,
                                  flops / 989e12) * 1e3
            if base is not None:
                got, want = call(None)[0], call(base)[0]
                res["vs_baseline_normwise"] = _normwise(got, want)
                turns = {"baseline": [], "tree": []}
                for who in ("baseline", "tree", "tree", "baseline"):
                    turns[who].append(events_ms(
                        lambda: call(None if who == "tree" else base)))
                res["turns_ms"] = turns
                res["events_ms"] = min(turns["tree"])
            if args.repeat > 1:
                res["repeat_differ"] = {"tree": calls_differ(
                    lambda: call(None), args.repeat)}
                if base is not None:
                    res["repeat_differ"]["baseline"] = calls_differ(
                        lambda: call(base), args.repeat)
                print(f"  {name} B={b}: of {args.repeat - 1} calls after the "
                      f"first, differing in a bit: {res['repeat_differ']}",
                      flush=True)
            res["bound_share"] = res["bound_ms"] / res["events_ms"]
            res["gb_per_s"] = n_bytes / res["events_ms"] * 1e-6
            out[f"{name} B={b}"] = res
            print(line(f"{name} B={b} ({res['events_ms']:.4f} ms by events, "
                       f"{100 * res['bound_share']:.1f}% of the "
                       f"{res['bound_ms']:.4f} ms bound, "
                       f"{res['gb_per_s']:.0f} GB/s; instrumented "
                       f"{res['instrumented_events_ms']:.3f})", res),
                  flush=True)
            if base is not None:
                print(f"  {name} B={b} in turns: this tree "
                      f"{res['turns_ms']['tree']}, baseline "
                      f"{res['turns_ms']['baseline']} ms; outputs "
                      f"{res['vs_baseline_normwise']:.2e} apart normwise",
                      flush=True)
        if base is not None:
            cublas.append(events_ms(yard, 5))
            ms = min(cublas)
            for name in calls:
                out[f"{name} B={b}"]["cublas_ms"] = ms
                out[f"{name} B={b}"]["cublas_turns_ms"] = cublas
            dense = out[f"dense_stream B={b}"]
            print(f"  cuBLAS yardstick B={b}: {cublas} ms (140 bf16 "
                  f"products, before and after the streams); dense_stream "
                  f"/ cuBLAS {dense['events_ms'] / ms:.3f}", flush=True)
            del h_mid, yard
        del inputs, calls
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
