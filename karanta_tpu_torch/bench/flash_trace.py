"""Per-phase cycle trace of kernel #2's bf16 instance (``ops/attention.py
flash_attention``, ``kernels/csrc/flash_attention.cu``) on the card.

    python -m karanta_tpu_torch.bench.flash_trace
    python -m karanta_tpu_torch.bench.flash_trace --csrc DIR --only vision

An instrumented copy of ``flash_attention.cu`` (from ``kernels/csrc`` or
DIR, a copy of it) is built into ``kernels/build/ftrace-<hash>/``: every
consumer thread reads ``clock64`` at the end of each phase of its key-tile
loop and adds the cycles since its last reading to that phase; thread 0 of
each consumer warpgroup stores its sums. The phases of one loop iteration:
waiting for the K tile, waiting for the warpgroup's turn (the named
barrier), issuing Q.K^T and rescaling O, waiting for the V tile, issuing
P.V, waiting for the scores, the softmax (with the mask, and freeing the K
stage), waiting for P.V, and rounding P; beside them the first tile before
the loop, and the last P.V and the stores after it. At ``flash_ab``'s
shapes it prints each phase's share of all consumer cycles, summed over
the blocks, and the cycles per key tile. The readings cost a little, so
times come from ``flash_ab``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from karanta_tpu_torch.bench.flash_ab import shapes
from karanta_tpu_torch.kernels import build
from karanta_tpu_torch.ops import attention as A

PHASES = ("wait K", "wait turn", "issue QK + rescale O", "wait V", "issue PV",
          "wait S", "softmax", "wait PV", "round P", "first tile", "last PV + store")
MAX_SLOTS = 2 * 16384  # consumer warpgroups traced (two a block)
_DEFS = """namespace karanta {
__device__ unsigned long long karanta_ftrace[%(slots)d * %(n)d];
}
#define FT_STAMP(k) { const unsigned long long ft_now = clock64(); ft[k] += ft_now - ft_last; ft_last = ft_now; }
""" % {"slots": MAX_SLOTS, "n": len(PHASES)}
_EXPORTS = """
extern "C" int karanta_ftrace_reset() {
  static unsigned long long zeros[%(slots)d * %(n)d];
  return (int)cudaMemcpyToSymbol(karanta::karanta_ftrace, zeros, sizeof(zeros));
}
extern "C" int karanta_ftrace_read(unsigned long long* buf) {
  return (int)cudaMemcpyFromSymbol(buf, karanta::karanta_ftrace,
                                   sizeof(unsigned long long) * %(slots)d * %(n)d);
}
""" % {"slots": MAX_SLOTS, "n": len(PHASES)}

# (anchor in the consumer's loop, phase index stamped right after it)
_AFTER = [
    ("      mbar_wait(&full_k[st], (i / kStages) & 1);\n", 0),
    ("      named_sync(1 + cw, 256);\n", 1),
    ("      rescale<D>(o, alpha);\n", 2),
    ("      mbar_wait(&full_v[pst], ((i - 1) / kStages) & 1);\n", 3),
    ("      named_arrive(2 - cw, 256);\n", 4),
    ("      wgmma_wait<1>();  // tile i's scores landed; P.V of tile i - 1 may still run\n"
     "      reg_fence(s);\n", 5),
    ("      release(&empty_k[st], lane);\n", 6),
    ("      release(&empty_v[pst], lane);\n", 7),
    ("      scores_to_p<D>(s, p);\n    }\n", 8),
]


def instrument(src: str) -> str:
    """flash_attention.cu with the consumer loop's clock readings."""
    out = src.replace('#include "mma.cuh"\n', '#include "mma.cuh"\n' + _DEFS, 1)
    start = ("    float s[kBN / 2], o[D / 2];\n")
    if start not in out:
        raise ValueError("flash_trace: the consumer's registers not found")
    out = out.replace(start, "    unsigned long long ft[%d] = {}, ft_last = clock64();\n"
                      % len(PHASES) + start, 1)
    loop = "    for (int i = 1; i < n_tiles; ++i) {\n"
    if loop not in out:
        raise ValueError("flash_trace: the key-tile loop not found")
    out = out.replace(loop, "    FT_STAMP(9);\n" + loop, 1)
    for anchor, k in _AFTER:
        if out.count(anchor) < 1:
            raise ValueError(f"flash_trace: {anchor.strip()!r} not found")
        head, tail = out.split(loop, 1)
        pos = tail.index(anchor) + len(anchor)
        if anchor.endswith("    }\n"):  # the loop's end: stamp inside it
            pos -= len("    }\n")
        tail = tail[:pos] + f"      FT_STAMP({k});\n" + tail[pos:]
        out = head + loop + tail
    store = "        __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);\n      }\n    }\n"
    if store not in out:
        raise ValueError("flash_trace: the stores not found")
    out = out.replace(store, store + (
        "    FT_STAMP(10);\n"
        "    const int ft_slot = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 2 + cw;\n"
        "    if ((tid & 127) == 0 && ft_slot < %d) {\n"
        "      for (int k = 0; k < %d; ++k) karanta_ftrace[ft_slot * %d + k] = ft[k];\n"
        "    }\n") % (MAX_SLOTS, len(PHASES), len(PHASES)), 1)
    return out + _EXPORTS


def build_traced(csrc: Path | None = None) -> ctypes.CDLL:
    """Build (once per source) and load the instrumented library."""
    csrc = Path(csrc or build.CSRC)
    src = instrument((csrc / "flash_attention.cu").read_text())
    digest = hashlib.sha1(src.encode() + " ".join(build.NVCC_FLAGS).encode())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out_dir = build.BUILD_DIR / f"ftrace-{digest.hexdigest()[:12]}"
    lib = out_dir / "libflash_trace.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            (out_dir / header.name).write_bytes(header.read_bytes())
        (out_dir / "flash_trace.cu").write_text(src)
        tmp = lib.with_suffix(".tmp")
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(tmp),
                               str(out_dir / "flash_trace.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"flash_trace: nvcc failed:\n{proc.stdout}"
                               f"{proc.stderr}")
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", type=Path, default=None)
    parser.add_argument("--only", default="vision,prefill,prefix",
                        help="comma-separated flash_ab shape names")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_trace: needs a CUDA device")
    lib = build_traced(args.csrc)
    fn = lib.karanta_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    A._flash_fn = lambda: fn
    n = len(PHASES)
    buf = (ctypes.c_ulonglong * (MAX_SLOTS * n))()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    wanted = [x for x in args.only.split(",") if x]
    results = {}
    for name, make in shapes(dev, gen).items():
        if name not in wanted:
            continue
        q, k, v, mask, causal, q_off, _, _ = make()
        A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        if lib.karanta_ftrace_reset() != 0:
            raise RuntimeError("flash_trace: reset failed")
        A.flash_attention(q, k, v, mask, causal=causal, q_offset=q_off)
        torch.cuda.synchronize()
        if lib.karanta_ftrace_read(buf) != 0:
            raise RuntimeError("flash_trace: read failed")
        b, sq, h, _ = q.shape
        slots = b * h * ((sq + 127) // 128) * 2
        rows = torch.tensor(list(buf[:min(slots, MAX_SLOTS) * n]),
                            dtype=torch.float64).view(-1, n)
        sums = rows.sum(0)
        total = float(sums.sum())
        # key tiles a warpgroup runs: its block's, from the causal end
        sk = k.shape[1]
        tiles = 0
        for qt in range((sq + 127) // 128):
            end = min(sk, q_off + 128 * qt + 128) if causal else sk
            tiles += (end + 127) // 128
        tiles *= b * h * 2
        shares = {ph: float(x) / total for ph, x in zip(PHASES, sums)}
        results[name] = {"shares": shares, "cycles_per_tile": total / tiles}
        print(f"  {name} {tuple(q.shape)}: {total / tiles:.0f} cycles a key "
              f"tile a warpgroup; " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in shares.items()),
              flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()
    print(json.dumps({"flash_trace": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
