"""Per-phase cycle trace of kernel #2's bf16 instance (``ops/attention.py
flash_attention``, ``kernels/csrc/flash_attention.cu``) or, with
``--kernel 3``, of kernel #3's (``ops/decode_attention.py
paged_decode_append_quant``, ``kernels/csrc/decode_append_quant.cu``) on the
card.

    python -m karanta_tpu_torch.bench.flash_trace
    python -m karanta_tpu_torch.bench.flash_trace --csrc DIR --only vision
    python -m karanta_tpu_torch.bench.flash_trace --kernel 3 --only b4,b80

An instrumented copy of the source (from ``kernels/csrc`` or DIR, a copy of
it) is built into ``kernels/build/ftrace-<hash>/``: the traced threads read
``clock64`` at the end of each phase and add the cycles since their last
reading to that phase, then store their sums. #2: every consumer thread,
thread 0 of each consumer warpgroup storing; the phases of one key-tile
iteration are waiting for the K tile, waiting for the warpgroup's turn
(the named barrier), issuing Q.K^T and rescaling O, waiting for the V tile,
issuing P.V, waiting for the scores, the softmax (with the mask, and
freeing the K stage), waiting for P.V, and rounding P; beside them the
first tile before the loop, and the last P.V and the stores after it. At
``flash_ab``'s shapes it prints each phase's share of all consumer cycles,
summed over the blocks, and the cycles per key tile. #3: thread 0 (a
consumer) and the producer's lane 0 of every block; the phases are the
block's set-up (cache_len, the item prefix), the producer's waits for an
item slot and a stage and its issue of the bulk copies, and the consumer's
wait for Q, the item's start (Q fragments, the new row's scores, the
append), its wait for a chunk, Q.K^T with the scales and the running max,
the softmax and P.V, and the item's end (the warps' merge, a partial or
the last block's merge, the output). At
``flash_ab``'s #3 shapes it prints each phase's share of the consumer's and
of the producer's cycles summed over the blocks, the consumer cycles per
chunk and the longest block's cycles. The readings cost a little, so times
come from ``flash_ab``. With ``--kernel 4`` (or 7, or 6) the same phases
come from the verify kernels' Hopper body (``kernels/csrc/verify_tma.cuh``,
built into ``decode_append_multi_quant.cu``, ``decode_append_multi_q4.cu``
or, at T = 1, ``decode_append_q4.cu``): thread 0 of each consumer warpgroup
and the producer's lane 0 of every block, at ``flash_ab``'s #4 (or #7, or
#6) shapes. Needs a CUDA device.

    python -m karanta_tpu_torch.bench.flash_trace --kernel 4 --only b4,b32

With ``--kernel 1`` the phases come from the window kernel's bf16 instance
(``kernels/csrc/window_attention.cu``): the producer thread's waits for a
cos/sin slot and for a stage and its issue of the copies; each consumer
warpgroup's thread 0 draining its last store and freeing cos/sin slots,
waiting for an item, the rope (with the warpgroup's barrier), Q.K^T, the
softmax, P.V (with rounding P and freeing the stage) and the store; at
``flash_ab``'s #1 shapes, each phase's share of the consumers' and of the
producer's cycles summed over the blocks, the consumer cycles an item and
the longest consumer warpgroup's.

    python -m karanta_tpu_torch.bench.flash_trace --kernel 1 --only page,pages4
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from karanta_tpu_torch.bench.flash_ab import VERIFY_SOURCES, shapes
from karanta_tpu_torch.kernels import build
from karanta_tpu_torch.ops import attention as A

PHASES = ("wait K", "wait turn", "issue QK + rescale O", "wait V", "issue PV",
          "wait S", "softmax", "wait PV", "round P", "first tile", "last PV + store")
MAX_SLOTS = 2 * 16384  # traced threads (two a block)


def _defs(n: int) -> str:
    return """namespace karanta {
__device__ unsigned long long karanta_ftrace[%(slots)d * %(n)d];
}
#define FT_STAMP(k) { const unsigned long long ft_now = clock64(); ft[k] += ft_now - ft_last; ft_last = ft_now; }
""" % {"slots": MAX_SLOTS, "n": n}


def _exports(n: int) -> str:
    return """
extern "C" int karanta_ftrace_reset() {
  static unsigned long long zeros[%(slots)d * %(n)d];
  return (int)cudaMemcpyToSymbol(karanta::karanta_ftrace, zeros, sizeof(zeros));
}
extern "C" int karanta_ftrace_read(unsigned long long* buf) {
  return (int)cudaMemcpyFromSymbol(buf, karanta::karanta_ftrace,
                                   sizeof(unsigned long long) * %(slots)d * %(n)d);
}
""" % {"slots": MAX_SLOTS, "n": n}


def _store(n: int, slot: str, cond: str, indent: str) -> str:
    return (f"{indent}{{\n{indent}  const int ft_slot = {slot};\n"
            f"{indent}  if (({cond}) && ft_slot < {MAX_SLOTS}) {{\n"
            f"{indent}    for (int k = 0; k < {n}; ++k) "
            f"karanta_ftrace[ft_slot * {n} + k] = ft[k];\n"
            f"{indent}  }}\n{indent}}}\n")


def _replace_once(out: str, anchor: str, new: str, name: str) -> str:
    if out.count(anchor) != 1:
        raise ValueError(f"flash_trace: {anchor.strip()!r} not found once "
                         f"in {name}")
    return out.replace(anchor, new)


def _stamp_after(out: str, anchor: str, stamp: str, name: str,
                 before: bool = False) -> str:
    return _replace_once(out, anchor,
                         stamp + anchor if before else anchor + stamp, name)

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
    out = src.replace('#include "mma.cuh"\n',
                      '#include "mma.cuh"\n' + _defs(len(PHASES)), 1)
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
    out = out.replace(store, store + "    FT_STAMP(10);\n" + _store(
        len(PHASES), "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
        "blockIdx.x) * 2 + cw", "(tid & 127) == 0", "    "), 1)
    return out + _exports(len(PHASES))


DECODE_PHASES = ("set-up", "producer: wait for an item slot",
                 "producer: wait for a stage", "producer: issue copies",
                 "wait for Q", "item start", "wait for a chunk",
                 "Q.K^T + scales + max", "softmax + P.V", "item end")
# (anchor in quant_tma.cuh's walker pieces, phase stamped after it)
_DECODE_AFTER = [
    ("    mbar_wait(&seg_empty[p], ((seg >> 1) & 1) ^ 1);\n", 1),
    ("      mbar_wait(&empty[s], ((i / kQStages) & 1) ^ 1);\n", 2),
    ("      } else {\n        mbar_arrive(&full[s]);\n      }\n", 3),
    ("    mbar_wait(&seg_full[p], (seg >> 1) & 1);\n", 4),
    ("    for (int nt = 0; nt < kNT; ++nt) o[nt][0] = o[nt][1] = 0.f;\n\n", 5),
    ("      mbar_wait(&full[s], (i / kQStages) & 1);\n", 6),
    ("      const float alpha = fast_exp2(m - mx);\n", 7),
    ("      if (lane == 0) mbar_arrive(&empty[s]);\n", 8),
    ("    named_sync(bar_id, kCT);  // the merge area is free again\n", 9),
]
# the walker pieces' parameter lists, which take the clock readings along
_DECODE_SIGNATURES = ("int n_items, int vb, int vgrid, int lane) {\n",
                      "int n_items, int vb, int vgrid, int tid,\n"
                      "                                              int bar_id) {\n")


def instrument_decode(src: str, header: str | None = None) -> str:
    """decode_append_quant.cu with clock readings in the bf16 instance's
    set-up and in its walker's pieces (quant_tma.cuh, `header`, by default
    the tree's; an instrumented copy takes the include's place): the
    producer's lane 0 stores its sums in slot 2 block + 1, the consumers'
    thread 0 in slot 2 block."""
    n, name = len(DECODE_PHASES), "decode_append_quant.cu"
    if header is None:
        header = (build.CSRC / "quant_tma.cuh").read_text()
    ft = f"unsigned long long (&ft)[{n}], unsigned long long& ft_last"
    for sig in _DECODE_SIGNATURES:
        header = _replace_once(header, sig, sig[:-4] + ", " + ft + ") {\n",
                               "quant_tma.cuh")
    for anchor, k in _DECODE_AFTER:
        header = _stamp_after(header, anchor, f"      FT_STAMP({k});\n",
                              "quant_tma.cuh")
    out = _replace_once(src, '#include "quant_tma.cuh"\n',
                        _defs(n) + header.replace("#pragma once\n", "", 1),
                        name)
    out = _stamp_after(
        out, "  // every slot's live rows (the clamp",
        f"  unsigned long long ft[{n}] = {{}}, ft_last = clock64();\n", name,
        before=True)
    out = _stamp_after(
        out, "  if (static_cast<int>(blockIdx.x) >= n_items) return;\n",
        "  FT_STAMP(0);\n", name)
    out = _replace_once(out, "gridDim.x, lane);\n",
                        "gridDim.x, lane, ft, ft_last);\n"
                        + _store(n, "blockIdx.x * 2 + 1", "lane == 0", "    "),
                        name)
    out = _replace_once(out, "gridDim.x, tid, 1);\n}\n",
                        "gridDim.x, tid, 1, ft,\n"
                        "                             ft_last);\n"
                        + _store(n, "blockIdx.x * 2", "tid == 0", "  ") + "}\n",
                        name)
    return out + _exports(n)


VERIFY_PHASES = ("set-up", "producer: wait for an item slot",
                 "producer: wait for a stage", "producer: issue copies",
                 "wait for Q", "item start", "wait for a chunk",
                 "Q.K^T + scales + max", "wait for the warps' maxima",
                 "softmax + P to shared memory", "wait for P", "P.V",
                 "item end: l, partial, counter",
                 "item end: merge, fold, output")
# (anchor in verify_tma.cuh, phase stamped after it, or before it)
_VERIFY_AFTER = [
    ("  if (static_cast<int>(blockIdx.x) >= n_items) return;\n", 0, False),
    ("      mbar_wait(&seg_empty[p], ((seg >> 1) & 1) ^ 1);\n", 1, False),
    ("        mbar_wait(&empty[s], ((i / kS) & 1) ^ 1);\n", 2, False),
    ("        } else {\n          mbar_arrive(&full[s]);\n        }\n", 3,
     False),
    ("    mbar_wait(&seg_full[p], (seg >> 1) & 1);\n", 4, False),
    ("    named_sync(1, kCT);  // the fragments are in place\n", 5, False),
    ("      mbar_wait(&full[s], (i / kS) & 1);\n", 6, False),
    ("      named_sync(1, kCT);  // the warps' maxima are in; the last P.V has "
     "read P\n", 7, True),
    ("      named_sync(1, kCT);  // the warps' maxima are in; the last P.V has "
     "read P\n", 8, False),
    ("      named_sync(1, kCT);  // P is whole\n", 9, True),
    ("      named_sync(1, kCT);  // P is whole\n", 10, False),
    ("      if (lane == 0) mbar_arrive(&empty[s]);\n", 11, False),
    ("      finish = *flag;\n", 12, False),
    ("    named_sync(1, kCT);  // P's area, the merge's and the flag are free "
     "again\n", 13, False),
]
VERIFY_HEADER = "verify_tma.cuh"


def instrument_verify(src: str) -> str:
    """verify_tma.cuh with clock readings in the producer (lane 0 stores,
    slot 2 block + 1) and the consumers (thread 0 stores, slot 2 block); the
    C entries are appended to the source that includes it."""
    n, name = len(VERIFY_PHASES), VERIFY_HEADER
    out = _replace_once(src, '#include "quant_tma.cuh"\n',
                        '#include "quant_tma.cuh"\n' + _defs(n), name)
    out = _stamp_after(
        out, "  // every slot's tokens before the T fresh ones",
        f"  unsigned long long ft[{n}] = {{}}, ft_last = clock64();\n", name,
        before=True)
    for anchor, k, before in _VERIFY_AFTER:
        out = _stamp_after(out, anchor, f"      FT_STAMP({k});\n", name,
                           before=before)
    out = _stamp_after(
        out, "    return;\n  }\n\n  // the consumers.",
        _store(n, "blockIdx.x * 2 + 1", "lane == 0", "    "), name,
        before=True)
    return _replace_once(
        out, "      FT_STAMP(13);\n    ++seg;\n  }\n}\n",
        "      FT_STAMP(13);\n    ++seg;\n  }\n"
        + _store(n, "blockIdx.x * 2", "tid == 0", "  ") + "}\n", name)


WINDOW_PHASES = ("producer: wait for a cos/sin slot",
                 "producer: wait for a stage", "producer: issue copies",
                 "drain the last store, free cos/sin slots",
                 "wait for an item", "rope (with the warpgroup's barrier)",
                 "Q.K^T", "softmax", "P.V", "store")
# (anchor in window_attention.cu, phase stamped after it)
_WINDOW_AFTER = [
    ("            mbar_wait(&cs_empty[slot], ((ord >> 1) & 1) ^ 1);\n", 0),
    ("        mbar_wait(&empty[st], w.phase ^ 1);  // first pass: free\n", 1),
    ("        if (g.has_mask) bulk_load(mask_s + st * g.kr, mask + key0, "
     "mask_bytes, &full[st]);\n", 2),
    ("      free_slots(ord);\n    }\n", 3),
    ("    mbar_wait(&full[st], w.phase);\n", 4),
    ("    named_sync(1 + cw, 128);  // Q and K rotated and fenced; the out "
     "buffer is free\n", 5),
    ("      wgmma_wait<0>();\n      reg_fence(s);\n", 6),
    ("      inv[i2] = 1.f / fmaxf(l[i2], 1e-30f);  // >= 1 in a tile row: its "
     "max gives exp2(0)\n    }\n", 7),
    ("    if (lane == 0) mbar_arrive(&empty[st]);  // the warp's products have "
     "read the stage\n", 8),
    ("      bulk_commit();\n    }\n", 9),
]


def instrument_window(src: str) -> str:
    """window_attention.cu with clock readings in the bf16 instance's
    producer thread (slot 3 block) and thread 0 of each consumer warpgroup
    (3 block + 1 + warpgroup)."""
    n, name = len(WINDOW_PHASES), "window_attention.cu"
    out = _replace_once(src, '#include "mma.cuh"\n',
                        '#include "mma.cuh"\n' + _defs(n), name)
    out = _stamp_after(
        out, "      static_cast<int>(static_cast<long long>(g.n_items) * "
        "(blockIdx.x + 1) / gridDim.x);\n",
        f"  unsigned long long ft[{n}] = {{}}, ft_last = clock64();\n", name)
    for anchor, k in _WINDOW_AFTER:
        out = _stamp_after(out, anchor, f"      FT_STAMP({k});\n", name)
    out = _stamp_after(
        out, "    return;\n  }\n\n  // the consumers",
        _store(n, "blockIdx.x * 3", "tid == 0", "    "), name, before=True)
    end = ("    bulk_wait<0>();  // the stores are done before the block's shared "
           "memory goes\n  }\n}\n")
    return _replace_once(
        out, end, end[:-2] + _store(n, "blockIdx.x * 3 + 1 + cw", "ct == 0",
                                    "  ") + "}\n", name) + _exports(n)


def window_trace(lib: ctypes.CDLL, wanted: list) -> int:
    """#1's phases at flash_ab's #1 shapes."""
    from karanta_tpu_torch.bench.flash_ab import (WINDOW_ARGTYPES,
                                                  WINDOW_SHAPES, window_case,
                                                  window_launcher)

    fn = lib.karanta_window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = WINDOW_ARGTYPES
    n = len(WINDOW_PHASES)
    buf = (ctypes.c_ulonglong * (MAX_SLOTS * n))()
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    results = {}
    for name, (pages, h, rope) in WINDOW_SHAPES.items():
        if wanted and name not in wanted:
            continue
        q, k, v, mask, cos, sin, _, _ = window_case(pages, h, rope, gen)
        call, _ = window_launcher(fn, q, k, v, mask, cos, sin)
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_reset() != 0:
            raise RuntimeError("flash_trace: reset failed")
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_read(buf) != 0:
            raise RuntimeError("flash_trace: read failed")
        rows = torch.tensor(list(buf[:MAX_SLOTS // 3 * 3 * n]),
                            dtype=torch.float64).view(-1, 3, n)
        rows = rows[rows.sum((1, 2)) > 0]  # the blocks of the grid
        items = q.shape[1] // 64 * h
        row = {"blocks": int(rows.shape[0]), "items": items}
        for role, cols in (("consumer", [1, 2]), ("producer", [0])):
            sums = rows[:, cols].sum((0, 1))
            total = float(sums.sum())
            row[role] = {ph: float(x) / total for ph, x in
                         zip(WINDOW_PHASES, sums) if x > 0}
        row["consumer_cycles_per_item"] = float(rows[:, 1:].sum()) / items
        row["longest_block_cycles"] = float(rows[:, 1:].sum(2).max())
        results[name] = row
        print(f"  #1 {name} {tuple(q.shape)} rope={rope}, {row['blocks']} "
              f"blocks, {items} items: "
              f"{row['consumer_cycles_per_item']:.0f} consumer cycles an "
              f"item, longest warpgroup {row['longest_block_cycles']:.0f} "
              f"cycles; consumer " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in row["consumer"].items())
              + "; producer " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in row["producer"].items()),
              flush=True)
        del q, k, v, mask, cos, sin
        torch.cuda.empty_cache()
    print(json.dumps({"window_trace": results}), flush=True)
    return 0


def build_traced(csrc: Path | None = None,
                 source: str = "flash_attention") -> ctypes.CDLL:
    """Build (once per source) and load the instrumented library of
    csrc/<source>.cu (for the verify kernels: with an instrumented
    verify_tma.cuh)."""
    csrc = Path(csrc or build.CSRC)
    headers = {h.name: h.read_text() for h in sorted(csrc.glob("*.cuh"))}
    if source in VERIFY_SOURCES.values():
        headers[VERIFY_HEADER] = instrument_verify(headers[VERIFY_HEADER])
        src = (csrc / f"{source}.cu").read_text() + _exports(
            len(VERIFY_PHASES))
    else:
        fn = {"decode_append_quant": lambda text: instrument_decode(
                  text, headers["quant_tma.cuh"]),
              "window_attention": instrument_window}.get(source, instrument)
        src = fn((csrc / f"{source}.cu").read_text())
    digest = hashlib.sha1(src.encode() + " ".join(build.NVCC_FLAGS).encode())
    for text in headers.values():
        digest.update(text.encode())
    out_dir = build.BUILD_DIR / f"ftrace-{digest.hexdigest()[:12]}"
    lib = out_dir / "libflash_trace.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in headers.items():
            (out_dir / name).write_text(text)
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


def decode_trace(lib: ctypes.CDLL, wanted: list) -> int:
    """#3's phases at flash_ab's #3 shapes, with this tree's run rule."""
    from karanta_tpu_torch.bench.flash_ab import (DECODE_ARGTYPES,
                                                  DECODE_M, decode_case,
                                                  decode_launcher,
                                                  decode_shapes)
    from karanta_tpu_torch.ops import decode_attention as DA

    fn = lib.karanta_decode_append_quant
    fn.restype = ctypes.c_int
    fn.argtypes = DECODE_ARGTYPES
    n = len(DECODE_PHASES)
    buf = (ctypes.c_ulonglong * (MAX_SLOTS * n))()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    info = DA.paged_decode_append_quant_info(128, 7)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (b, kvh, lens) in decode_shapes().items():
        if wanted and name not in wanted:
            continue
        q, new, caches, lens_t, _, _ = decode_case(b, kvh, lens, gen)
        run = DA.quant_run_rows(b, kvh, DECODE_M,
                                info["blocks_per_sm"] * n_sm, info["max_runs"])
        call, _, _ = decode_launcher(fn, q, new, caches, lens_t, run)
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_reset() != 0:
            raise RuntimeError("flash_trace: reset failed")
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_read(buf) != 0:
            raise RuntimeError("flash_trace: read failed")
        rows = torch.tensor(list(buf[:MAX_SLOTS * n]),
                            dtype=torch.float64).view(-1, 2, n)
        rows = rows[rows.sum((1, 2)) > 0]  # the blocks that had chunks
        chunks = kvh * sum(max(1, -(-x // info["chunk_rows"])) for x in lens)
        row = {"run_rows": run, "blocks": int(rows.shape[0])}
        for role, idx in (("consumer", 0), ("producer", 1)):
            sums = rows[:, idx].sum(0)
            total = float(sums.sum())
            row[role] = {ph: float(x) / total for ph, x in
                         zip(DECODE_PHASES, sums) if x > 0}
        row["consumer_cycles_per_chunk"] = float(rows[:, 0].sum()) / chunks
        row["longest_block_cycles"] = float(rows[:, 0].sum(1).max())
        results[name] = row
        print(f"  #3 {name} B={b} KVH={kvh}, runs of {run}, {row['blocks']} "
              f"blocks: {row['consumer_cycles_per_chunk']:.0f} consumer "
              f"cycles a chunk, longest block {row['longest_block_cycles']:.0f}"
              f" cycles; consumer " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in row["consumer"].items())
              + "; producer " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in row["producer"].items()),
              flush=True)
        del q, new, caches
        torch.cuda.empty_cache()
    print(json.dumps({"decode_trace": results}), flush=True)
    return 0


def verify_trace(lib: ctypes.CDLL, kernel: str, wanted: list) -> int:
    """#4's, #7's or #6's phases at flash_ab's shapes, with this tree's run
    rule."""
    from karanta_tpu_torch.bench.flash_ab import (VERIFY_G,
                                                  verify_argtypes,
                                                  verify_case, verify_info,
                                                  verify_launcher,
                                                  verify_run, verify_shapes)

    fn = getattr(lib, "karanta_" + VERIFY_SOURCES[kernel])
    fn.restype = ctypes.c_int
    fn.argtypes = verify_argtypes(kernel)
    n = len(VERIFY_PHASES)
    buf = (ctypes.c_ulonglong * (MAX_SLOTS * n))()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    this = build.library(VERIFY_SOURCES[kernel])
    results = {}
    for name, (b, kvh, tq, m, lens) in verify_shapes(kernel).items():
        if wanted and name not in wanted:
            continue
        info = verify_info(this, kernel, VERIFY_G * tq)
        q, new, caches, lens_t, _, _ = verify_case(kernel, b, kvh, tq, m,
                                                   lens, gen)
        run = verify_run(kernel, info, b, kvh, m, n_sm)
        call, _, _ = verify_launcher(kernel, fn, q, new, caches, lens_t, run)
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_reset() != 0:
            raise RuntimeError("flash_trace: reset failed")
        call()
        torch.cuda.synchronize()
        if lib.karanta_ftrace_read(buf) != 0:
            raise RuntimeError("flash_trace: read failed")
        rows = torch.tensor(list(buf[:MAX_SLOTS * n]),
                            dtype=torch.float64).view(-1, 2, n)
        rows = rows[rows.sum((1, 2)) > 0]  # the blocks that had items
        chunk_tokens = info[5] * (1 if kernel == "4" else 2)
        chunks = kvh * sum(max(1, -(-x // chunk_tokens)) for x in lens)
        row = {"run": run, "blocks": int(rows.shape[0])}
        for role, idx in (("consumer", 0), ("producer", 1)):
            sums = rows[:, idx].sum(0)
            total = float(sums.sum())
            row[role] = {ph: float(x) / total for ph, x in
                         zip(VERIFY_PHASES, sums) if x > 0}
        row["consumer_cycles_per_chunk"] = float(rows[:, 0].sum()) / chunks
        row["longest_block_cycles"] = float(rows[:, 0].sum(1).max())
        results[name] = row
        print(f"  #{kernel} {name} B={b} KVH={kvh} T={tq}, runs of {run}, "
              f"{row['blocks']} blocks: "
              f"{row['consumer_cycles_per_chunk']:.0f} consumer cycles a "
              f"chunk, longest block "
              f"{row['longest_block_cycles']:.0f} cycles; consumer "
              + ", ".join(f"{ph} {100 * x:.1f}%" for ph, x in
                          row["consumer"].items())
              + "; producer " + ", ".join(
                  f"{ph} {100 * x:.1f}%" for ph, x in row["producer"].items()),
              flush=True)
        del q, new, caches
        torch.cuda.empty_cache()
    print(json.dumps({f"verify_{kernel}_trace": results}), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csrc", type=Path, default=None)
    parser.add_argument("--only", default=None,
                        help="comma-separated flash_ab shape names (default "
                             "vision,prefill,prefix; #3: all)")
    parser.add_argument("--kernel", choices=("1", "2", "3", "4", "7", "6"),
                        default="2")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_trace: needs a CUDA device")
    if args.kernel == "1":
        return window_trace(build_traced(args.csrc, "window_attention"),
                            [x for x in (args.only or "").split(",") if x])
    if args.kernel == "3":
        return decode_trace(build_traced(args.csrc, "decode_append_quant"),
                            [x for x in (args.only or "").split(",") if x])
    if args.kernel in VERIFY_SOURCES:
        return verify_trace(
            build_traced(args.csrc, VERIFY_SOURCES[args.kernel]), args.kernel,
            [x for x in (args.only or "").split(",") if x])
    args.only = args.only or "vision,prefill,prefix"
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
