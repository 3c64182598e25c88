"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``kernels/build/``, named
by a hash of the sources and flags so an edited source is rebuilt. Nothing
is built at import: the first call that needs a kernel builds it, and
``build_all`` builds every source at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("window_attention", "flash_attention", "decode_append_quant",
           "decode_append_multi_quant", "decode_append", "decode_append_q4",
           "decode_append_multi_q4", "decode_attention", "decode_stream")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels are "
                           "built from source on the machine with the card")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, extra_flags=()) -> dict[str, float]:
    """Compile every missing library in parallel; returns seconds per source
    (0.0 where the library was already built). Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    started = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # the compiler's output goes to a file: a full pipe would stall it
        log = open(out.with_suffix(f".{os.getpid()}.log"), "w+")
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    seconds = {name: 0.0 for name in names}
    failures = []
    while procs:
        for name in list(procs):
            proc, tmp, out, log_file = procs[name]
            if proc.poll() is None:
                continue
            del procs[name]
            seconds[name] = time.perf_counter() - started
            log_file.seek(0)
            log = log_file.read()
            log_file.close()
            os.remove(log_file.name)
            if proc.returncode != 0:
                failures.append(
                    f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
                continue
            if log.strip():
                print(f"[nvcc {name}.cu]\n{log}", flush=True)
            os.replace(tmp, out)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
