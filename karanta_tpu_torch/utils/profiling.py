"""Profiling: torch.profiler traces and a summary per profiled step (port of
``karanta_tpu/utils/profiling.py``).

``profile_step`` runs one step under ``torch.profiler`` (CPU and, on the
card, CUDA activity), exports a Chrome trace into
``<dir>/profile_step_<n>/`` and writes ``profile_step_<n>.txt`` beside it:
the wall time, the devices and the operator table sorted by device time.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterator

import torch

logger = logging.getLogger(__name__)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace; on exit it is written to
    <log_dir>/trace.json (Chrome trace format, viewable in Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_step(step_fn, args, step_num: int, output_dir: str,
                 label: str = "train"):
    """Run one step under a profiler trace; write the trace and a summary.
    Returns the step function's result."""
    trace_dir = os.path.join(output_dir, f"profile_step_{step_num}")
    start = time.perf_counter()
    with trace(trace_dir) as prof:
        result = step_fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    wall = time.perf_counter() - start
    summary = {
        "step": step_num,
        "label": label,
        "wall_time_s": wall,
        "trace_dir": trace_dir,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    or ["cpu"]),
    }
    sort = ("self_cuda_time_total" if torch.cuda.is_available()
            else "self_cpu_time_total")
    with open(os.path.join(output_dir, f"profile_step_{step_num}.txt"),
              "w") as f:
        f.write(json.dumps(summary, indent=2) + "\n")
        f.write(f"trace: {os.path.join(trace_dir, 'trace.json')}\n")
        f.write(prof.key_averages().table(sort_by=sort, row_limit=40))
    logger.info("profiled step %d (%.3fs) -> %s", step_num, wall, trace_dir)
    return result

