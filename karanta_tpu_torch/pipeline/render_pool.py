"""Process-based render workers: rasterization + anchor text off the
serving core.

The reference's rasterization is inherently multi-process — one pdftoppm
subprocess per page behind a cpu-2 semaphore (reference
karanta/pipeline.py:136-142, karanta/data/process_pdf_utils.py:56-74). The
in-process minipdf rasterizer is pure Python and holds the GIL through
content-stream work, so an `asyncio.to_thread` render can neither scale
past ~1 core nor stay out of the serving event loop's way. This pool is
the structural fix: spawn-started worker
processes run `prepare_image_and_text`, so on multi-core hosts rendering
parallelizes across cpu-2 cores while the serving loop keeps its own core.

Start method is SPAWN, never fork: the parent may hold a CUDA context and
threads, which a forked child would inherit. A spawned worker re-imports
cleanly, and its code path (PDF parsing, numpy and the port's PNG codec)
imports neither torch nor PIL: the package's __init__ resolves
``resolve_device`` lazily for that reason.

Knobs:
  KARANTA_RENDER_PROCS = N  worker count (default max(1, cpu-2))
  KARANTA_RENDER_PROCS = 0  disable: render in a thread (also the
                            automatic fallback if the pool cannot start or
                            breaks)
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)

_pool = None          # ProcessPoolExecutor | None
_pool_pid = None      # guard against use across os.fork (tests)
_pool_broken = False  # one-way fuse: stop retrying a crashing pool


def _worker_count() -> int:
    env = os.environ.get("KARANTA_RENDER_PROCS")
    if env is not None:
        return max(0, int(env))
    return max(1, (os.cpu_count() or 4) - 2)


def _render_entry(local_pdf_path: str, page: int, dim: int,
                  anchor_len: int, grayscale: bool):
    """Top-level so spawn can pickle it. Runs in the worker process."""
    from karanta_tpu_torch.prompts.templates import prepare_image_and_text

    return prepare_image_and_text(local_pdf_path, page, dim, anchor_len,
                                  grayscale)


def _get_pool():
    global _pool, _pool_pid
    n = _worker_count()
    if n == 0 or _pool_broken:
        return None
    if _pool is not None and _pool_pid == os.getpid():
        return _pool
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    _pool = ProcessPoolExecutor(
        max_workers=n, mp_context=multiprocessing.get_context("spawn"))
    _pool_pid = os.getpid()
    return _pool


def _warm_entry() -> int:
    """Force the worker's imports (the PDF and prompt stack) at pool
    start."""
    import karanta_tpu_torch.prompts.templates  # noqa: F401

    return os.getpid()


async def warm_pool() -> int:
    """Start every worker and run its imports; returns the worker count.
    Called at pipeline startup so the spawn + import cost (~seconds) lands
    before the first page, not inside it."""
    pool = _get_pool()
    if pool is None:
        return 0
    loop = asyncio.get_running_loop()
    pids = await asyncio.gather(*[
        loop.run_in_executor(pool, _warm_entry)
        for _ in range(pool._max_workers)])
    return len(set(pids))


def shutdown_pool() -> None:
    """Tear down the worker pool (tests; long-lived hosts at exit)."""
    global _pool
    if _pool is not None:
        _pool.shutdown(wait=False, cancel_futures=True)
        _pool = None


async def render_page(local_pdf_path: str, page: int, dim: int,
                      anchor_len: int = 4000, grayscale: bool = True
                      ) -> tuple[str, str]:
    """(image_base64, anchor_text) via the worker pool; thread fallback."""
    global _pool, _pool_broken
    pool = _get_pool()
    if pool is not None:
        try:
            return await asyncio.get_running_loop().run_in_executor(
                pool, _render_entry, local_pdf_path, page, dim, anchor_len,
                grayscale)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            from concurrent.futures.process import BrokenProcessPool

            if not isinstance(e, BrokenProcessPool):
                raise  # a real render error (bad PDF etc.) — propagate
            logger.error("render pool broke (%r); falling back to "
                         "in-thread rendering", e)
            _pool_broken = True
            shutdown_pool()
    from karanta_tpu_torch.prompts.templates import prepare_image_and_text

    return await asyncio.to_thread(prepare_image_and_text, local_pdf_path,
                                   page, dim, anchor_len, grayscale)
