"""Rank processes: spawn them, bound their lifetime, collect their results.

``run_ranks`` runs one function on every rank of a process group, each rank
a process of its own (the ``spawn`` start method: workers import the
function by name and share no state with the caller). A rank that raises,
dies or outlasts its timeout fails the call, and every rank is then killed:
a fault never leaves the caller waiting on a peer that is gone.
``spawn_workers`` starts ranks 1..world-1 for a caller that is rank 0
itself (the server), and ``join_group`` joins rank 0 to the group while
watching those workers, so a worker that dies at start fails the start.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import socket
import sys
import threading
import time
import traceback
from typing import Any, Callable, Optional

import torch

from karanta_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S,
                                             initialize_distributed)
from karanta_tpu_torch.parallel.sharding import barrier


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, init_url: str,
               args: bytes, results) -> None:
    import torch.distributed as dist

    try:
        out = fn(rank, world, init_url, *pickle.loads(args))
        if results is not None:
            # plain pickle bytes: tensors travel by value, not as shared
            # memory handles that die with this process
            results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported, then the rank exits
        if results is None:
            sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
            raise SystemExit(1)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: tuple = (),
              init_url: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(rank, world, init_url, *args) in `world` spawned processes
    and return their results in rank order. fn joins the group itself
    (``initialize_distributed(init_url, world, rank, ...)``). Raises
    RuntimeError, after killing every rank, when one raises, exits without a
    result or the whole run outlasts `timeout_s`."""
    init_url = init_url or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    blob = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, init_url, blob, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before its result")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks {sorted(set(range(world)) - set(out))} gave "
                        f"no result within {timeout_s:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=5 if len(out) == world else 0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [out[r] for r in range(world)]


def in_turns(mesh, fn: Callable):
    """fn() on the ranks that share a card one at a time, the others waiting
    at a barrier, each rank's freed card memory returned to the card before
    the next turn. The sharded loaders hold one whole leaf (float32 while a
    random one is drawn) before they slice it: ranks that share a card then
    peak at one such leaf, not one a rank. Ranks with a card each, or on
    the CPU, run fn() at once. Returns fn()'s result."""
    if mesh.world == 1 or mesh.device.type != "cuda":
        return fn()
    cards = torch.cuda.device_count()
    out = None
    for turn in range(-(-mesh.world // cards)):
        if turn == mesh.rank // cards:
            out = fn()
            torch.cuda.synchronize(mesh.device)
            torch.cuda.empty_cache()
        barrier(mesh.cpu_group)
    return out


def spawn_workers(fn: Callable, world: int, init_url: str,
                  args: tuple = ()) -> list:
    """Start ranks 1..world-1 running fn(rank, world, init_url, *args) as
    daemon processes (spawned); returns them. The caller is rank 0. A
    worker that raises prints its traceback and exits with code 1."""
    ctx = mp.get_context("spawn")
    blob = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, init_url, blob, None))
             for rank in range(1, world)]
    for p in procs:
        p.start()
    return procs


def join_group(init_url: str, world: int, workers: list,
               device: Any = None, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the group as rank 0 while the workers start: raises
    RuntimeError as soon as a worker exits, instead of waiting out the
    rendezvous. Returns the backend."""
    box: dict = {}

    def join():
        try:
            box["backend"] = initialize_distributed(
                init_url, world, 0, backend=backend, device=device,
                timeout_s=timeout_s)
        except BaseException as exc:  # re-raised in the caller's thread
            box["error"] = exc

    thread = threading.Thread(target=join, daemon=True)
    thread.start()
    while thread.is_alive():
        thread.join(timeout=0.5)
        dead = [p for p in workers if p.exitcode is not None]
        if dead and thread.is_alive():
            for p in workers:
                if p.is_alive():
                    p.kill()
            raise RuntimeError(f"a rank exited with code {dead[0].exitcode} "
                               f"while the group formed")
    if "error" in box:
        raise box["error"]
    return box["backend"]
