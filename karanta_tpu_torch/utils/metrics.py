"""Pipeline metrics and worker-state tracking.

Native re-implementation of the external `olmocr.metrics` surface the reference
imports (SURVEY.md §2.11; usage: karanta/pipeline.py:346-351,380,433,689,
955-961,1399-1469): a sliding-window counter keeper with rate reporting, and a
per-worker status table. Pure host-side Python — no device work.
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Tuple


class MetricsKeeper:
    """Sliding-window counters with lifetime totals and windowed rates."""

    def __init__(self, window: int = 300):
        self.window = window
        self.start_time = time.time()
        self.total_metrics: Dict[str, float] = defaultdict(float)
        # deque of (timestamp, {name: value})
        self._events: Deque[Tuple[float, Dict[str, float]]] = deque()

    def add_metrics(self, **counters: float) -> None:
        now = time.time()
        for name, value in counters.items():
            self.total_metrics[name] += value
        self._events.append((now, dict(counters)))
        self._trim(now)

    def _trim(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window:
            self._events.popleft()

    def window_rates(self) -> Dict[str, float]:
        now = time.time()
        self._trim(now)
        if not self._events:
            return {}
        span = max(now - self._events[0][0], 1e-6)
        sums: Dict[str, float] = defaultdict(float)
        for _, counters in self._events:
            for name, value in counters.items():
                sums[name] += value
        return {name: value / span for name, value in sums.items()}

    def get_metrics_summary(self) -> dict:
        elapsed = time.time() - self.start_time
        return {
            "elapsed_time_seconds": elapsed,
            "total_metrics": dict(self.total_metrics),
            "rates": {
                name: (value / elapsed if elapsed > 0 else 0.0)
                for name, value in self.total_metrics.items()
            },
            "window_rates": self.window_rates(),
        }

    def __str__(self) -> str:
        summary = self.get_metrics_summary()
        lines = [f"MetricsKeeper(elapsed={summary['elapsed_time_seconds']:.1f}s)"]
        width = max((len(n) for n in self.total_metrics), default=10)
        for name in sorted(self.total_metrics):
            total = self.total_metrics[name]
            rate = summary["rates"].get(name, 0.0)
            lines.append(f"  {name:<{width}}  total={total:>12.0f}  rate={rate:>10.2f}/s")
        return "\n".join(lines)


class WorkerTracker:
    """Tracks per-worker work-item states (started/finished/cancelled/errored)."""

    STATES = ("started", "finished", "cancelled", "errored")

    def __init__(self) -> None:
        self._lock = asyncio.Lock()
        # worker_id -> state -> count
        self._counts: Dict[int, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        # worker_id -> currently running item key
        self._current: Dict[int, str] = {}

    async def track_work(self, worker_id: int, key: str, state: str) -> None:
        async with self._lock:
            self._counts[worker_id][state] += 1
            if state == "started":
                self._current[worker_id] = key
            else:
                self._current.pop(worker_id, None)

    async def clear_work(self, worker_id: int) -> None:
        async with self._lock:
            self._current.pop(worker_id, None)

    def get_status_table(self) -> str:
        header = f"{'worker':>6} | " + " | ".join(f"{s:>9}" for s in self.STATES) + " | current"
        lines = [header, "-" * len(header)]
        for worker_id in sorted(self._counts):
            counts = self._counts[worker_id]
            row = f"{worker_id:>6} | " + " | ".join(
                f"{counts.get(s, 0):>9}" for s in self.STATES
            )
            row += f" | {self._current.get(worker_id, '-')}"
            lines.append(row)
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.get_status_table()
