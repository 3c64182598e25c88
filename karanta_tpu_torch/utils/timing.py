"""Wall-clock helpers (the port's copy of ``karanta_tpu/utils/timing.py``;
reference: karanta/data/utils.py:172-183 @timeit)."""

from __future__ import annotations

import functools
import logging
import time

logger = logging.getLogger(__name__)


def timeit(fn):
    """Log the wall-clock duration of a function call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            logger.info("%s took %.3fs", fn.__name__, time.perf_counter() - start)

    return wrapper


class StageTimer:
    """Accumulates named stage durations for throughput accounting."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    class _Ctx:
        def __init__(self, timer: "StageTimer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dur = time.perf_counter() - self.start
            self.timer.totals[self.name] = self.timer.totals.get(self.name, 0.0) + dur
            self.timer.counts[self.name] = self.timer.counts.get(self.name, 0) + 1
            return False

    def stage(self, name: str) -> "StageTimer._Ctx":
        return StageTimer._Ctx(self, name)

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self.counts[name],
                "mean_s": total / max(self.counts[name], 1),
            }
            for name, total in self.totals.items()
        }
