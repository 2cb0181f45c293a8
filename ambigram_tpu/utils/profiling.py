"""Tracing and per-phase timing.

The reference's only instrumentation is a wall-clock line in time.csv
(localhap.cpp:383-388). Here: named phase timers with a
candidates-scored counter (the BASELINE metric), plus an optional
jax.profiler trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional


@dataclass
class PhaseStats:
    seconds: float = 0.0
    calls: int = 0


class Profiler:
    """Accumulating named phase timers + counters.

    Thread-safe accumulation: the batch pipeline runs solver stages on
    thread pools, and the += updates are read-modify-write. Note that
    overlapping phases from concurrent threads legitimately sum to more
    than wall-clock (they report CPU-occupancy-style totals)."""

    def __init__(self) -> None:
        import threading

        self.phases: Dict[str, PhaseStats] = {}
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self.phases.clear()
            self.counters.clear()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                stats = self.phases.setdefault(name, PhaseStats())
                stats.seconds += dt
                stats.calls += 1

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def candidates_per_second(self) -> Optional[float]:
        scored = self.counters.get("candidates_scored", 0.0)
        secs = self.phases.get("score", PhaseStats()).seconds
        if scored and secs:
            return scored / secs
        return None

    def report(self) -> str:
        lines = []
        for name in sorted(self.phases):
            s = self.phases[name]
            lines.append("%-20s %8.3fs  x%d" % (name, s.seconds, s.calls))
        for name in sorted(self.counters):
            lines.append("%-20s %g" % (name, self.counters[name]))
        cps = self.candidates_per_second()
        if cps:
            lines.append("%-20s %.1f/s" % ("candidates_scored", cps))
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace capture when log_dir is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


GLOBAL = Profiler()
