"""Per-stage wall-clock timing with min/max/avg statistics.

Array-program equivalent of the reference's profiling machinery: the manual
chrono spans around the GPU loop (reference:
src/SlamGpuPipeline/buildStream.cpp:372-373,624-633,657-665) and vilib's
DetectorBenchmark Timer/TimerGPU/Statistics
(src_trash1/vilib/feature_detection/detector_benchmark.cpp:42-106,
timer.h:42-72, statistics.h:41-64).  Device work is asynchronous under JAX,
so timed sections must call `jax.block_until_ready` on their outputs — the
`Timer.stop(result)` helper does that.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import jax


@dataclass
class Stats:
    n: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, dt: float) -> None:
        self.n += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> Dict[str, float]:
        return {"n": self.n, "avg_ms": self.avg * 1e3,
                "min_ms": (0.0 if self.n == 0 else self.min * 1e3),
                "max_ms": self.max * 1e3}


class Timer:
    """Context-manager or start/stop timer that syncs device results."""

    def __init__(self, stats: Stats | None = None):
        self.stats = stats or Stats()
        self._t0 = 0.0

    def start(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, result: Any = None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        dt = time.perf_counter() - self._t0
        self.stats.add(dt)
        return dt

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass
class StageTimers:
    """Named per-stage timers (the DetectorBenchmark singleton, done right:
    an explicit object, not global state)."""

    stages: Dict[str, Stats] = field(default_factory=dict)

    def timer(self, name: str) -> Timer:
        stats = self.stages.setdefault(name, Stats())
        return Timer(stats)

    def time(self, name: str, fn, *args, **kwargs):
        t = self.timer(name).start()
        out = fn(*args, **kwargs)
        t.stop(out)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: v.summary() for k, v in self.stages.items()}
