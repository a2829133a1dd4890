"""Host-side timers and per-layer timing statistics.

Replaces the reference's CPU `Timer` (mean/min/max, core/inc/snn/utils.h:513),
`ScopedTimer`/`PROFILE_TIME` (utils.h:596-611) and the per-run timing-stat
table printed by `MixedInferenceCore::printTimingStats`
(core/src/ic2/core.cpp:436-460). Device-side times come from CUDA events
(engine/engine.py), not from GL timestamp queries; the report format here
matches the reference's table
(docs/Developer-Guide/Benchmarking.md:20-45).
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Timer:
    """Accumulating wall-clock timer with mean/min/max like snn::Timer."""

    name: str = ""
    samples: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "Timer.stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.samples.append(dt)
        return dt

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total(self) -> float:
        return sum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.samples else 0.0

    @property
    def min(self) -> float:
        return min(self.samples) if self.samples else 0.0

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else 0.0

    def stdev(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        m = self.mean
        return math.sqrt(sum((s - m) ** 2 for s in self.samples) / (len(self.samples) - 1))

    def excluding_warmup(self, warmup: int) -> "Timer":
        """Stats excluding the first `warmup` samples (reference
        NUM_EXCLUDE_FIRST_LOOPS=5, demo/common/inferenceProcessor.cpp:90)."""
        t = Timer(name=self.name)
        t.samples = self.samples[warmup:]
        return t

    def reset(self) -> None:
        self.samples.clear()
        self._t0 = None


@contextlib.contextmanager
def ScopedTimer(timer: Timer):
    timer.start()
    try:
        yield timer
    finally:
        timer.stop()


@dataclass
class TimingStats:
    """Per-layer timing table, rendered like the reference's
    printTimingStats output (core.cpp:436-460)."""

    layers: Dict[str, Timer] = field(default_factory=dict)
    total: Timer = field(default_factory=lambda: Timer("total"))

    def layer(self, name: str) -> Timer:
        if name not in self.layers:
            self.layers[name] = Timer(name)
        return self.layers[name]

    def report(self, warmup: int = 0) -> str:
        lines = ["=== Time stats (ms) ==="]
        width = max([len(n) for n in self.layers] + [10])
        for name, t in self.layers.items():
            tt = t.excluding_warmup(warmup)
            lines.append(
                f"  [{name:<{width}}] last {1e3 * (tt.samples[-1] if tt.samples else 0.0):9.3f}"
                f"  mean {1e3 * tt.mean:9.3f}  stdev {1e3 * tt.stdev():7.3f}"
                f"  min {1e3 * tt.min:9.3f}  max {1e3 * tt.max:9.3f}  n {tt.count}"
            )
        tt = self.total.excluding_warmup(warmup)
        lines.append(
            f"  total: mean {1e3 * tt.mean:9.3f} ms  stdev {1e3 * tt.stdev():7.3f}"
            f"  min {1e3 * tt.min:9.3f}  max {1e3 * tt.max:9.3f}  n {tt.count}"
        )
        return "\n".join(lines)
