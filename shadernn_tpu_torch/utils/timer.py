"""Host-side timers, the per-layer timing table, and the span and counter
recorder.

`Timer` replaces the reference's CPU `Timer` (mean/min/max,
core/inc/snn/utils.h:513); `TimingStats.report` renders the per-run
timing-stat table printed by `MixedInferenceCore::printTimingStats`
(core/src/ic2/core.cpp:436-460,
docs/Developer-Guide/Benchmarking.md:20-45), its per-layer rows from the
recorder's `snn.layer` spans. Device-side times come from CUDA events
(engine/engine.py) and the profiler, not from GL timestamp queries.

The recorder is one per process (`RECORDER`; the module functions act on
it) and thread-safe, with bounded storage:

- `span(name, **attrs)`: a context manager that records a named host
  interval on `time.monotonic_ns()`, the clock `StreamingEngine` stamps
  with, with its thread and nesting depth. Tracing is off by default:
  a span site then reads a flag or two, makes no object and reads no
  clock. It is on while `enable()` holds, or while a `torch.profiler`
  session records (`torch.autograd.profiler._is_profiler_enabled`), so a
  profiled stretch records spans with no change to its caller. While the
  profiler records, a span is also opened as a profiler range
  (`_RecordFunctionFast`, a few microseconds where `record_function`
  takes tens), which names the host's time in the profiler's own trace
  on the thread that the profiler records.
- `record(name, start_ns, end_ns, attrs=None)`: a span from stamps taken
  elsewhere (the service's batch record).
- `count(name, n=1)`: a counter; counters always count.
- `snapshot()`: spans, counters, thread names and the offset from the
  monotonic clock to the profiler's absolute epoch (`time.time_ns()`),
  taken when `enable()` was called and again now: a span's
  `start_ns + offset_ns` is on the clock of a profiler's Chrome trace
  (utils/profiler.py `export_chrome_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


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


def clock_offset_ns() -> int:
    """`time.time_ns()` minus `time.monotonic_ns()`, from the tightest of
    three monotonic pairs around a wall-clock read."""
    best = None
    for _ in range(3):
        a = time.monotonic_ns()
        wall = time.time_ns()
        b = time.monotonic_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class Recorder:
    """Spans and counters of one process. `capacity` bounds the spans
    kept (the oldest go first, counted in `dropped`). A span is kept as
    (name, start ns, end ns, native thread id, attributes or None); its
    nesting depth is worked out when a snapshot is taken."""

    def __init__(self, capacity: int = 200_000):
        self._lock = threading.Lock()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counters: Dict[str, int] = {}
        self._threads: Dict[int, str] = {}  # native thread id -> name
        # each thread's native id, read once a thread: get_native_id() is a
        # system call (microseconds on some hosts)
        self._local = threading.local()
        self.dropped = 0
        self.enabled = False
        self.offset_at_enable_ns: Optional[int] = None

    def enable(self) -> None:
        """Turn tracing on (until `disable()`), taking the clock offset."""
        self.offset_at_enable_ns = clock_offset_ns()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def record(self, name: str, start_ns: int, end_ns: int, attrs: Optional[dict] = None) -> None:
        """Keep a span of this thread from stamps on `time.monotonic_ns()`."""
        # deque.append and a dict's item assignment are atomic; only the
        # count of dropped spans takes the lock.
        tid = getattr(self._local, "tid", None)
        if tid is None:
            tid = self._local.tid = threading.get_native_id()
            self._threads[tid] = threading.current_thread().name
        spans = self._spans
        if len(spans) == spans.maxlen:
            with self._lock:
                self.dropped += 1
        spans.append((name, start_ns, end_ns, tid, attrs))

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name` (counters count whether or not
        tracing is on)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> dict:
        """Copies of the spans (as dicts, with their depth), the counters and
        the threads' names, and the clock offset now and at `enable()`."""
        with self._lock:
            spans = list(self._spans)
            out = {"counters": dict(self._counters), "threads": dict(self._threads),
                   "dropped": self.dropped}
        out["spans"] = [{"name": n, "start_ns": int(s), "end_ns": int(e), "thread": t,
                         "depth": d, "attrs": a or {}}
                        for (n, s, e, t, a), d in zip(spans, _depths(spans))]
        out["offset_ns"] = clock_offset_ns()
        out["offset_at_enable_ns"] = self.offset_at_enable_ns
        return out

    def reset(self) -> None:
        """Forget every span and counter."""
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self.dropped = 0


def _depths(spans: list) -> List[int]:
    """Each span's nesting depth: how many spans of its thread contain it."""
    depth = [0] * len(spans)
    by_thread: Dict[int, list] = {}
    for i, (_n, s, e, t, _a) in enumerate(spans):
        by_thread.setdefault(t, []).append((s, -e, i))
    for items in by_thread.values():
        open_ends: List[int] = []
        for s, neg_e, i in sorted(items):
            while open_ends and open_ends[-1] <= s:
                open_ends.pop()
            depth[i] = len(open_ends)
            open_ends.append(-neg_e)
    return depth


RECORDER = Recorder()
# The process's recorder, as the module's functions.
record = RECORDER.record
count = RECORDER.count
counters = RECORDER.counters
enable = RECORDER.enable
disable = RECORDER.disable
snapshot = RECORDER.snapshot
reset = RECORDER.reset
_monotonic_ns = time.monotonic_ns


class _Span:
    """One open span (made only while tracing is on)."""

    __slots__ = ("name", "attrs", "t0", "fast")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        if _autograd_profiler._is_profiler_enabled:
            self.fast = _RecordFunctionFast(self.name)
            self.fast.__enter__()
        else:
            self.fast = None
        self.t0 = _monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _monotonic_ns()
        if self.fast is not None:
            self.fast.__exit__(None, None, None)
        RECORDER.record(self.name, self.t0, t1, self.attrs)


_OFF = contextlib.nullcontext()  # the span of a site while tracing is off: one shared object


def tracing() -> bool:
    """Whether spans are recorded now: `enable()` holds, or a torch.profiler
    session records."""
    return RECORDER.enabled or _autograd_profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context manager that records `name` over its block while tracing is
    on (`_OFF`, which records nothing, while it is off). A hot site tests
    `tracing()` first and calls `span` only when it holds, so that with
    tracing off it builds not even the call's keyword dict."""
    if not (RECORDER.enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs or None)


def _layer_rows(snap: dict, nodes=None) -> Dict[str, Timer]:
    """{node: Timer of its `snn.layer` spans, in seconds}, in the order the
    nodes first ran; only the nodes in `nodes` where given."""
    rows: Dict[str, Timer] = {}
    for s in snap["spans"]:
        node = s["attrs"].get("node") if s["name"] == "snn.layer" else None
        if node is None or (nodes is not None and node not in nodes):
            continue
        rows.setdefault(node, Timer(node)).samples.append((s["end_ns"] - s["start_ns"]) * 1e-9)
    return rows


@dataclass
class TimingStats:
    """The timing table of an engine, rendered like the reference's
    printTimingStats output (core.cpp:436-460): a row per layer from the
    recorder's `snn.layer` spans (host time of each layer's dispatch,
    recorded while tracing is on), the whole step's `total`, and the
    counters."""

    total: Timer = field(default_factory=lambda: Timer("total"))

    def report(self, warmup: int = 0, nodes=None) -> str:
        snap = snapshot()
        layers = _layer_rows(snap, nodes)
        lines = ["=== Time stats (ms) ==="]
        width = max([len(n) for n in layers] + [10])
        for name, t in layers.items():
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
        if snap["counters"]:
            lines.append("  counters: " + ", ".join(
                f"{k} {v}" for k, v in sorted(snap["counters"].items())))
        return "\n".join(lines)
