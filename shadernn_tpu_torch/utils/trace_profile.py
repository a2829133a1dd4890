"""In-situ profiling: a `torch.profiler` run of the production step, parsed
into a per-kernel time table whose sum is the step's device busy time
(counterpart of shadernn_tpu/utils/trace_profile.py, which parses a jax
profiler trace directory; here `parse_profile` reads the profiler object).

Only the device's own events are summed: kernels, copies and fills, each
by its self time. A CPU op's device time repeats the time of the kernels
it launched and is not added. On a CPU engine the device is the CPU: its
ops are summed by self time (the tests' case). `e2e_us` is the device busy
time per step: the sum of those events over the profiled steps, divided by
the step count. Rows are per kernel name with a count; the hand-written
kernels (csrc/*.cu) are named by their identifier (`HAND_WRITTEN`), every
other event by the profiler's own name.

The per-layer FLOP and byte counts, and with them the roofline, are in
utils/profiler.py: the profiler gives none for a kernel.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from shadernn_tpu_torch.kernels import KERNELS, launch_counts
from shadernn_tpu_torch.utils import timer

# The hand-written kernels' names, as the profiler gives them (the
# demangled name holds the identifier).
HAND_WRITTEN = re.compile(r"\b(" + "|".join(sorted({k for ks in KERNELS.values() for k in ks}))
                          + r")\b")


@dataclasses.dataclass
class TraceOp:
    name: str
    category: str  # "hand-written", "library" (cuDNN, cuBLAS, ATen), "memcpy", "memset", "cpu"
    us: float  # per step
    count: float = 1  # events per step


@dataclasses.dataclass
class TraceReport:
    e2e_us: float  # device busy time per step
    ops: List[TraceOp]  # sorted by time, descending
    steps: int
    precision: str = "bfloat16"
    # the program's own launches per step of each hand-written kernel over
    # the profiled steps (the recorder's `kernels.launches.<kernel>.<entry>`)
    launches: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def covered_us(self) -> float:
        return sum(o.us for o in self.ops)

    def by_category(self) -> Dict[str, float]:
        cats: Dict[str, float] = {}
        for o in self.ops:
            cats[o.category] = cats.get(o.category, 0.0) + o.us
        return dict(sorted(cats.items(), key=lambda kv: -kv[1]))

    def table(self, top: int = 30) -> str:
        lines = [
            "===== In-situ device profile (per step) =====",
            f"  device busy {self.e2e_us / 1e3:.4f} ms per step over {self.steps} steps",
            f"  {'event':<60} {'ms':>8} {'%busy':>6} {'count':>6}  category",
        ]
        for o in self.ops[:top]:
            lines.append(
                f"  {o.name[:60]:<60} {o.us / 1e3:8.4f} "
                f"{100 * o.us / max(self.e2e_us, 1e-9):5.1f}% {o.count:6.2f}  {o.category}"
            )
        lines.append("  -- by category: " + ", ".join(
            f"{k}={v / 1e3:.4f}ms" for k, v in self.by_category().items()))
        return "\n".join(lines)


def _category(key: str) -> Tuple[str, str]:
    """(row name, category) of one device event's profiler key."""
    m = HAND_WRITTEN.search(key)
    if m:
        return m.group(0), "hand-written"
    if key.startswith("Memcpy"):
        return key, "memcpy"
    if key.startswith("Memset"):
        return key, "memset"
    return key, "library"


def parse_profile(prof, steps: int, precision: str = "bfloat16",
                  device_type: str = "cuda") -> TraceReport:
    """Per-step table of one profiler run over `steps` steps: its CUDA
    events, or on a CPU engine (`device_type` "cpu") its CPU ops."""
    from torch.autograd import DeviceType

    cuda = device_type == "cuda"
    want = DeviceType.CUDA if cuda else DeviceType.CPU
    agg: Dict[str, TraceOp] = {}
    for ev in prof.key_averages():
        if ev.device_type != want:
            continue
        if cuda:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:  # older torch
                us = ev.self_cuda_time_total
            name, cat = _category(ev.key)
        else:
            us, name, cat = ev.self_cpu_time_total, ev.key, "cpu"
        if us <= 0:
            continue
        op = agg.setdefault(name, TraceOp(name, cat, 0.0, 0))
        op.us += us
        op.count += ev.count
    steps = max(int(steps), 1)
    for o in agg.values():
        o.us /= steps
        o.count /= steps
    ops = sorted(agg.values(), key=lambda o: -o.us)
    return TraceReport(e2e_us=sum(o.us for o in ops), ops=ops, steps=steps, precision=precision)


def complete(report: TraceReport) -> bool:
    """Whether a card profile recorded every launch: a step launches each
    kernel the same number of times, so each row's events over the profiled
    steps are a multiple of the step count, and there is at least one; and
    each hand-written kernel has as many events as the program counted
    launches of it (`report.launches`)."""
    counts = {o.name: o.count for o in report.ops}
    return bool(report.ops) and all(
        abs(o.count - round(o.count)) < 1e-6 for o in report.ops) and all(
        abs(counts.get(k, 0.0) - n) < 1e-6 for k, n in report.launches.items())


def launches_per_step(before: Dict[str, int], after: Dict[str, int],
                      steps: int) -> Dict[str, float]:
    """{kernel: the program's launches of it per step} between two reads of
    the recorder's counters (`kernels.launch_counts`)."""
    pre, post = launch_counts("kernel", before), launch_counts("kernel", after)
    return {k: (n - pre.get(k, 0)) / max(int(steps), 1)
            for k, n in post.items() if n != pre.get(k, 0)}


def profile_steps(fn: Callable[[], object], steps: int, device: torch.device,
                  precision: str = "bfloat16", attempts: int = 3) -> TraceReport:
    """Profile `steps` calls of fn after one warm call. On the card, now and
    then a profile records no device event, or fewer events of a kernel than
    it was launched (the recorder's launch counters say how many): it is
    then taken again, up to `attempts` times in all;
    where none is complete, the one with the most device time stands
    (e2e_us 0.0 where none saw an event)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    sync()
    best = None
    for _ in range(attempts):
        before = timer.counters()
        with profile(activities=activities) as prof:
            for _ in range(steps):
                fn()
            sync()
        report = parse_profile(prof, steps, precision, device.type)
        report.launches = launches_per_step(before, timer.counters(), steps)
        if not cuda or complete(report):
            return report
        if best is None or report.e2e_us > best.e2e_us:
            best = report
    return best


def device_profile(fn: Callable[[], object], reps: int = 10,
                   device: Optional[torch.device] = None) -> Tuple[float, List[Tuple[str, float]]]:
    """Device ms per call of fn and the (name, ms per call) rows by time:
    `profile_steps` in the shape the card checks read."""
    device = device if device is not None else torch.device("cuda", torch.cuda.current_device())
    rep = profile_steps(fn, reps, device)
    return rep.e2e_us / 1e3, [(o.name, o.us / 1e3) for o in rep.ops]


def _precision_name(engine) -> str:
    return {"fp32": "float32", "bf16": "bfloat16", "int8": "bfloat16"}[
        engine.options.precision.value]


def trace_report(engine, inputs: Dict, steps: int = 5) -> TraceReport:
    """Profile `steps` of the engine's step on inputs staged on its device
    and parse the profile."""
    dev_inputs = engine._to_device(inputs)
    return profile_steps(lambda: engine.model(dev_inputs), steps, engine.model.device,
                         _precision_name(engine))
