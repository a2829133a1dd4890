"""Reading a `torch.profiler` trace of a stretch of the window.

Frozen here so that a change to the program cannot move the yardstick:
the hand-written kernels' names (the port's `csrc/*.cu` identifiers, as
the demangled name holds them) and the reduction of device events to busy
time, idle gaps and a per-name table. Only the device's own events count:
kernels, copies and fills. A CPU op's device time repeats its kernels'.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

HAND_WRITTEN = re.compile(r"\b(conv_chain(_tc|_tf32)?|conv_single(_tc|_tf32|_wide|_fma)?|"
                          r"invres(_tc|_tf32)?|"
                          r"conv_igemm(_tc)?|matmul_fused)_kernel\b")


def category(key: str) -> Tuple[str, str]:
    """(row name, "hand-written" | "library" | "memcpy" | "memset")."""
    m = HAND_WRITTEN.search(key)
    if m:
        return m.group(0), "hand-written"
    if key.startswith("Memcpy"):
        return key, "memcpy"
    if key.startswith("Memset"):
        return key, "memset"
    return key, "library"


def device_table(prof, device_type) -> Dict[str, dict]:
    """{row name: {"category", "us", "count"}} summed over the trace."""
    rows: Dict[str, dict] = {}
    for ev in prof.key_averages():
        if ev.device_type != device_type or ev.key.startswith("ProfilerStep"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if device_type.name == "CPU":
            us = ev.self_cpu_time_total
        if us <= 0:
            continue
        name, cat = category(ev.key)
        row = rows.setdefault(name, {"category": cat, "us": 0.0, "count": 0})
        row["us"] += us
        row["count"] += ev.count
    return rows


def complete(rows: Dict[str, dict], steps: int) -> bool:
    """Whether every launch was recorded: each name's events are a whole
    multiple of the step count, and there is at least one."""
    return bool(rows) and all(r["count"] % steps == 0 for r in rows.values())


def intervals(prof, device_type) -> Tuple[list, list]:
    """(device intervals, host op intervals with names), in microseconds on
    the trace's clock."""
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.name.startswith("ProfilerStep"):
            continue
        if ev.device_type == device_type:
            dev.append((tr.start, tr.end))
        elif ev.device_type.name == "CPU" and not ev.name.startswith("ProfilerStep"):
            host.append((tr.start, tr.end, ev.name))
    return dev, host


def union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_gaps(busy: List[Tuple[float, float]], host, top: int = 10) -> List[Tuple[str, float]]:
    """The longest gaps between device intervals, each labelled by the
    innermost host op running at its middle ("host outside any op"
    where none was recorded),
    longest first, in seconds."""
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        inside = [h for h in host if h[0] <= mid <= h[1]]
        label = max(inside, key=lambda h: h[0])[2] if inside else "host outside any op"
        out.append((label, length * 1e-6))
    return out
