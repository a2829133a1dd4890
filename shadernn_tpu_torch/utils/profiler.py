"""Per-layer profiling and roofline reporting (counterpart of
shadernn_tpu/utils/profiler.py).

Replaces the reference's -DPROFILING machinery: per-stage GPU timers
(core.cpp:402-429) and the printTimingStats table (core.cpp:436-460,
docs/Developer-Guide/Benchmarking.md:20-45).

`profile_layers` runs every layer of an engine alone, each fed the real
intermediate activations, and times `iters` back-to-back calls of it:
with CUDA events on the card, the host clock on the CPU. Each layer runs
its own op (no chain or block fusion), so the table is the unfused
layers' cost; `utils/trace_profile.py` profiles the production step. The
report adds achieved FLOP/s and bytes/s against the card's peaks
(`PEAKS`, keyed by `torch.cuda.get_device_name`).

The JAX package's `xla_cost_analysis` (XLA's own cost model of the whole
step) has no counterpart; `step_cost` sums the ops' `flops` and the
layers' bytes over the graph instead.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch


class Peaks(NamedTuple):
    """Published dense peaks of one card: bytes/s of device memory; bf16
    FLOP/s on the tensor cores; f32 FLOP/s on the CUDA cores; TF32 FLOP/s
    on the tensor cores; int8 OP/s on the tensor cores."""

    bytes_per_s: float
    bf16: float
    f32: float
    tf32: float
    int8: float


# NVIDIA's data sheets, dense rates at the full power limit.
PEAKS = {
    "H100 SXM": Peaks(3.35e12, 989e12, 67e12, 495e12, 1979e12),
    "H100 PCIe": Peaks(2.0e12, 756e12, 51e12, 378e12, 1513e12),
}


def peaks_for(name: str) -> Tuple[str, Peaks]:
    """(table key, peaks) of the card named `name`
    (torch.cuda.get_device_name): the PCIe part by its name, else SXM."""
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return key, PEAKS[key]


def _peak_flops(peaks: Peaks, precision: str) -> float:
    return {"float32": peaks.f32, "int8": peaks.int8}.get(precision, peaks.bf16)


@dataclass
class LayerProfile:
    name: str
    op: str
    out_shape: tuple
    ms: float
    flops: int
    bytes_moved: int
    device: str = "cpu"  # "cpu", or the card's name

    @property
    def tflops(self) -> float:
        return self.flops / (self.ms * 1e-3) / 1e12 if self.ms else 0.0

    @property
    def gbs(self) -> float:
        return self.bytes_moved / (self.ms * 1e-3) / 1e9 if self.ms else 0.0

    def roofline_frac(self, peak_flops: float, peak_bytes_per_s: float) -> float:
        """Max of the compute- and the memory-roofline utilization."""
        if not self.ms:
            return 0.0
        return max(self.flops / (self.ms * 1e-3) / peak_flops,
                   self.bytes_moved / (self.ms * 1e-3) / peak_bytes_per_s)


def layer_cost(graph, node, act_dtype: torch.dtype) -> Tuple[int, int]:
    """(FLOPs, bytes) of one layer run alone: each input read and the output
    written once in the activation dtype, each parameter read once."""
    from shadernn_tpu_torch.ops import get_op

    in_specs = [graph.nodes[i].out_spec for i in node.inputs]
    isz = torch.tensor([], dtype=act_dtype).element_size()
    nbytes = sum(s.num_elements for s in in_specs) * isz + node.out_spec.num_elements * isz
    nbytes += sum(p.size * p.dtype.itemsize for p in node.params.values())
    return get_op(node.op).flops(node, in_specs), nbytes


def step_cost(engine) -> Dict[str, int]:
    """The whole step's FLOPs and bytes (the layers' sums; the keys of the
    JAX package's xla_cost_analysis)."""
    act = engine.options.precision.activation_dtype
    flops = nbytes = 0
    for node in engine.graph.toposort():
        if node.op != "InputLayer":
            f, b = layer_cost(engine.graph, node, act)
            flops, nbytes = flops + f, nbytes + b
    return {"flops": flops, "bytes accessed": nbytes}


def _time_ms(fn, device: torch.device, iters: int) -> float:
    """ms per call of fn over `iters` back-to-back calls after one warm
    call: CUDA events around them on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters
    s = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - s) / iters


def profile_layers(engine, inputs: Dict[str, object], iters: int = 20) -> List[LayerProfile]:
    """Time every layer of a compiled engine alone, each fed the real
    intermediate activations (input layers excluded)."""
    from shadernn_tpu_torch.engine.compile import NodeView, resolve_backend
    from shadernn_tpu_torch.ops import get_op
    from shadernn_tpu_torch.ops.registry import RunCtx

    graph, options, params = engine.graph, engine.options, engine.model.params
    device = engine.model.device
    act = options.precision.activation_dtype
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    env = {k: v.to(act) for k, v in engine._to_device(inputs).items()}
    profiles: List[LayerProfile] = []
    with torch.no_grad():
        for node in graph.toposort():
            if node.op == "InputLayer":
                continue
            view = NodeView(node, params.get(node.name, {}))
            ctx = RunCtx(precision=options.precision,
                         backend=resolve_backend(node, graph, options))
            op = get_op(node.op)
            xs = [env[i] for i in node.inputs]

            def layer(_op=op, _view=view, _xs=xs, _ctx=ctx):
                return _op.run(_view, _xs, _ctx)

            ms = _time_ms(layer, device, iters)
            env[node.name] = layer()
            flops, nbytes = layer_cost(graph, node, act)
            profiles.append(LayerProfile(node.name, node.op, node.out_spec.shape, ms, flops,
                                         nbytes, card))
    return profiles


def print_report(profiles: List[LayerProfile], precision: str = "bfloat16") -> str:
    """The reference-style per-layer table (Benchmarking.md:20-45) with
    roofline columns against the card's peaks; a CPU run has no device
    roofline and says so."""
    card = profiles[0].device if profiles else "cpu"
    peaks: Optional[Peaks] = None if card == "cpu" else peaks_for(card)[1]
    width = max([len(p.name) for p in profiles] + [8])
    lines = [
        "===== Time stats =====",
        f"  {'layer':<{width}} {'op':<18} {'ms':>9} {'TFLOP/s':>9} {'GB/s':>8} {'roofline':>9}",
    ]
    total = 0.0
    for p in profiles:
        total += p.ms
        roof = (f"{100 * p.roofline_frac(_peak_flops(peaks, precision), peaks.bytes_per_s):8.1f}%"
                if peaks else f"{'-':>9}")
        lines.append(f"  [{p.name:<{width}}] {p.op:<16} {p.ms:9.4f} {p.tflops:9.2f} "
                     f"{p.gbs:8.1f} {roof}")
    lines.append(f"  Total GPU runtime: {total:.3f} ms"
                 + (f" ({card}; roofline vs {peaks_for(card)[0]} peaks)" if peaks
                    else " (CPU run: host clock, no device roofline)"))
    return "\n".join(lines)


def export_chrome_trace(prof, out_path: str, snap: Optional[dict] = None) -> str:
    """Write the Chrome trace of a finished torch.profiler session to
    `out_path` with the recorder's spans (utils/timer.py; `snap`, or a
    snapshot taken now) merged in: a process "snn spans" with a row for
    each thread that recorded spans, the service's dispatcher among them,
    which the profiler records no host op of. A span is placed on the
    trace's clock by the recorder's offset from the monotonic clock to the
    wall clock, against the trace's `baseTimeNanoseconds`; spans that end
    before the trace's first event or start after its last are left out."""
    from shadernn_tpu_torch.utils import timer

    snap = snap if snap is not None else timer.snapshot()
    prof.export_chrome_trace(out_path)
    with open(out_path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    base = int(trace.get("baseTimeNanoseconds", 0))
    stamps = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("ph") == "X" and "ts" in e]
    lo = min((a for a, _ in stamps), default=-math.inf)
    hi = max((b for _, b in stamps), default=math.inf)
    off = int(snap["offset_ns"]) - base
    pid = "snn spans"
    rows = set()
    for sp in snap["spans"]:
        ts, end = (sp["start_ns"] + off) / 1e3, (sp["end_ns"] + off) / 1e3
        if end < lo or ts > hi:
            continue
        rows.add(sp["thread"])
        events.append({"ph": "X", "cat": "snn_span", "name": sp["name"], "pid": pid,
                       "tid": sp["thread"], "ts": ts, "dur": end - ts,
                       "args": dict(sp["attrs"], depth=sp["depth"])})
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for tid in sorted(rows):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": snap["threads"].get(tid, str(tid))}})
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path


def capture_trace(engine, inputs: Dict[str, object], out_path: str, steps: int = 3) -> str:
    """A Chrome trace (chrome://tracing, Perfetto) of `steps` engine steps
    after one warm step, written by `export_chrome_trace`: the profiler's
    events and the recorder's spans of the steps (`snn.step`, `snn.layer`),
    the deep-dive counterpart of the per-layer table."""
    from torch.profiler import ProfilerActivity, profile

    dev_inputs = engine._to_device(inputs)
    device = engine.model.device
    cuda = device.type == "cuda"
    engine.model(dev_inputs)
    if cuda:
        torch.cuda.synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            engine.model(dev_inputs)
        if cuda:
            torch.cuda.synchronize(device)
    return export_chrome_trace(prof, out_path)
