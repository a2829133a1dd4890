"""Checks and costs of the span and counter recorder (utils/timer.py) on
the card, as one JSON line per measurement:

- ``cost``: host ms of a step with tracing off and on, in turns (off, on,
  on, off), for the benchmark's three closed-loop forms (ESPCN 540p b8 and
  StyleTransfer-candy 512 b4 through the on-device ingest and
  `Engine.dispatch`, ESPCN 540p b1 through `make_ingest_fn`), each call
  on an idle device; and the service's host ms per batch (dispatched minus
  staging began) at ``--rate`` frames/s, in blocks of 2 s with tracing
  off and on in turns.
- ``launches``: for ESPCN 540p b8, StyleTransfer-candy 512 b4 and the
  trained MobileNetV2 (32x32, b64), in BF16 and FP32: the program's own
  launches per step of each hand-written kernel (the recorder's
  `kernels.launches.*`, `utils/trace_profile.py` `profile_steps`) beside
  the profile's events per step of it, whether the profile is complete,
  and every counter per step of the unprofiled steps (`ingest.consts`,
  `engine.operand_prepares`).
- ``device_events``: the names of a profile's device events with the
  recorder's ranges open, device activity alone and with the host's ops:
  no program span may appear among them.
- ``margins``: a span around a `record_function` range on the profiled
  thread, placed on the profiler's clock by the recorder's offset: how far
  inside the span the profiler's stamps of the range lie (µs); and the
  offset's drift over the run.
- ``serve_capture``: a profile of the running service, written by
  `export_chrome_trace` to ``--out``: for each launch of the chain kernel,
  whether the profiler's host stamp of the launch (by the kernel's
  correlation id) lies inside one of the dispatcher's
  `snn.serve.step_enqueue` spans, and whether that span starts before the
  kernel does on the device; the profiler's own device start minus launch
  stamp (first, least, most, last: a drift of the trace's device clock
  against its host clock shows there); what share of the device's idle time each of the dispatcher's
  spans covers; whether each batch's stage and step-enqueue spans fit
  inside its dispatch; and the served run's counters, per batch.

    python -m shadernn_tpu_torch.tools.trace_check [--device cpu] [--out DIR]

On the CPU (`--device cpu`) it runs at small sizes and in blocks of 0.25 s,
as a rehearsal: its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from shadernn_tpu_torch import Engine, EngineOptions, Precision
from shadernn_tpu_torch.engine.streaming import StreamingEngine
from shadernn_tpu_torch.image.ingest import ingest_frames, make_ingest_fn
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.utils import timer
from shadernn_tpu_torch.utils.profiler import export_chrome_trace
from shadernn_tpu_torch.utils.trace_profile import complete, profile_steps

NORM = (1 / 255.0,)


def emit(kind: str, **fields) -> None:
    print(json.dumps({"kind": kind, **fields}), flush=True)


def engine(artifact: str, batch: int, hw, device: str, precision=Precision.BF16) -> Engine:
    return Engine.from_json(artifact, EngineOptions(precision=precision, batch_size=batch,
                                                    device=device), input_hw=hw)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def offline_step(eng: Engine, entry: str):
    name, out = eng.graph.input_names[0], eng.graph.output_names[0]
    if entry == "ingest_step":
        fn = make_ingest_fn(eng, norms=NORM)
        return lambda raw: fn(raw)[out]
    return lambda raw: eng.dispatch({name: ingest_frames(raw, norms=NORM,
                                                         dtype_name="float32")})[0][out]


def host_ms(step, raw, device, n: int) -> list:
    """Host ms of n calls, each on an idle device."""
    out = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        step(raw)
        out.append(1e3 * (time.perf_counter() - t0))
    sync(device)
    return out


def cost_offline(label, eng, entry, batch, hw, c, device, n) -> None:
    raw = torch.randint(0, 256, (batch, *hw, c), dtype=torch.uint8, device=device)
    step = offline_step(eng, entry)
    for _ in range(10):
        step(raw)
    sync(device)
    got = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on":
            timer.enable()
        try:
            got[mode] += host_ms(step, raw, device, n)
        finally:
            timer.disable()
            timer.reset()
    off, on = statistics.median(got["off"]), statistics.median(got["on"])
    emit("cost", cell=label, host_ms_off=off, host_ms_on=on, on_minus_off_ms=on - off,
         calls=2 * n)


def run_service(eng, hw, rate: float, seconds: float, on: bool, prof_at=None):
    """The service at `rate` frames/s for `seconds`; its `stats()`. With
    `prof_at`, (start, length) in seconds of a profile of the stretch."""
    frames = np.random.default_rng(3).integers(0, 256, (64, *hw, 1), dtype=np.uint8)
    svc = StreamingEngine(eng, on_result=lambda r: None, batch_window_s=0.002, max_inflight=4,
                          ingest={"means": (0.0,), "norms": NORM})
    prof = None
    if prof_at is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if eng.model.device.type == "cuda" else [])
        prof = profile(activities=acts)
    svc.start()
    if on:
        timer.enable()
    t0 = time.monotonic()
    n = int(rate * seconds)
    started = stopped = False
    try:
        for i in range(n):
            due = t0 + i / rate
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            svc.submit(i % 70, i, frames[i % len(frames)])
            now = time.monotonic() - t0
            if prof is not None and not started and now >= prof_at[0]:
                prof.__enter__()
                started = True
            if started and not stopped and now >= prof_at[0] + prof_at[1]:
                prof.__exit__(None, None, None)
                stopped = True
    finally:
        if started and not stopped:
            prof.__exit__(None, None, None)
        svc.stop(drain=True, timeout=60)
        timer.disable()
    return svc.stats(), prof


def cost_serve(eng, hw, rate, seconds) -> None:
    """Host ms per batch in blocks of `seconds`, tracing off and on in turns;
    each block's mean after its first fifth."""
    blocks = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 2:
        st, _ = run_service(eng, hw, rate, seconds, mode == "on")
        timer.reset()
        mid = st["trace"][len(st["trace"]) // 5:]
        blocks[mode].append(statistics.mean(1e3 * (r["dispatched"] - r["staging_began"])
                                            for r in mid))
    off, on = statistics.median(blocks["off"]), statistics.median(blocks["on"])
    emit("cost", cell="serve", host_ms_per_batch_off=off, host_ms_per_batch_on=on,
         on_minus_off_ms=on - off, blocks=blocks)


def device_events(eng, batch, hw, device) -> None:
    """Device-event names of a profile with the recorder's ranges open."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return
    raw = torch.randint(0, 256, (batch, *hw, 1), dtype=torch.uint8, device=device)
    step = offline_step(eng, "dispatch")
    for host in (False, True):
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        with profile(activities=acts) as prof:
            for _ in range(5):
                step(raw)
            sync(device)
        names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
        spans = [n for n in names if n.startswith("snn.")]
        emit("device_events", host_ops=host, names=names[:20], program_spans=spans,
             recorded=len(timer.snapshot()["spans"]))
        timer.reset()


def per_step(before: dict, after: dict, steps: int) -> dict:
    return {k: (n - before.get(k, 0)) / steps for k, n in sorted(after.items())
            if n != before.get(k, 0)}


def launches(label, eng, batch, hw, c, device, steps: int = 10) -> None:
    """The program's launch counts per step beside a profile's events."""
    raw = torch.randint(0, 256, (batch, *hw, c), dtype=torch.uint8, device=device)
    step = offline_step(eng, "dispatch")
    timer.reset()
    report = profile_steps(lambda: step(raw), steps, device, eng.options.precision.value)
    events = {o.name: o.count for o in report.ops if o.category == "hand-written"}
    before = timer.counters()
    for _ in range(steps):
        step(raw)
    sync(device)
    emit("launches", cell=label, precision=eng.options.precision.value, steps=steps,
         counted_per_step=report.launches, events_per_step=events,
         complete=complete(report), counters_per_step=per_step(before, timer.counters(), steps))
    timer.reset()


def margins(device, out_dir: str, n: int = 20) -> None:
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    a = torch.ones(256, 256, device=device)
    timer.reset()
    timer.enable()
    t_enable = time.monotonic()
    with profile(activities=acts) as prof:
        for _ in range(n):
            with timer.span("snn.check"):
                with record_function("snn.probe"):
                    a @ a
        sync(device)
    path = export_chrome_trace(prof, os.path.join(out_dir, "margins.json"))
    snap = timer.snapshot()
    timer.disable()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    probes = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == "snn.probe"
                    and e.get("cat") == "user_annotation")
    checks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == "snn.check"
                    and e.get("pid") == "snn spans")
    starts = [p[0] - c[0] for p, c in zip(probes, checks)]
    ends = [c[1] - p[1] for p, c in zip(probes, checks)]
    emit("margins", pairs=len(starts), contained=all(x >= 0 for x in starts + ends),
         start_inside_us=[min(starts), max(starts)] if starts else None,
         end_inside_us=[min(ends), max(ends)] if ends else None,
         offset_drift_ns=snap["offset_ns"] - snap["offset_at_enable_ns"],
         over_s=time.monotonic() - t_enable)
    timer.reset()


def union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> float:
    """Total length of the intersection of two unions of intervals."""
    total = 0.0
    for a, b in xs:
        for c, d in ys:
            lo, hi = max(a, c), min(b, d)
            if lo < hi:
                total += hi - lo
    return total


def serve_capture(eng, hw, rate, device, out_dir: str) -> None:
    timer.reset()
    st, prof = run_service(eng, hw, rate, 3.0, False, prof_at=(1.5, 0.5))
    counted, recs = timer.counters(), st["trace"]
    path = export_chrome_trace(prof, os.path.join(out_dir, "serve_trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("pid") == "snn spans" and e.get("ph") == "X"]
    names = {}
    for e in spans:
        names.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev if "conv_chain_tc_kernel" in e.get("name", "")]
    launches = {e["args"].get("correlation"): e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "aunch" in e["name"]}
    enq = names.get("snn.serve.step_enqueue", [])
    matched = before = 0
    leads, skew = [], []
    for k in kernels:
        ln = launches.get(k["args"].get("correlation"))
        if ln is None:
            continue
        # the profiler's own stamps: the launch on the host, the kernel on the device
        skew.append(k["ts"] - ln["ts"])
        inside = [s for s in enq if s[0] <= ln["ts"] <= s[1]]
        if not inside:
            continue
        matched += 1
        s = inside[0]
        before += s[0] < k["ts"]
        leads.append(k["ts"] - s[0])
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = [[a[1], b[0]] for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    idle = sum(b - a for a, b in gaps)
    cover = {n: overlap(gaps, union([(a, b) for a, b, _ in iv])) / idle if idle else None
             for n, iv in sorted(names.items()) if n.startswith("snn.serve.")}
    named = ("snn.serve.wait_frames", "snn.serve.stage", "snn.serve.step_enqueue",
             "snn.serve.route")
    four = union([(a, b) for n in named for a, b, _ in names.get(n, [])])
    fit = [r for r in recs if (r["staged"] - r["staging_began"]) + (
        r["step_queued"] - r["upload_queued"]) <= r["dispatched"] - r["staging_began"]]
    emit("serve_capture", trace=path, kernels=len(kernels), runtime_launches=len(launches),
         launches_inside_enqueue_span=matched, enqueue_starts_before_kernel=before,
         lead_us=[min(leads), statistics.median(leads), max(leads)] if leads else None,
         kernel_minus_launch_us=([skew[0], min(skew), max(skew), skew[-1]] if skew else None),
         idle_ms=idle / 1e3, busy_ms=sum(b - a for a, b in busy) / 1e3,
         idle_covered=cover, idle_covered_by_four=overlap(gaps, four) / idle if idle else None,
         dispatcher_rows=sorted({t for iv in names.values() for _, _, t in iv}),
         batches=len(recs), stage_plus_enqueue_within_dispatch=len(fit))
    emit("counters", scope="serve_capture", batches=st["batches_run"],
         per_batch=per_step({}, counted, max(st["batches_run"], 1)), **counted)
    timer.reset()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join("build", "trace_check"))
    p.add_argument("--rate", type=float, default=2100.0)
    p.add_argument("--calls", type=int, default=100)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cpu = device.type == "cpu"
    esp_hw, sty_hw = ((36, 64), (32, 32)) if cpu else ((540, 960), (512, 512))
    rate = 300.0 if cpu else args.rate
    if not cpu:
        emit("device", name=torch.cuda.get_device_name(device), torch=torch.__version__)
    esp8 = engine(zoo.ESPCN_TRAINED, 8, esp_hw, args.device)
    device_events(esp8, 8, esp_hw, device)
    margins(device, args.out)
    cost_offline("espcn-540p-b8", esp8, "dispatch", 8, esp_hw, 1, device, args.calls)
    sty = engine(zoo.STYLE512_TRAINED["candy"], 4, sty_hw, args.device)
    cost_offline("styletransfer-candy-512-b4", sty, "dispatch", 4, sty_hw, 3, device,
                 max(args.calls // 5, 4))
    del sty
    esp1 = engine(zoo.ESPCN_TRAINED, 1, esp_hw, args.device)
    cost_offline("espcn-540p-b1", esp1, "ingest_step", 1, esp_hw, 1, device, args.calls)
    del esp1
    cost_serve(esp8, esp_hw, rate, 0.25 if cpu else 2.0)
    for prec in (Precision.BF16, Precision.FP32):
        for label, art, batch, hw, c in (
                ("espcn-540p-b8", zoo.ESPCN_TRAINED, 8, esp_hw, 1),
                ("styletransfer-candy-512-b4", zoo.STYLE512_TRAINED["candy"], 4, sty_hw, 3),
                ("mobilenetv2-cls10-b64", zoo.MOBILENETV2_TRAINED, 8 if cpu else 64, (32, 32), 3)):
            launches(label, engine(art, batch, hw, args.device, prec), batch, hw, c, device,
                     steps=2 if cpu else 10)
    serve_capture(esp8, esp_hw, rate, device, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
