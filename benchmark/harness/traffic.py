"""The one traffic generator: every mix is a data file (`traffic/<mix>.json`)
of parameters that this module reads.

- ``"loop": "closed"``: steps of ``batch`` uint8 frames, from a pool of
  ``pool_batches`` distinct batches made on the device from the seed, go
  through ``entry`` (``"dispatch"``: the on-device ingest, then
  `Engine.dispatch`; ``"ingest_step"``: the ingest step fused with the
  model). ``in_flight`` 0 queues them back to back; 1 waits for each
  step's output on the device and times each frame by CUDA events, from
  the call to the output (the host's dispatch is inside).
- ``"loop": "open"``: ``streams`` independent streams of ``fps`` frames a
  second each, with phases drawn from the seed (``"phase": "random"``) or
  all at 0 (``"aligned"``), offered to the continuous-batching service
  from one generator thread on a fixed schedule. Frames come from a host
  pool of ``pool_frames`` distinct uint8 frames. The service runs for
  ``preroll_s`` before the window, so that its queue is steady when the
  window opens. A frame's latency runs from its due time to its result on
  the host. Every frame due in the window is waited for, up to
  ``drain_s`` past the close; one that never comes is failed.

A traced run (``trace``) runs the same window and, at ``trace_at`` of it,
profiles a short stretch: ``profile_steps`` steps of a closed loop (then
``probe_steps`` steps, each called on an idle device, for the dispatch
span), or ``profile_s`` seconds of an open loop.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import trace as tr


@dataclasses.dataclass
class Window:
    attempted: int
    completed: int  # frames completed inside the window
    failed: int
    window_s: float
    t_start: float  # monotonic time of the first measured frame
    latencies_ms: Optional[List[float]]  # every frame due in the window (failed: inf)
    answers: list  # [(uint8 frames, outputs or a dict of named outputs)] for the check
    steps: int = 0
    step_s: float = 0.0  # host seconds per step outside the traced stretch
    trace: Optional[dict] = None
    service_stats: Optional[dict] = None
    timeline: Optional[list] = None
    window_bounds: Optional[tuple] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def device_frames(seed: int, n: int, h: int, w: int, c: int, device) -> torch.Tensor:
    """n distinct uint8 frames made on the device from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, c), generator=g, dtype=torch.uint8, device=device)


def host_frames(seed: int, n: int, h: int, w: int, c: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c), dtype=np.uint8)


def _profiler(cuda: bool, host: bool = True, **kw):
    """A profiler of the device's activity (CUDA, or on the CPU its ops),
    with the host's ops too where `host`."""
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    return profile(activities=acts, **kw)


def _device_type(cuda: bool):
    from torch.autograd import DeviceType

    return DeviceType.CUDA if cuda else DeviceType.CPU


def _read_profile(prof, cuda: bool, steps: int) -> dict:
    """Per-name device time, busy time (the union of the device's
    intervals) and the traced window: from the first device event's start
    to the last one's end."""
    dt = _device_type(cuda)
    rows = tr.device_table(prof, dt)
    dev, host = tr.intervals(prof, dt)
    busy = tr.union(dev)
    return {"rows": rows, "steps": steps,
            "window_s": (busy[-1][1] - busy[0][0]) * 1e-6 if busy else 0.0,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "gaps": tr.idle_gaps(busy, host), "complete": tr.complete(rows, max(steps, 1))}


def _closed_stretch(program, step, batches, traffic, sync_each: bool) -> dict:
    """The traced stretch of a closed loop: a profile of the device alone
    over `profile_steps` steps as the window runs them (taken again, up to
    three times, where it misses a launch); a shorter one with the host's
    ops, whose idle gaps are labelled by what the host was doing; then
    `probe_steps` dispatch spans on an idle device."""
    cuda = program.device.type == "cuda"
    k = int(traffic["profile_steps"])

    def profiled(steps, host):
        program.sync()
        with _profiler(cuda, host) as prof:
            for i in range(steps):
                step(batches[i % len(batches)])
                if sync_each:
                    program.sync()
            program.sync()
        return _read_profile(prof, cuda, steps)

    out = None
    for _ in range(3):
        got = profiled(k, host=False)
        if out is None or got["busy_s"] > out["busy_s"]:
            out = got
        if got["complete"] or not cuda:
            break
    out["gaps"] = profiled(max(k // 3, 2), host=True)["gaps"]
    spans = []
    for i in range(int(traffic["probe_steps"])):
        program.sync()
        t0 = time.perf_counter()
        step(batches[i % len(batches)])
        spans.append(time.perf_counter() - t0)
    program.sync()
    out["dispatch_ms"] = [1e3 * s for s in spans]
    return out


def closed_loop(program, config: dict, traffic: dict, seed: int, seconds: float,
                trace: bool) -> Window:
    inp = config["input"]
    b, n_pool = int(traffic["batch"]), int(traffic["pool_batches"])
    pool = device_frames(seed, n_pool * b, inp["height"], inp["width"], inp["channels"],
                         program.device)
    batches = [pool[i * b:(i + 1) * b] for i in range(n_pool)]
    step = program.step(traffic["entry"])
    sync_each = int(traffic["in_flight"]) == 1
    cuda = program.device.type == "cuda"
    for i in range(int(traffic["warm_steps"])):  # every shape the window uses
        step(batches[i % n_pool])
        program.sync()
    kept: List = [None] * n_pool
    lat: List[float] = []
    trace_at = seconds * float(traffic["trace_at"]) if trace else math.inf
    traced, stretch_s, steps = None, 0.0, 0
    if cuda:
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_start = time.monotonic()
    while True:
        i = steps % n_pool
        if sync_each:
            if cuda:
                ev0.record()
                kept[i] = step(batches[i])
                ev1.record()
                ev1.synchronize()
                lat.append(ev0.elapsed_time(ev1))
            else:
                t0 = time.perf_counter()
                kept[i] = step(batches[i])
                lat.append(1e3 * (time.perf_counter() - t0))
        else:
            kept[i] = step(batches[i])
        steps += 1
        now = time.monotonic()
        if now - t_start >= trace_at:
            trace_at = math.inf
            program.sync()
            t0 = time.monotonic()
            traced = _closed_stretch(program, step, batches, traffic, sync_each)
            now = time.monotonic()
            stretch_s = now - t0
        if now - t_start >= seconds and steps >= n_pool:  # every pool batch has an answer
            break
    program.sync()
    window_s = time.monotonic() - t_start
    answers = [(batches[i], kept[i]) for i in range(n_pool) if kept[i] is not None]
    return Window(attempted=steps * b, completed=steps * b, failed=0, window_s=window_s,
                  t_start=t_start, latencies_ms=lat if sync_each else None, answers=answers,
                  steps=steps, step_s=(window_s - stretch_s) / steps, trace=traced)


def schedule(seed: int, streams: int, fps: float, horizon_s: float,
             phase: str) -> Dict[str, np.ndarray]:
    """Every frame due before `horizon_s`: its due offset (s), stream and
    frame number, in due order. Stream s sends frame k at phi_s + k / fps."""
    if phase == "random":
        phi = np.random.default_rng(seed).random(streams) / fps
    elif phase == "aligned":
        phi = np.zeros(streams)
    else:
        raise ValueError(f"unknown phase {phase!r}")
    per = int(math.ceil(horizon_s * fps)) + 1
    due = phi[:, None] + np.arange(per)[None, :] / fps
    s, k = np.meshgrid(np.arange(streams), np.arange(per), indexing="ij")
    keep = due < horizon_s
    due, s, k = due[keep], s[keep], k[keep]
    order = np.argsort(due, kind="stable")
    return {"due": due[order], "stream": s[order], "frame": k[order]}


def open_loop(program, config: dict, traffic: dict, seed: int, seconds: float,
              trace: bool) -> Window:
    inp = config["input"]
    pre = float(traffic["preroll_s"])
    sched = schedule(seed, int(traffic["streams"]), float(traffic["fps"]), pre + seconds,
                     traffic["phase"])
    n = len(sched["due"])
    n_pool = int(traffic["pool_frames"])
    pool = host_frames(seed, n_pool, inp["height"], inp["width"], inp["channels"])
    pool_of = (sched["stream"] * 7919 + sched["frame"]) % n_pool
    in_window = np.flatnonzero(sched["due"] >= pre)
    rng = np.random.default_rng(seed + 1)
    sample = set(rng.choice(in_window, size=min(int(traffic["sample_frames"]), len(in_window)),
                            replace=False).tolist())
    done = np.full(n, np.nan)
    kept: Dict[int, object] = {}
    out_name, out_names = program.out_name, program.out_names

    def on_result(r):
        done[r.frame_id] = time.monotonic()
        if r.frame_id in sample:
            kept[r.frame_id] = ({k: r.outputs[k].copy() for k in out_names} if out_names
                                else r.outputs[out_name].copy())

    # warm the step (the kernels' first launches) before the service starts
    b = int(traffic["batch"])
    warm = program.step("ingest_step")
    warm(torch.as_tensor(pool[:b]).to(program.device))
    program.sync()
    # A traced run profiles `profile_s` seconds of the window. The profiler
    # is made ready before the service starts, and started and stopped on
    # this thread, the one that loaded it (it refuses another); it records
    # the device work of every thread.
    prof, marks = None, []
    if trace:
        from torch.profiler import schedule as stages

        a = time.perf_counter()
        prof = _profiler(program.device.type == "cuda",
                         schedule=stages(wait=0, warmup=1, active=1, repeat=1))
        prof.__enter__()  # warm-up: the profiler's own set-up, before the window
        marks.append(("ready", time.perf_counter() - a))
    svc = program.service(on_result, float(traffic["batch_window_s"]),
                          int(traffic["max_inflight"]), int(traffic["queue_capacity"]))
    svc.start()
    t0 = time.monotonic() + 0.05
    t_on = t0 + pre + float(traffic["trace_at"]) * seconds if trace else math.inf
    t_off = t_on + float(traffic["profile_s"])
    late = np.full(n, np.nan)
    due_abs = t0 + sched["due"]
    error = None
    try:
        for i in range(n):
            wait = due_abs[i] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            svc.submit(int(sched["stream"][i]), i, pool[pool_of[i]])
            now = time.monotonic()
            late[i] = now - due_abs[i]
            if now >= t_on:
                a = time.perf_counter()
                prof.step()  # warm-up -> recording
                marks.append(("start", time.perf_counter() - a))
                t_on = math.inf
            elif now >= t_off:
                a = time.perf_counter()
                prof.step()  # recording -> stopped
                marks.append(("stop", time.perf_counter() - a))
                t_off = math.inf
    except RuntimeError as e:  # the dispatcher failed: the rest never comes
        error = e
    finally:
        try:
            svc.stop(drain=True, timeout=float(traffic["drain_s"]))
        except RuntimeError as e:
            error = error or e
    traced = None
    if prof is not None:
        if t_off != math.inf:  # the loop ended first
            prof.step()
        traced = _read_profile(prof, program.device.type == "cuda", 0)
        prof.__exit__(None, None, None)
    if error is not None:
        print(f"[serve] the service failed: {error!r}", file=sys.stderr)
    w0, w1 = t0 + pre, t0 + pre + seconds
    lat = (done[in_window] - due_abs[in_window]) * 1e3
    failed = int(np.isnan(lat).sum())
    lat = np.where(np.isnan(lat), np.inf, lat)
    completed = int(((done >= w0) & (done < w1)).sum())
    lw = late[in_window]
    lw = lw[~np.isnan(lw)] if (~np.isnan(lw)).any() else np.zeros(1)
    notes = [f"[trace] profiler {', '.join(f'{k} {1e3 * v:.1f} ms' for k, v in marks)}"
             ] if marks else []
    notes += [f"[serve] generator lateness over the window's {len(lw)} frames: p50 "
             f"{1e3 * np.percentile(lw, 50):.4f} ms, p99 {1e3 * np.percentile(lw, 99):.4f} ms, "
             f"max {1e3 * lw.max():.4f} ms; first half mean "
             f"{1e3 * lw[:len(lw) // 2].mean():.4f} ms, "
             f"second half {1e3 * lw[len(lw) // 2:].mean():.4f} ms; offered "
             f"{len(in_window) / seconds:.1f} frames/s"]
    keys = sorted(kept)
    answers = []
    if keys:
        outs = ({name: torch.as_tensor(np.stack([kept[k][name] for k in keys]))
                 for name in out_names} if out_names
                else torch.as_tensor(np.stack([kept[k] for k in keys])))
        answers = [(torch.as_tensor(pool[pool_of[keys]]), outs)]
    if len(keys) < len(sample):
        notes.append(f"[serve] {len(sample) - len(keys)} sampled frames never came")
    return Window(attempted=len(in_window), completed=completed, failed=failed,
                  window_s=seconds, t_start=w0, latencies_ms=lat.tolist(), answers=answers,
                  trace=traced, service_stats=svc.stats(), timeline=list(svc.timeline),
                  window_bounds=(w0, w1), notes=notes)


DRIVERS = {"closed": closed_loop, "open": open_loop}


def drive(program, config: dict, traffic: dict, seed: int, seconds: float, trace: bool) -> Window:
    return DRIVERS[traffic["loop"]](program, config, traffic, seed, seconds, trace)
