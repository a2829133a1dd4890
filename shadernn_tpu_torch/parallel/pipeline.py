"""Pipeline parallelism: stage the layer DAG across devices (counterpart of
shadernn_tpu/parallel/pipeline.py).

The reference runs its sorted RenderStages one after another on one GPU
(core.cpp:294-432). Here the same list is cut into FLOP-balanced
contiguous segments, each placed on a device, and micro-batches of frames
stream through them (GPipe-style inference). A stage runs the builder's
graph node by node, with no fusion pass, each node on the backend that
`resolve_backend` gives it (engine/compile.py): under AUTO the
small-channel convs run on the implicit-GEMM kernel
(kernels/conv_igemm.py), as the JAX stages run `conv2d_pallas_nhwc`. A
kernel node's operands are prepared once, on its stage's device.

On CUDA every stage issues its work on a stream of its own on each of its
devices; that is what lets stage s work on micro-batch i while stage s+1
works on micro-batch i-1, on one card as across cards (the JAX package
gets this from async dispatch). A value that crosses a stage boundary is
handed over with an event recorded on the producer's stream and waited on
by the consumer's, and every tensor used on a stream other than the one
that allocated it is marked with `record_stream`, so that the caching
allocator does not give its memory to another tensor while a later stage
still reads it. `dispatch` enqueues every micro-batch without waiting on
the host. On the CPU everything runs in order on the calling thread.

`devices` holds one entry per stage: every CUDA device by default, never
the CPU unless named. An entry may repeat a device (a logical pipeline,
as a logical mesh repeats one: parallel/mesh.py), and an entry that is a
list of devices makes its stage a data-only sub-mesh (PP x DP): the
params are replicated over the group and each shard runs the stage's
nodes on its rows of the micro-batch, with no halo or gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from shadernn_tpu_torch.config import BackendKind, EngineOptions, ShardingOptions
from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.ops.registry import RunCtx, get_op
from shadernn_tpu_torch.parallel.mesh import Mesh, as_device, cuda_devices, make_mesh
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.pipeline")


@dataclasses.dataclass
class Stage:
    index: int
    nodes: List[Node]
    # graph values this stage consumes from earlier stages (node names)
    consumes: List[str]
    # values later stages (or the final output) need from this stage
    produces: List[str]
    flops: int
    device: object = None  # a torch.device, or a data-only Mesh for a sub-mesh stage
    # Per shard: the (node, view, RunCtx) triples the stage runs, in order.
    steps: list = None
    shards: dict = None  # device -> the indices of the shards on it
    streams: dict = None  # CUDA: device -> the stage's stream there

    @property
    def mesh(self) -> Optional[Mesh]:
        return self.device if isinstance(self.device, Mesh) else None

    @property
    def devices(self) -> List[torch.device]:
        """Each shard's device (one for a plain stage)."""
        m = self.mesh
        return [m.device_at(c) for c in m.coords] if m is not None else [self.device]


def split_stages(graph: Graph, num_stages: int) -> List[Stage]:
    """Cut the topo order into contiguous, FLOP-balanced segments."""
    order = [n for n in graph.toposort() if n.op != "InputLayer"]
    flops = []
    for n in order:
        in_specs = [graph.nodes[i].out_spec for i in n.inputs]
        try:
            f = get_op(n.op).flops(n, in_specs)
        except Exception:
            f = 0
        # floor per node so zero-flop ops still cost something to move
        flops.append(max(f, sum(s.num_elements for s in in_specs)))
    total = sum(flops)
    num_stages = min(num_stages, len(order))
    prefix = np.cumsum(flops)
    # Quantile cuts (forced strictly increasing so we always get exactly
    # num_stages contiguous, non-empty segments).
    cuts: List[int] = []
    for q in range(1, num_stages):
        idx = int(np.searchsorted(prefix, total * q / num_stages)) + 1
        lo = (cuts[-1] if cuts else 0) + 1
        hi = len(order) - (num_stages - q)
        cuts.append(int(np.clip(idx, lo, hi)))
    bounds = [0] + cuts + [len(order)]

    stages: List[Stage] = []
    produced_by: Dict[str, int] = {n: -1 for n in graph.input_names}
    for s in range(len(bounds) - 1):
        seg = order[bounds[s]: bounds[s + 1]]
        for n in seg:
            produced_by[n.name] = s
        stages.append(Stage(s, seg, [], [], sum(flops[bounds[s]: bounds[s + 1]])))

    # dataflow across cuts
    for s, stage in enumerate(stages):
        needed = set()
        for n in stage.nodes:
            for i in n.inputs:
                if produced_by[i] != s:
                    needed.add(i)
        stage.consumes = sorted(needed)
    for s, stage in enumerate(stages):
        later_needs = set()
        for later in stages[s + 1:]:
            later_needs.update(later.consumes)
        later_needs.update(graph.output_names)
        stage.produces = sorted({n.name for n in stage.nodes} & later_needs)
    return stages


@dataclasses.dataclass
class _Value:
    """A graph value of one micro-batch: its shards (batch slices, in order),
    each shard's device, and on CUDA the stream that made each shard and an
    event recorded there after it."""

    parts: List[torch.Tensor]
    devices: List[torch.device]
    streams: list
    ready: list


def _cache(store: dict, name: str):
    """RunCtx.cache for node `name`: make() once, then its result."""

    def get(make):
        if name not in store:
            store[name] = make()
        return store[name]

    return get


class PipelinedEngine:
    """Micro-batched pipelined inference over a stage-split graph."""

    def __init__(
        self,
        graph: Graph,
        options: Optional[EngineOptions] = None,
        devices: Optional[Sequence] = None,
        num_stages: Optional[int] = None,
        micro_batch: int = 1,
    ):
        from shadernn_tpu_torch.engine.compile import (
            _NodeView, _plan_layer_kernels, extract_params, resolve_backend, resolve_device,
        )
        from shadernn_tpu_torch.ops.conv import folded_operands
        from shadernn_tpu_torch.weights import params_from_numpy

        self.graph = graph
        self.options = options or EngineOptions()
        kind = resolve_device(self.options).type
        entries = list(devices) if devices is not None else cuda_devices()
        # Each entry is a device (plain PP) or a list of devices (PP x DP:
        # the stage becomes a data-only sub-mesh).
        placed = [make_mesh(ShardingOptions(data=len(e)), devices=list(e))
                  if isinstance(e, (list, tuple)) else as_device(e) for e in entries]
        num_stages = num_stages or len(placed)
        if not 0 < num_stages <= len(placed):
            raise ValueError(f"{num_stages} stages over {len(placed)} device entries")
        self.micro_batch = micro_batch
        if any(n.out_spec is None for n in graph.nodes.values()):
            graph.infer_shapes(batch_size=micro_batch)
        self.stages = split_stages(graph, num_stages)
        all_params = extract_params(graph)
        prec = self.options.precision
        act_dtype = prec.activation_dtype
        self._cuda = kind == "cuda"

        # Per node: KERNEL where the engine's planner puts the node on the
        # implicit-GEMM or fused-matmul kernel, else TORCH where the node
        # resolves to KERNEL (outside the kernel's gate, or an op with no
        # kernel branch: its TORCH body runs).
        order = graph.toposort()
        convs, denses, _ = _plan_layer_kernels(graph, self.options, order, set())
        on_kernel = set(convs) | set(denses)
        backends = {}
        for n in order:
            b = resolve_backend(n, graph, self.options) if n.op != "InputLayer" else None
            if b == BackendKind.KERNEL and n.name not in on_kernel:
                b = BackendKind.TORCH
            backends[n.name] = b

        for stage, dev in zip(self.stages, placed):
            stage.device = dev
            if stage.mesh is not None and micro_batch % stage.mesh.size:
                raise ValueError(f"micro_batch {micro_batch} not divisible by stage "
                                 f"{stage.index} sub-mesh size {stage.mesh.size}")
            if any(d.type != kind for d in stage.devices):
                raise ValueError(f"stage {stage.index} on {stage.devices}, but "
                                 f"EngineOptions.device is {self.options.device!r}")
            host = {k: v for k, v in all_params.items() if k in {n.name for n in stage.nodes}}
            per_device = {}  # shards on one device share its params and operands
            stage.steps, stage.shards = [], {}
            for i, d in enumerate(stage.devices):
                stage.shards.setdefault(d, []).append(i)
                if d not in per_device:
                    params = params_from_numpy(host, d)
                    cache: dict = {}
                    steps = []
                    for node in stage.nodes:
                        view = _NodeView(node, params.get(node.name, {}))
                        kernel = backends[node.name] == BackendKind.KERNEL
                        steps.append((node, view, RunCtx(
                            precision=prec, backend=backends[node.name],
                            operands=folded_operands(view, act_dtype) if kernel else None,
                            cache=None if kernel else _cache(cache, node.name))))
                    per_device[d] = steps
                stage.steps.append(per_device[d])
            if self._cuda:
                stage.streams = {d: torch.cuda.Stream(d) for d in per_device}
                for d in per_device:
                    torch.cuda.synchronize(d)  # the operands, before the streams read them
        logger.info(
            "pipeline: %d stages, flops %s",
            len(self.stages),
            [f"{s.flops / 1e6:.1f}M@{s.device}" for s in self.stages],
        )

    # -- data movement --------------------------------------------------------
    def _to(self, part, src_stream, ready, dst, dst_stream):
        """One shard onto `dst`, ordered after its producer and before the
        consumer's work on `dst_stream`."""
        if not self._cuda:
            return part.to(dst)
        if part.device == dst:
            dst_stream.wait_event(ready)
            part.record_stream(dst_stream)
            return part
        # A copy between cards runs on the source's current stream and
        # makes the destination's current stream wait for it.
        with torch.cuda.stream(src_stream), torch.cuda.stream(dst_stream):
            return part.to(dst)

    def _place(self, v: _Value, dst: List[torch.device], dst_streams) -> List[torch.Tensor]:
        """A value's shards as the devices `dst` take them: passed through
        where the layout is the same, else gathered on dst[0] and split
        over `dst` by batch rows."""
        if not self._cuda:
            if v.devices == dst:
                return v.parts
            whole = v.parts[0] if len(v.parts) == 1 else torch.cat([p.to(dst[0]) for p in v.parts])
            return [c.to(d) for c, d in zip(whole.chunk(len(dst)), dst)]
        streams = [dst_streams[d] for d in dst]
        if v.devices == dst:  # each consumer stream waits once for each event
            waited = set()
            for e, ds in zip(v.ready, streams):
                if (ds, e) not in waited:
                    ds.wait_event(e)
                    waited.add((ds, e))
            for p, ds in zip(v.parts, streams):
                p.record_stream(ds)
            return v.parts
        parts = [self._to(p, s, e, dst[0], streams[0])
                 for p, s, e in zip(v.parts, v.streams, v.ready)]
        with torch.cuda.stream(streams[0]):
            whole = parts[0] if len(parts) == 1 else torch.cat(parts)
            ev = torch.cuda.Event()
            ev.record(streams[0])
        return [self._to(c, streams[0], ev, d, ds)
                for c, d, ds in zip(whole.chunk(len(dst)), dst, streams)]

    def _run_stage(self, stage: Stage, env: Dict[str, _Value]) -> Dict[str, _Value]:
        """Queue one micro-batch through `stage`: on CUDA the shards on one
        device in turn on the stage's stream there, then one event after
        them."""
        devs = stage.devices
        staged = {k: self._place(env[k], devs, stage.streams) for k in stage.consumes}
        outs = [None] * len(devs)
        streams, ready = [None] * len(devs), [None] * len(devs)
        for d, shards in stage.shards.items():
            stream = stage.streams[d] if self._cuda else None
            with torch.cuda.stream(stream) if self._cuda else contextlib.nullcontext():
                for i in shards:
                    local = {k: parts[i] for k, parts in staged.items()}
                    for node, view, ctx in stage.steps[i]:
                        local[node.name] = get_op(node.op).run(
                            view, [local[n] for n in node.inputs], ctx)
                    outs[i] = local
                if self._cuda:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    for i in shards:
                        streams[i], ready[i] = stream, ev
        return {k: _Value([o[k] for o in outs], devs, streams, ready) for k in stage.produces}

    def _upload(self, inputs: Dict[str, object], sl: slice) -> Dict[str, _Value]:
        """Rows `sl` of each input, on stage 0's first device in the
        activation dtype (on the caller's current stream). Host frames go
        through pinned memory, so that the copy does not wait on the host
        for the work queued before it."""
        dev = self.stages[0].devices[0]
        act_dtype = self.options.precision.activation_dtype
        out = {}
        for k, v in inputs.items():
            t = torch.as_tensor(v)[sl]
            if self._cuda and t.device.type == "cpu":
                t = t.pin_memory().to(dev, non_blocking=True)
            t = t.to(dev).to(act_dtype)
            if self._cuda:
                stream = torch.cuda.current_stream(dev)
                ev = torch.cuda.Event()
                ev.record(stream)
                out[k] = _Value([t], [dev], [stream], [ev])
            else:
                out[k] = _Value([t], [dev], [None], [None])
        return out

    def _deliver(self, v: _Value) -> torch.Tensor:
        """A graph output on its first shard's device, usable on the
        caller's current stream there without a host wait."""
        dev = v.devices[0]
        cur = torch.cuda.current_stream(dev) if self._cuda else None
        parts = [self._to(p, s, e, dev, cur) for p, s, e in zip(v.parts, v.streams, v.ready)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # -- execution --------------------------------------------------------------
    def dispatch(self, inputs: Dict[str, np.ndarray], _marks: Optional[list] = None
                 ) -> List[Dict[str, torch.Tensor]]:
        """Issue all micro-batches through all stages WITHOUT blocking:
        returns the in-flight per-micro-batch outputs, ordered on the
        caller's current stream (on CUDA the host runs ahead of the card,
        which is what lets stage s execute while stage s+1 works on the
        micro-batch before). `_marks` collects, for _schedule_inversions,
        (micro-batch, stage, marker) after each stage: a timing event on
        the stage's first stream on CUDA, the host clock on the CPU."""
        batch = next(iter(inputs.values())).shape[0]
        mb = self.micro_batch
        if batch % mb:
            raise ValueError(f"batch {batch} is not a multiple of micro_batch {mb}")
        whole = self._upload(inputs, slice(None))
        inflight = []
        for m in range(batch // mb):
            env = {k: _Value([v.parts[0][m * mb:(m + 1) * mb]], v.devices, v.streams, v.ready)
                   for k, v in whole.items()}
            for stage in self.stages:
                missing = [k for k in stage.consumes if k not in env]
                if missing:
                    raise KeyError(f"stage {stage.index} missing {missing}")
                env.update(self._run_stage(stage, env))
                if _marks is not None:
                    if self._cuda:
                        mark = torch.cuda.Event(enable_timing=True)
                        mark.record(stage.streams[stage.devices[0]])
                    else:
                        mark = time.perf_counter()
                    _marks.append((m, stage.index, stage.devices[0], mark))
            inflight.append({o: self._deliver(env[o]) for o in self.graph.output_names})
        return inflight

    def _wait(self, inflight: List[Dict[str, torch.Tensor]]) -> None:
        if self._cuda:
            for d in {t.device for e in inflight for t in e.values()}:
                torch.cuda.current_stream(d).synchronize()

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Split the batch into micro-batches, stream them through the
        stages (each stage on its own stream overlaps stages across
        micro-batches), wait for them and re-assemble the global batch as
        float32."""
        inflight = self.dispatch(inputs)
        out = {o: torch.cat([e[o].float() for e in inflight]) for o in self.graph.output_names}
        self._wait([out])
        return out

    def stage_devices(self) -> List[str]:
        return [str(s.device) for s in self.stages]

    def throughput_stats(self, inputs: Dict[str, np.ndarray], iters: int = 3) -> dict:
        """Measure pipeline overlap: per-stage serial time vs pipelined
        wall time, plus the GPipe bubble model.

        With S stages and M micro-batches the ideal pipelined time is
        (S + M - 1) * t_stage (t_stage = slowest stage), i.e. a bubble
        fraction of (S-1)/(S+M-1). `overlap_efficiency` compares the
        measured wall time against the NO-overlap serial schedule
        (sum of all stage times x M): > 1/S means stages genuinely ran
        concurrently; ~1.0 means perfect overlap of balanced stages.
        On the CPU both schedules run in order on one thread.
        """
        batch = next(iter(inputs.values())).shape[0]
        m = batch // self.micro_batch
        s = len(self.stages)

        # warm both paths first so first-call costs (kernel builds, prepared
        # weights) do not masquerade as serial execution time
        self.run(inputs)

        # serial: every micro-batch through every stage, blocking each step
        t0 = time.perf_counter()
        for _ in range(iters):
            env = self._upload(inputs, slice(0, self.micro_batch))
            for stage in self.stages:
                env.update(self._run_stage(stage, env))
                if self._cuda:
                    for stream in stage.streams.values():
                        stream.synchronize()
        serial_mb_s = (time.perf_counter() - t0) / iters

        dispatch_s = 0.0
        t0 = time.perf_counter()
        for _ in range(iters):
            d0 = time.perf_counter()
            inflight = self.dispatch(inputs)
            dispatch_s += time.perf_counter() - d0
            self._wait(inflight)
        wall_s = (time.perf_counter() - t0) / iters
        dispatch_s /= iters

        inversions = self._schedule_inversions(inputs)
        serial_total_s = serial_mb_s * m
        stats = {
            "stages": s,
            "micro_batches": m,
            "serial_s": round(serial_total_s, 5),
            "pipelined_s": round(wall_s, 5),
            "speedup": round(serial_total_s / max(wall_s, 1e-9), 3),
            "bubble_fraction_model": round((s - 1) / (s + m - 1), 4),
            "overlap_efficiency": round(serial_total_s / max(wall_s, 1e-9) / s, 3),
            "dispatch_s": round(dispatch_s, 5),
            "dispatch_fraction": round(dispatch_s / max(wall_s, 1e-9), 3),
            # Schedule check (see _schedule_inversions): a serialized
            # pipeline executes (micro-batch, stage) steps strictly
            # micro-batch-major and scores 0; genuine cross-stage overlap
            # produces out-of-order executions.
            "schedule_inversions": inversions,
        }
        logger.info("pipeline throughput: %s", stats)
        return stats

    def _schedule_inversions(self, inputs: Dict[str, np.ndarray]) -> int:
        """Count out-of-micro-batch-order stage executions.

        On CUDA an event recorded on the stage's stream after its outputs
        marks when each (micro-batch, stage) step finished on the device,
        timed from a start event on the same device (stages on different
        cards are compared through their own devices' start events).
        Sorting the steps by that time, an "inversion" is a step of
        micro-batch i after any step of micro-batch j > i: stage s was
        still working on an earlier micro-batch while a later one had
        already passed an earlier stage. A blocking serial schedule yields
        exactly 0; a pipelined one yields many (stage 0 runs through its
        queue while later stages lag). On the CPU the steps run in order
        on the calling thread, so the count is 0 by construction."""
        starts = {}
        if self._cuda:
            for d in {d for st in self.stages for d in st.devices}:
                starts[d] = torch.cuda.Event(enable_timing=True)
                starts[d].record(torch.cuda.current_stream(d))
        marks: list = []
        self._wait(self.dispatch(inputs, _marks=marks))
        if self._cuda:
            for stream in {s for st in self.stages for s in st.streams.values()}:
                stream.synchronize()
            evs = [(mb, st, starts[d].elapsed_time(e)) for mb, st, d, e in marks]
        else:
            evs = [(mb, st, t) for mb, st, _d, t in marks]
        evs.sort(key=lambda e: e[2])
        inversions = 0
        max_mb_seen = -1
        for mb_idx, _stage, _t in evs:
            if mb_idx < max_mb_seen:
                inversions += 1
            max_mb_seen = max(max_mb_seen, mb_idx)
        return inversions

