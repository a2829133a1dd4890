"""Engine steps as CUDA graphs: the fused ingest step (image/ingest.py
`make_ingest_fn`) and `Engine.dispatch`.

A step of one frame at a time is host-bound in eager PyTorch: ESPCN 540p
b1 spends ~0.27 ms of the host dispatching ~0.13 ms of device work; so is
a batch step of a graph of many small ops (YOLOv3-tiny 416 b8: 9-12 ms of
eager dispatch against ~3.8 ms of device work). Here the step's call into
the model (`CompiledModel.__call__`; for the ingest step, with its ingest)
is captured, once per key, into a `torch.cuda.CUDAGraph`. The key is the
step (the ingest's parameters, or "dispatch") and each input's name,
device, shape and dtype. Each later call copies the inputs into the
graph's static inputs, replays the graph on the caller's current stream
and casts the outputs out into tensors of the call's own: the forward's
last cast, which the capture leaves out (compile.py `uncast_outputs`), is
that one pass.

- When: `engages(model)`, which reads only what the model is; `dispatch`
  besides needs a plan of more than one entry (`forward.paths`): a plan of
  one fused launch (ESPCN: one chain) stays eager, as a graph saves it one
  launch's host time and adds a pass over its input (ESPCN 540p b8 on an
  H100: 0.73% fewer frames/s with the graph). The first call of a
  key runs eager, as its warm-up (prepared operands, packed weights, the
  kernels' first launch); the second captures, and every call from then on
  replays. The capture call replays too, for its outputs.
- Stale weights: `CompiledModel.load_params` drops the graphs, and so does
  a call that finds any parameter tensor replaced or changed in place (its
  `_version`); the next call of each key warms again.
- Streams: the capture runs on a side stream of the model's own, into a
  memory pool of the model's own, in "thread_local" mode, since the
  service captures on its dispatcher thread while other threads run. The
  replays of one model run one after another on the device: a call on
  another stream than the last waits for that stream first.
- Lifetimes: a graph holds every tensor it reads: its static inputs, the
  parameters, the prepared operands and packed chain weights the capture's
  launches read (kernels `hold`); the ingest's constants live for the
  process (image/ingest.py `_const`).
- Counters: `engine.graph_captures`, `engine.graph_replays` and
  `engine.graph_eager` (the steps' CUDA calls that ran eager). A capture
  launches nothing; its launches are tallied (kernels `capturing`) and
  every replay adds the tally to `kernels.launches.*`. While tracing is on
  a replay is one `snn.step` span, with no `snn.layer` spans inside.

`Engine.run` goes through `dispatch`. `Engine.benchmark`,
`device_benchmark` and `trace_benchmark` call the model itself, eager.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from shadernn_tpu_torch.utils import timer

_COLD = object()  # a key that has not run yet


def waits_on_host(graph) -> bool:
    """Whether any op of the graph waits on the host in a call
    (`OpDef.waits_on_host`)."""
    from shadernn_tpu_torch.ops import get_op

    return any(get_op(n.op).waits_on_host(n, [graph.nodes[i].out_spec for i in n.inputs])
               for n in graph.nodes.values() if n.op != "InputLayer")


def engages(model) -> bool:
    """Whether the ingest step of `model` runs as CUDA graphs: on a CUDA
    device, unsharded, without `dump_outputs`, and with no op in the plan
    that waits on the host."""
    from shadernn_tpu_torch.engine.compile import ShardedModel

    return (model.device.type == "cuda" and not isinstance(model, ShardedModel)
            and not model.options.dump_outputs and not waits_on_host(model.graph))


def params_stamp(params) -> tuple:
    """Each parameter tensor's identity and version, in order."""
    return tuple((id(t), t._version) for d in params.values() for t in d.values())


class _Graph:
    __slots__ = ("graph", "input", "outputs", "launches", "held")

    def __init__(self, graph, static_input, outputs, launches, held):
        self.graph = graph
        self.input = static_input
        self.outputs = outputs
        self.launches = tuple(launches.items())
        self.held = held


def one_launch(model) -> bool:
    """Whether the model's plan runs one entry (one fused launch)."""
    return len(model.forward.paths) <= 1


class StepGraphs:
    """The CUDA graphs of one model's steps, by key: the model's `graphs`.
    `out_dtype` is the forward's output dtype; `dispatch` whether
    `Engine.dispatch` replays them too."""

    def __init__(self, device: torch.device, out_dtype: torch.dtype, dispatch: bool = False):
        self.device = device
        if device.type == "cuda" and device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.out_dtype = out_dtype
        self.dispatch = dispatch
        self.lock = threading.Lock()
        self.graphs = {}  # key -> _Graph, or None once warmed
        self.stamp = None
        self.last = None  # the stream of the last replay
        self.stream = self.pool = None  # made at the first capture

    def drop(self) -> None:
        """Forget every graph, after the replays already queued."""
        with self.lock:
            self._drop()

    def _drop(self) -> None:
        if self.last is not None and any(self.graphs.values()):
            self.last.synchronize()  # no graph's memory is freed under a replay
        self.graphs.clear()

    def check(self, params) -> None:
        """Drop the graphs if a parameter tensor was replaced or changed."""
        stamp = params_stamp(params)
        if stamp != self.stamp:
            self._drop()
            self.stamp = stamp

    def __call__(self, params, key, fn, inputs: Dict[str, torch.Tensor]):
        """fn(inputs on the model's device) -> the model's outputs, for the
        step `key`: eager on a key's first call, then replayed."""
        with self.lock:
            self.check(params)
            k = (key, tuple((name, t.device, tuple(t.shape), t.dtype)
                            for name, t in inputs.items()))
            g = self.graphs.get(k, _COLD)
            if g is None:
                g = self.graphs[k] = self._capture(params, fn, inputs)
            if g is _COLD:
                self.graphs[k] = None
                timer.count("engine.graph_eager")
                return fn({name: t.to(self.device, non_blocking=True)
                           for name, t in inputs.items()})
            if not timer.tracing():
                return self._replay(g, inputs)
            with timer.span("snn.step"):
                return self._replay(g, inputs)

    def _capture(self, params, fn, inputs: Dict[str, torch.Tensor]):
        from shadernn_tpu_torch.engine.compile import uncast_outputs
        from shadernn_tpu_torch.kernels import capturing

        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        static = {name: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for name, t in inputs.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), capturing() as (tally, held):
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"), uncast_outputs():
                outs = fn(static)
        timer.count("engine.graph_captures")
        return _Graph(graph, static, outs, tally, (params, held))

    def _replay(self, g: _Graph, inputs: Dict[str, torch.Tensor]) -> dict:
        stream = torch.cuda.current_stream(self.device)
        if self.last is not None and self.last != stream:
            stream.wait_stream(self.last)
        self.last = stream
        for name, t in inputs.items():
            g.input[name].copy_(t, non_blocking=True)
        g.graph.replay()
        outs = {name: t.to(self.out_dtype, copy=True) for name, t in g.outputs.items()}
        timer.count("engine.graph_replays")
        for name, n in g.launches:
            timer.count(name, n)
        return outs


def _graphs(model):
    """The model's `StepGraphs`, made at its first step, or False where they
    do not engage."""
    graphs = model.graphs
    if graphs is None:
        graphs = model.graphs = (StepGraphs(model.device, model.forward.out_dtype,
                                            dispatch=not one_launch(model))
                                 if engages(model) else False)
    return graphs


def run_step(model, key, fn, frames: torch.Tensor) -> dict:
    """fn(frames on the model's device) -> the model's outputs, as CUDA graphs
    of the step `key` where they engage (`engages`), else eager."""
    graphs = _graphs(model)
    if graphs:
        return graphs(model.params, key, lambda x: fn(x["frames"]), {"frames": frames})
    if model.device.type == "cuda":
        timer.count("engine.graph_eager")
    return fn(frames.to(model.device, non_blocking=True))


def run_dispatch(model, inputs: Dict[str, torch.Tensor]) -> dict:
    """model(inputs on its device), as CUDA graphs of the step "dispatch"
    where they engage for it (`engages` and a plan of more than one entry),
    else eager."""
    graphs = _graphs(model)
    if graphs and graphs.dispatch:
        return graphs(model.params, "dispatch", model, inputs)
    if model.device.type == "cuda":
        timer.count("engine.graph_eager")
    return model(inputs)
