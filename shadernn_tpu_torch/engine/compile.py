"""Graph -> forward function on one device (counterpart of
shadernn_tpu/engine/compile.py).

The forward walks the sorted graph eagerly. Runs of stride-1 convs that
the AUTO policy gives the kernel are planned, statically, as ONE chain on
the hand-written CUDA kernel (kernels/chain.py), with a Subpixel(2) tail
("d2s2", bfloat16) and a trailing elementwise Activation folded in, as the
JAX package plans them for its Pallas chain kernels. Every other node runs
its plain PyTorch op.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shadernn_tpu_torch.config import BackendKind, EngineOptions
from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.ops import get_op
from shadernn_tpu_torch.ops.common import ACTIVATIONS
from shadernn_tpu_torch.ops.conv import kernel_chain_supported
from shadernn_tpu_torch.ops.registry import RunCtx
from shadernn_tpu_torch.utils import get_logger
from shadernn_tpu_torch.weights import params_from_numpy

log = get_logger("snn_torch.compile")

Params = Dict[str, Dict[str, torch.Tensor]]


def extract_params(graph: Graph) -> Dict[str, Dict[str, np.ndarray]]:
    """Every node's weights as numpy arrays, keyed by node name (the same
    dict the JAX package's extract_params returns)."""
    return {
        n.name: {k: np.asarray(v) for k, v in n.params.items()}
        for n in graph.nodes.values()
        if n.params
    }


def resolve_device(options: EngineOptions) -> torch.device:
    """The engine's device. The default "cuda" needs a CUDA device: without
    one this raises instead of carrying on on the CPU."""
    dev = torch.device(options.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "EngineOptions.device='cuda' but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


@dataclasses.dataclass
class _NodeView:
    """Node proxy whose params come from the engine's tensor dict."""

    _node: Node
    params: Dict[str, torch.Tensor]

    @property
    def name(self):
        return self._node.name

    @property
    def op(self):
        return self._node.op

    @property
    def inputs(self):
        return self._node.inputs

    @property
    def attrs(self):
        return self._node.attrs

    @property
    def out_spec(self):
        return self._node.out_spec

    def attr(self, key: str, default=None):
        return self._node.attr(key, default)


def resolve_backend(node: Node, graph: Graph, options: EngineOptions) -> BackendKind:
    """Per-node backend choice.

    AUTO gives the kernel the small-channel convs with meaningful spatial
    kernels: the JAX package's gate (measured there on its TPU), kept so
    that both packages plan the same chains. Unlike the JAX package, which
    means plain XLA by AUTO off the TPU, the gate applies on every device:
    the port's CPU runs only tests, and they should see the plan the card
    runs.
    """
    configured = options.backend_for(node.name)
    if configured != BackendKind.AUTO:
        return configured
    if node.op == "Conv2D" and len(node.inputs) == 1:
        cin = graph.nodes[node.inputs[0]].out_spec.c
        wide = max(cin, int(node.attr("out_channels")))
        k = int(node.attr("kernel_size"))
        if kernel_chain_supported(node, cin) and (
            (k >= 5 and wide <= 32) or (2 <= k <= 4 and wide <= 16)
        ):
            return BackendKind.KERNEL
    return BackendKind.TORCH


# Activations that fold into the chain's f32 epilogue: every elementwise
# one the op layer knows (softmax reduces over channels; linear is a no-op),
# plus the spellings apply_activation accepts.
_FOLDABLE = tuple(a for a in ACTIVATIONS if a not in ("softmax", "linear")) + (
    "leakyrelu", "leaky relu",
)


def _plan_chains(graph: Graph, options: EngineOptions, order: List[Node]) -> dict:
    """head name -> (run, tail, tail_node, act_node, specs)."""
    from shadernn_tpu_torch.kernels.chain import build_chain_specs

    act_dtype = options.precision.activation_dtype

    def eligible(node: Node) -> bool:
        return (
            node.op == "Conv2D"
            and len(node.inputs) == 1
            and resolve_backend(node, graph, options) == BackendKind.KERNEL
            and kernel_chain_supported(node, graph.nodes[node.inputs[0]].out_spec.c)
        )

    chains: dict = {}
    if options.dump_outputs:  # intermediates must be observable
        return chains
    visited = set()
    for node in order:
        if node.name in visited or not eligible(node):
            continue
        run = [node]
        visited.add(node.name)
        while run[-1].name not in graph.output_names:
            consumers = graph.consumers(run[-1].name)
            if len(consumers) != 1:
                break
            nxt = consumers[0]
            if not (eligible(nxt) and nxt.inputs == [run[-1].name]):
                break
            run.append(nxt)
            visited.add(nxt.name)
        if len(run) < 2:
            log.info("conv %s runs on TORCH: no single-conv kernel yet", node.name)
            continue
        # Tails: o=1 heads write (N,H,W,1) ("c1"); o=4 heads feeding a
        # sole-consumer Subpixel(2) absorb the depth_to_space ("d2s2",
        # bfloat16 as in the JAX package).
        tail, tail_node = "none", None
        last = run[-1]
        o_last = int(last.attr("out_channels"))
        if o_last == 1:
            tail = "c1"
        elif o_last == 4 and act_dtype == torch.bfloat16:
            consumers = graph.consumers(last.name)
            if (
                last.name not in graph.output_names
                and len(consumers) == 1
                and consumers[0].op == "Subpixel"
                and int(consumers[0].attr("scale", 2)) == 2
            ):
                tail, tail_node = "d2s2", consumers[0]
        # A sole-consumer elementwise Activation after the tail runs in the
        # kernel's f32 epilogue (elementwise acts commute with
        # depth_to_space).
        act_node = None
        end = tail_node if tail_node is not None else last
        if tail != "none" and end.name not in graph.output_names:
            cons = graph.consumers(end.name)
            if (
                len(cons) == 1
                and cons[0].op == "Activation"
                and len(cons[0].inputs) == 1
                and str(last.attr("activation", "linear")).lower()
                in ("linear", "", "none", "identity")
                and str(cons[0].attr("activation", cons[0].attr("kind", "relu"))).lower()
                in _FOLDABLE
            ):
                act_node = cons[0]
        act_override = None
        if act_node is not None:
            act_override = (
                str(act_node.attr("activation", act_node.attr("kind", "relu"))),
                float(act_node.attr("leaky_alpha", 0.3)),
            )
        specs = build_chain_specs(
            run, graph.nodes[node.inputs[0]].out_spec.c, act_dtype,
            act_override=act_override, tail=tail,
        )
        if specs is None:
            log.warning(
                "chain at %s declined by the kernel's gate (stride, k > 9, "
                "o > 32, activation or shared memory); its convs run on TORCH",
                node.name,
            )
            continue
        chains[node.name] = (run, tail, tail_node, act_node, specs)
    return chains


def build_forward(graph: Graph, options: EngineOptions) -> Callable[[Params, dict], dict]:
    """The forward over (params, inputs) -> {output name: tensor}; with
    options.dump_outputs also every layer's output under "__dumps__".
    `forward.chain_plan` maps each chain head to the nodes it fuses."""
    from shadernn_tpu_torch.kernels.chain import (
        chain_operands, fused_conv_chain, fused_conv_chain_packed,
    )

    order = graph.toposort()
    act_dtype = options.precision.activation_dtype
    out_dtype = (
        act_dtype
        if options.output_dtype in ("activation", None)
        else getattr(torch, options.output_dtype)
    )
    chains = _plan_chains(graph, options, order)
    skip = set()
    for run, _tail, tail_node, act_node, _specs in chains.values():
        skip.update(n.name for n in run[1:])
        skip.update(n.name for n in (tail_node, act_node) if n is not None)

    def forward(params: Params, inputs: Dict[str, torch.Tensor]) -> dict:
        env: Dict[str, torch.Tensor] = {}

        def value(name: str) -> torch.Tensor:
            if name not in env:  # a model input, cast on first use
                env[name] = inputs[name].to(act_dtype)
            return env[name]

        for node in order:
            if node.name in skip or node.op == "InputLayer":
                continue
            if node.name in chains:
                run, tail, tail_node, act_node, specs = chains[node.name]
                views = [_NodeView(n, params.get(n.name, {})) for n in run]
                src = graph.nodes[node.inputs[0]]
                # An InputLayer feeds the raw frame: the kernel casts on load.
                vin = inputs[src.name] if src.op == "InputLayer" else value(src.name)
                entry = (
                    fused_conv_chain_packed
                    if options.chain_format in ("auto", "packed") and tail in ("c1", "d2s2")
                    else fused_conv_chain
                )
                res = entry(vin, chain_operands(views, act_dtype), specs,
                            tail=tail, compute_dtype=act_dtype)
                for n in (run[-1], tail_node, act_node):
                    if n is not None:
                        env[n.name] = res
                continue
            view = _NodeView(node, params.get(node.name, {}))
            ctx = RunCtx(precision=options.precision,
                         backend=resolve_backend(node, graph, options))
            env[node.name] = get_op(node.op).run(view, [value(i) for i in node.inputs], ctx)
        outs = {o: value(o).to(out_dtype) for o in graph.output_names}
        if options.dump_outputs:
            outs["__dumps__"] = {
                n.name: value(n.name).float() for n in order if n.op != "InputLayer"
            }
        return outs

    forward.chain_plan = {
        head: [n.name for n in run]
        + ([tail_node.name] if tail_node else [])
        + ([act_node.name] if act_node else [])
        for head, (run, _tail, tail_node, act_node, _specs) in chains.items()
    }
    return forward


@dataclasses.dataclass
class CompiledModel:
    """A model ready to run: graph + device params + forward."""

    graph: Graph
    options: EngineOptions
    params: Params
    forward: Callable
    input_specs: Dict[str, tuple]
    device: torch.device

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.forward(self.params, inputs)

    def load_params(self, params: Params) -> None:
        """Install parameters (e.g. from weights.params_from_numpy): the same
        nodes, names and shapes as the engine's own."""
        if set(params) != set(self.params):
            raise ValueError(
                f"params for nodes {sorted(params)} != engine's {sorted(self.params)}"
            )
        for name, cur in self.params.items():
            new = params[name]
            if set(new) != set(cur):
                raise ValueError(f"node {name!r}: keys {sorted(new)} != {sorted(cur)}")
            for k, t in cur.items():
                if tuple(new[k].shape) != tuple(t.shape):
                    raise ValueError(
                        f"{name}.{k}: shape {tuple(new[k].shape)} != {tuple(t.shape)}"
                    )
        self.params = {
            name: {k: v.to(self.device) for k, v in d.items()} for name, d in params.items()
        }


def compile_graph(graph: Graph, options: Optional[EngineOptions] = None) -> CompiledModel:
    """Shape-infer, move params to the device and plan the forward."""
    options = options or EngineOptions()
    device = resolve_device(options)
    if any(n.out_spec is None for n in graph.nodes.values()):
        graph.infer_shapes(batch_size=options.batch_size)
    params = params_from_numpy(extract_params(graph), device)
    forward = build_forward(graph, options)
    input_specs = {n: graph.nodes[n].out_spec.shape for n in graph.input_names}
    return CompiledModel(graph, options, params, forward, input_specs, device)
