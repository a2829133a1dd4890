"""Graph -> forward function on one device (counterpart of
shadernn_tpu/engine/compile.py).

The forward walks the sorted graph eagerly. Five plans are made
statically, as the JAX package makes them for its Pallas kernels:

- runs of stride-1 convs that the AUTO policy gives the kernel become ONE
  chain on the conv-chain CUDA kernel (kernels/chain.py), with a
  Subpixel(2) tail ("d2s2", bfloat16) and a trailing elementwise
  Activation folded in;
- such a conv that no chain takes (a run of one, or a run the chain
  kernel's gate declines) runs alone on the single-conv kernel
  (kernels/conv.py);
- [1x1 expand] -> 3x3 depthwise -> 1x1 project [-> Add] around each
  SeparableConv2D on AUTO or KERNEL becomes ONE inverted-residual block
  on the block kernel (kernels/invres.py);
- a Conv2D whose backend resolves to KERNEL and that none of these took
  (a multi-input conv, which no chain takes, or a conv that the
  single-conv kernel's gate declines) runs on the per-layer implicit-GEMM
  kernel (kernels/conv_igemm.py), through the KERNEL branch of its op;
- a Dense given to KERNEL runs on the fused-matmul kernel
  (kernels/matmul.py), through the KERNEL branch of its op.

Every other node runs its plain PyTorch op. A Conv2D or Dense that was
given to KERNEL and that no kernel's gate admits runs on TORCH too, with
a log line that names the gate: the decision is made here, never at
launch time.

Under INT8 (bfloat16 activations, int8 weights) the planners also set the
int8 activations of a calibrated graph, as the JAX package does: a packed
chain's per-layer `in_q` (kernels/chain.py a8_scales, unless
`chain_a8="off"`; logged per chain with the reason for each layer), a
block's `ax1`/`ax2` (kernels/invres.py build_invres), and, through
`propagate_input_scales` before planning, the `in_act_scale` that the
TORCH path's A8W8 reads (ops/conv.py a8w8_engaged).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from shadernn_tpu_torch.config import BackendKind, EngineOptions
from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.ops import get_op
from shadernn_tpu_torch.ops.common import ACTIVATIONS
from shadernn_tpu_torch.ops.conv import folded_operands, kernel_chain_supported
from shadernn_tpu_torch.ops.registry import RunCtx
from shadernn_tpu_torch.quant.calibrate import propagate_input_scales
from shadernn_tpu_torch.utils import get_logger, timer
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


def _plan_chains(graph: Graph, options: EngineOptions, order: List[Node]):
    """(chains, singles): head name -> (run, tail, tail_node, act_node,
    specs), and the names of the convs that run alone on the single-conv
    kernel."""
    from shadernn_tpu_torch.kernels.chain import a8_scales, build_chain_specs
    from shadernn_tpu_torch.kernels.conv import single_conv_supported

    act_dtype = options.precision.activation_dtype
    a8 = options.precision.is_quantized and options.chain_a8 != "off"

    def eligible(node: Node) -> bool:
        return (
            node.op == "Conv2D"
            and len(node.inputs) == 1
            and resolve_backend(node, graph, options) == BackendKind.KERNEL
            and kernel_chain_supported(node, graph.nodes[node.inputs[0]].out_spec.c)
        )

    chains: dict = {}
    singles: List[str] = []

    def alone(run: List[Node], why: str) -> None:
        for n in run:
            if single_conv_supported(n, graph.nodes[n.inputs[0]].out_spec.c, act_dtype):
                log.info("conv %s runs alone on the single-conv kernel (%s)", n.name, why)
                singles.append(n.name)
            else:
                # Its backend resolved to KERNEL (forced, or by the AUTO
                # policy), so _plan_layer_kernels sees it next and logs where
                # it runs: the implicit-GEMM kernel or TORCH.
                log.info("conv %s declined by the single-conv kernel's gate (activation, "
                         "int8 weights under float32 activations, or shared memory); the "
                         "per-layer kernel plan decides where it runs", n.name)

    visited = set()
    for node in order:
        if node.name in visited or not eligible(node):
            continue
        if options.dump_outputs:  # intermediates must be observable: no chains
            alone([node], "outputs dumped")
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
            alone(run, "a chain of one")
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
            # As the JAX package falls back: the convs one by one, then the
            # Subpixel and the Activation as their own ops.
            log.warning(
                "chain at %s declined by the kernel's gate (stride, k > 9, "
                "o > 32, activation or shared memory); its convs run one by one",
                node.name,
            )
            alone(run, f"chain at {node.name} declined")
            continue
        if a8 and options.chain_format in ("auto", "packed") and tail in ("c1", "d2s2"):
            # The packed entry's int8 dots, as the JAX package plans them; a
            # declined layer runs the bf16 dot there too.
            specs, notes = a8_scales(run, specs, graph.nodes[node.inputs[0]].op == "InputLayer")
            log.info("chain at %s, int8 dots: %s", node.name, "; ".join(
                f"{name} in_q {q:.6g} ({why})" if q else f"{name} bf16 ({why})"
                for name, q, why in notes))
        chains[node.name] = (run, tail, tail_node, act_node, specs)
    return chains, singles


def _plan_blocks(graph: Graph, options: EngineOptions, order: List[Node], taken: set) -> dict:
    """head name -> ((expand, dw, project, add), InvResSpec, (in_act_scale,
    a8w8)) for each inverted-residual block the kernel takes; `taken` holds
    the names that chains (and earlier blocks) already run and grows with
    each block's members other than its head."""
    from shadernn_tpu_torch.kernels.invres import build_invres, match_invres_block

    blocks: dict = {}
    if options.dump_outputs:  # intermediates must be observable
        return blocks
    int8 = options.precision.is_quantized
    for node in order:
        if node.op != "SeparableConv2D" or options.backend_for(node.name) not in (
            BackendKind.AUTO, BackendKind.KERNEL,
        ):
            continue
        m = match_invres_block(graph, node)
        if m is None:
            continue
        expand, dw, _project, _add = m
        head = expand if expand is not None else dw
        members = [n for n in m if n is not None]
        if any(n.name in taken for n in members):
            continue
        in_node = graph.nodes[head.inputs[0]]
        # A8W8 scales only under an INT8 engine: a calibrated graph rebuilt
        # at FP32/BF16 runs float activations.
        a8w8 = (float(in_node.attrs.get("act_scale", 0.0) or 0.0) if int8 else 0.0, int8)
        built = build_invres(m, in_node.out_spec, options.precision.activation_dtype, *a8w8)
        if built is None:
            log.info("block at %s declined by the kernel's gate (activation, Cout > 320 "
                     "or shared memory); its ops run on TORCH", head.name)
            continue
        if int8:
            log.info("block at %s: expand %s, project %s", head.name,
                     f"int8 (ax1 {built[1].ax1:.6g})" if built[1].ax1 else "bf16",
                     f"int8 (ax2 {built[1].ax2:.6g})" if built[1].ax2 else "bf16")
        blocks[head.name] = (m, built[1], a8w8)
        taken.update(n.name for n in members if n is not head)
    return blocks


def _plan_layer_kernels(graph: Graph, options: EngineOptions, order: List[Node], taken: set):
    """(convs, denses, on_torch): the names of the Conv2D nodes given to
    KERNEL that run on the implicit-GEMM kernel, of the Dense nodes that run
    on the fused-matmul kernel, and of the KERNEL nodes of both kinds that
    no kernel's gate admits. `taken` holds what chains, blocks and single
    convs already run."""
    from shadernn_tpu_torch.kernels import conv_igemm, matmul

    convs: List[str] = []
    denses: List[str] = []
    on_torch = set()
    for node in order:
        if (
            node.op not in ("Conv2D", "Dense")
            or node.name in taken
            or resolve_backend(node, graph, options) != BackendKind.KERNEL
        ):
            continue
        if node.op == "Conv2D":
            cin = sum(graph.nodes[i].out_spec.c for i in node.inputs)
            kind, plan, gate = "conv", convs, conv_igemm.GATE
            ok = conv_igemm.igemm_conv_supported(node, cin)
        else:
            kind, plan, gate = "dense", denses, matmul.GATE
            ok = matmul.dense_supported(node)
        if ok:
            log.info("%s %s runs on the %s kernel", kind, node.name,
                     "implicit-GEMM" if kind == "conv" else "fused-matmul")
            plan.append(node.name)
        else:
            log.info("%s %s given to KERNEL runs on TORCH: outside the %s",
                     kind, node.name, gate)
            on_torch.add(node.name)
    return convs, denses, on_torch


def build_forward(graph: Graph, options: EngineOptions) -> Callable[[Params, dict], dict]:
    """The forward over (params, inputs) -> {output name: tensor}; with
    options.dump_outputs also every layer's output under "__dumps__".
    `forward.chain_plan` and `forward.block_plan` map each chain or block
    head to the nodes it fuses (`forward.chain_specs` and
    `forward.block_specs` to its kernel's specs); `forward.single_conv_plan`,
    `forward.kernel_conv_plan` and `forward.kernel_dense_plan` list the
    nodes that run alone on the single-conv, implicit-GEMM and fused-matmul
    kernels."""
    from shadernn_tpu_torch.kernels.chain import (
        chain_operands, fused_conv_chain, fused_conv_chain_packed,
    )
    from shadernn_tpu_torch.kernels.conv import conv_run_kernel
    from shadernn_tpu_torch.kernels.invres import (
        build_invres, fused_invres_block, prepare_operands,
    )

    order = graph.toposort()
    act_dtype = options.precision.activation_dtype
    out_dtype = (
        act_dtype
        if options.output_dtype in ("activation", None)
        else getattr(torch, options.output_dtype)
    )
    chains, singles = _plan_chains(graph, options, order)
    skip = set()
    for run, _tail, tail_node, act_node, _specs in chains.values():
        skip.update(n.name for n in run[1:])
        skip.update(n.name for n in (tail_node, act_node) if n is not None)
    blocks = _plan_blocks(graph, options, order, skip | set(chains))
    for head, (members, _spec, _a8w8) in blocks.items():
        skip.update(n.name for n in members if n is not None and n.name != head)
    singles = [n for n in singles if n not in skip and n not in blocks]
    kernel_convs, kernel_denses, on_torch = _plan_layer_kernels(
        graph, options, order, skip | set(chains) | set(blocks) | set(singles))
    layer_kernels = set(kernel_convs) | set(kernel_denses)
    prepared: Dict[str, tuple] = {}

    def operands(head: str, views, make):
        """The kernel operands of a planned chain, block, conv or dense
        layer (weights cast, epilogues folded), or the weight of a TORCH
        layer (ops/conv.py layer_weight), prepared once for each set of
        parameter tensors: `CompiledModel.load_params` installs new
        tensors, which prepares them anew."""
        key = tuple(t for v in views if v is not None for t in v.params.values())
        hit = prepared.get(head)
        if hit is None or len(hit[0]) != len(key) or any(a is not b for a, b in zip(hit[0], key)):
            timer.count("engine.operand_prepares")
            hit = prepared[head] = (key, make())
        return hit[1]

    # Each planned entry's path, the `path` of its `snn.layer` span.
    paths = {}
    for node in order:
        if node.name in skip or node.op == "InputLayer":
            continue
        paths[node.name] = ("block" if node.name in blocks else "chain" if node.name in chains
                            else "single" if node.name in singles
                            else "kernel" if node.name in layer_kernels else "torch")

    def forward(params: Params, inputs: Dict[str, torch.Tensor]) -> dict:
        env: Dict[str, torch.Tensor] = {}

        def value(name: str) -> torch.Tensor:
            if name not in env:  # a model input, cast on first use
                env[name] = inputs[name].to(act_dtype)
            return env[name]

        def run_entry(node: Node) -> None:
            if node.name in blocks:
                members, spec, a8w8 = blocks[node.name]
                views = [_NodeView(n, params.get(n.name, {})) if n is not None else None
                         for n in members]
                ops = operands(node.name, views, lambda: prepare_operands(build_invres(
                    views, graph.nodes[node.inputs[0]].out_spec, act_dtype, *a8w8)[0], spec,
                    act_dtype))
                out = members[3] if members[3] is not None else members[2]
                env[out.name] = fused_invres_block(
                    value(node.inputs[0]).contiguous(), ops, spec)
                return
            if node.name in chains:
                run, tail, tail_node, act_node, specs = chains[node.name]
                views = [_NodeView(n, params.get(n.name, {})) for n in run]
                src = graph.nodes[node.inputs[0]]
                # An InputLayer feeds the raw frame: the kernel casts on load.
                vin = inputs[src.name] if src.op == "InputLayer" else value(src.name)
                vin = vin.contiguous()
                entry = (
                    fused_conv_chain_packed
                    if options.chain_format in ("auto", "packed") and tail in ("c1", "d2s2")
                    else fused_conv_chain
                )
                res = entry(vin, operands(node.name, views,
                                          lambda: chain_operands(views, act_dtype, specs)),
                            specs, tail=tail, compute_dtype=act_dtype)
                for n in (run[-1], tail_node, act_node):
                    if n is not None:
                        env[n.name] = res
                return
            view = _NodeView(node, params.get(node.name, {}))
            if node.name in singles:
                env[node.name] = conv_run_kernel(
                    view, value(node.inputs[0]).contiguous(), act_dtype,
                    operands(node.name, [view], lambda: folded_operands(view, act_dtype)))
                return
            # The op bodies own the per-layer kernels' branch: a planned node
            # gets KERNEL and its prepared operands, a declined one TORCH.
            if node.name in layer_kernels:
                ctx = RunCtx(precision=options.precision, backend=BackendKind.KERNEL,
                             operands=operands(node.name, [view],
                                               lambda: folded_operands(view, act_dtype)))
            else:
                backend = (BackendKind.TORCH if node.name in on_torch
                           else resolve_backend(node, graph, options))
                ctx = RunCtx(precision=options.precision, backend=backend,
                             cache=functools.partial(operands, node.name, [view]))
            env[node.name] = get_op(node.op).run(view, [value(i) for i in node.inputs], ctx)
        on = timer.tracing()
        for node in order:
            if node.name in skip or node.op == "InputLayer":
                continue
            if on:
                with timer.span("snn.layer", node=node.name, path=paths[node.name]):
                    run_entry(node)
            else:
                run_entry(node)
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
    forward.block_plan = {
        head: [n.name for n in members if n is not None]
        for head, (members, _spec, _a8w8) in blocks.items()
    }
    # The kernels' static plans: each chain's layer specs (in_q; the lists
    # the forward runs, so that a planted fault can edit one) and each
    # block's spec (ax1, ax2).
    forward.chain_specs = {head: c[4] for head, c in chains.items()}
    forward.block_specs = {head: spec for head, (_m, spec, _a8w8) in blocks.items()}
    forward.single_conv_plan = list(singles)
    forward.kernel_conv_plan = list(kernel_convs)
    forward.kernel_dense_plan = list(kernel_denses)
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
        if not timer.tracing():
            return self.forward(self.params, inputs)
        with timer.span("snn.step"):  # the forward's host time
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


@dataclasses.dataclass
class ShardedModel(CompiledModel):
    """A model sharded over a mesh (parallel/spmd.py): `params` and the
    forward's inputs and outputs are lists indexed like `mesh.coords`, None
    at the shards another process owns. Called with global inputs it splits
    them by the plan's input specs (batch over data, H over spatial,
    replicated over model) and returns the assembled global outputs on
    `device`, the mesh's first device; on a mesh that spans processes it
    returns this process's shards' outputs instead (`step`)."""

    mesh: object = None
    spmd_plan: object = None

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        outs = self.step(self.params, self.split_inputs(inputs))
        if all(self.mesh.is_local(c) for c in self.mesh.coords):
            return self.assemble(outs)
        return outs

    def step(self, params: List, shard_inputs: List) -> List:
        return self.forward(params, shard_inputs)

    def split_inputs(self, inputs: Dict[str, torch.Tensor]) -> List:
        """Each local shard's slice of the global inputs, on its device."""
        from shadernn_tpu_torch.parallel.mesh import shard_index

        out = []
        for coord in self.mesh.coords:
            if not self.mesh.is_local(coord):
                out.append(None)
                continue
            dev = self.mesh.device_at(coord)
            out.append({
                name: t[shard_index(self.spmd_plan.input_specs[name], self.mesh, coord,
                                    tuple(t.shape))].to(dev)
                for name, t in inputs.items()})
        return out

    def assemble(self, outs: List) -> dict:
        """The global outputs on `device` from every shard's outputs."""
        from shadernn_tpu_torch.parallel.mesh import P, owns_slice, shard_index

        coords = self.mesh.coords
        first = next(o for o in outs if o is not None)

        def whole(spec, parts):
            part = next(t for t in parts if t is not None)
            shape = list(part.shape)
            for dim, axis in enumerate(spec):
                if axis is not None:
                    shape[dim] *= self.mesh.shape[axis]
            g = torch.empty(shape, dtype=part.dtype, device=self.device)
            for coord, t in zip(coords, parts):
                if t is not None and owns_slice(spec, self.mesh, coord):
                    g[shard_index(spec, self.mesh, coord, shape)] = t.to(self.device)
            return g

        res = {name: whole(self.spmd_plan.output_specs[name],
                           [None if o is None else o[name] for o in outs])
               for name in self.graph.output_names}
        if "__dumps__" in first:
            sh = self.options.sharding
            res["__dumps__"] = {
                name: whole(P(sh.data_axis) if sh.data > 1 and
                            self.graph.nodes[name].out_spec.shape[0] % sh.data == 0 else P(),
                            [None if o is None else o["__dumps__"][name] for o in outs])
                for name in first["__dumps__"]}
        return res

    def load_params(self, params: Params) -> None:
        """Install global parameters (as weights.params_from_numpy gives
        them), cut onto the shards by the plan."""
        from shadernn_tpu_torch.weights import shard_params

        cur = extract_params(self.graph)
        if set(params) != set(cur) or any(
                set(params[n]) != set(d) or any(tuple(params[n][k].shape) != v.shape
                                                for k, v in d.items())
                for n, d in cur.items()):
            raise ValueError("params do not match the engine's nodes, names and shapes")
        self.params = shard_params({n: {k: v.cpu() for k, v in d.items()}
                                    for n, d in params.items()}, self.spmd_plan, self.mesh)


def compile_graph(graph: Graph, options: Optional[EngineOptions] = None,
                  mesh=None) -> CompiledModel:
    """Shape-infer, move params to the device and plan the forward. Under a
    `mesh` (parallel/mesh.py) the graph is sharded over it
    (parallel/sharding.py shard_compiled); the mesh's devices must be of
    the type `options.device` names."""
    options = options or EngineOptions()
    device = resolve_device(options)
    if any(n.out_spec is None for n in graph.nodes.values()):
        graph.infer_shapes(batch_size=options.batch_size)
    # Int8 activations: each quantized consumer takes its producer's
    # calibrated scale (a no-op unless calibrate_activations ran).
    propagate_input_scales(graph)
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"mesh on {mesh.device_type} devices, but EngineOptions.device "
                             f"is {options.device!r}")
        from shadernn_tpu_torch.parallel.sharding import shard_compiled

        return shard_compiled(graph, options, extract_params(graph), mesh)
    params = params_from_numpy(extract_params(graph), device)
    forward = build_forward(graph, options)
    input_specs = {n: graph.nodes[n].out_spec.shape for n in graph.input_names}
    return CompiledModel(graph, options, params, forward, input_specs, device)
