"""Explicit SPMD executor: DP + TP + SP that keep the kernels (counterpart
of shadernn_tpu/parallel/spmd.py).

The plan is the JAX package's, node for node (`plan_spmd`):

- **DP**: input frames split on batch (`data` axis); every op is
  batch-local.
- **TP**: conv/dense weights split on the output-channel axis (`model`):
  each shard computes its O-slice with the folded epilogue, and a gather
  over the model axis puts the channels back together. Depthwise convs
  take the input-channel slice that matches their weight slice.
- **SP**: activations split on H (`spatial` axis). Convs exchange their
  receptive-field halo rows with their neighbours (parallel/halo.py):
  stride-1 convs off the kernel use the interior/border split, the others
  exchange, then convolve. Ops with no spatial mixing run shard-local;
  ops that need the whole frame gather H and split it again afterwards
  where it divides.

The JAX package runs the plan as one `shard_map` program. Here one process
walks the sorted graph node by node over every shard it owns ("a plain
env walk", as there): each shard's body is an ordinary single-device
program on the shard's device, so a Conv2D that the per-shard backend
gives to KERNEL runs the implicit-GEMM CUDA kernel (kernels/conv_igemm.py)
on that shard. The collectives are mesh operations over a group of shards:
`gather_h`/`gather_c` concatenate along H or C, moving each part to the
receiving shard's device; `psum` sums the group's partials; a shard's
`axis_index` is its grid coordinate.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shadernn_tpu_torch.config import BackendKind, EngineOptions, ShardingOptions
from shadernn_tpu_torch.engine.compile import NodeView, OperandStore
from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.ops.common import apply_activation, padding_offsets
from shadernn_tpu_torch.ops.registry import RunCtx, canonical_op, get_op
from shadernn_tpu_torch.parallel.halo import halo_conv2d_shard, halo_exchange
from shadernn_tpu_torch.parallel.mesh import Mesh, P
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.spmd")

# Param leaves with a trailing output-channel dim (same vocabulary as the
# conv epilogue: weight, int8 scales, bias, folded/unfolded BN vectors).
_O_PARAMS = ("weight", "weight_q", "weight_scale", "bias",
             "bn_gamma", "bn_beta", "bn_mean", "bn_variance")


@dataclasses.dataclass
class NodePlan:
    """Static per-node execution decision."""

    mode: str  # input | local | halo_conv | dw_conv | pool_halo | gather | instnorm | gap | dense
    tp: bool = False  # params sharded on the model axis
    halo_up: int = 0
    halo_dn: int = 0
    # Re-split H over `spatial` after a gather-mode op (output H divides).
    resplit: bool = False
    # Inputs that must be gathered first because their states disagree.
    gather_inputs: bool = False


@dataclasses.dataclass
class SpmdPlan:
    """Whole-graph plan: node decisions + partition specs."""

    nodes: Dict[str, NodePlan]
    out_state: Dict[str, bool]  # node name -> H-sharded?
    param_specs: Dict[str, Dict[str, P]]
    input_specs: Dict[str, P]
    output_specs: Dict[str, P]

    def summary(self) -> Dict[str, int]:
        modes: Dict[str, int] = {}
        for p in self.nodes.values():
            modes[p.mode] = modes.get(p.mode, 0) + 1
        modes["tp_sharded"] = sum(1 for p in self.nodes.values() if p.tp)
        return modes


def _divides(dim: int, ways: int) -> bool:
    return ways > 1 and dim % ways == 0


def _conv_geometry(node: Node, h_in: int, h_out: int, sp: int):
    """Halo geometry (rows from the upper and the lower neighbour) of an
    H-sharded conv, depthwise conv or pool, or None where the shard
    decomposition does not line up (then the planner gathers). Output row j
    of the global op reads input rows [j*s - pt, j*s - pt + k)."""
    k = int(node.attr("kernel_size"))
    st = int(node.attr("stride", 1))
    pt, pb, _, _ = padding_offsets(node.attr("padding", "same"), k)
    if not (_divides(h_in, sp) and _divides(h_out, sp)):
        return None
    h_l, ho_l = h_in // sp, h_out // sp
    if h_l % st != 0 or ho_l * st != h_l:
        return None  # shard boundaries don't align with the stride grid
    up, dn = pt, max(0, k - st - pt)
    if up > h_l or dn > h_l:
        return None  # halos come from immediate neighbours only
    # The local VALID op on (up + h_l + dn) rows must yield exactly ho_l.
    if (up + h_l + dn - k) // st + 1 != ho_l:
        return None
    return up, dn


def plan_spmd(graph: Graph, options: EngineOptions) -> SpmdPlan:
    """Static planning pass: walk the sorted graph propagating the
    "is H sharded over `spatial`?" state and pick each node's mode."""
    from shadernn_tpu_torch.ops.shape_ops import Pad

    sh = options.sharding
    sp, tp, dp = sh.spatial, sh.model, sh.data
    order = graph.toposort()

    nodes: Dict[str, NodePlan] = {}
    state: Dict[str, bool] = {}
    param_specs: Dict[str, Dict[str, P]] = {}
    input_specs: Dict[str, P] = {}

    def tp_spec(node: Node) -> Dict[str, P]:
        o = node.out_spec.c if node.out_spec.rank == 4 else node.out_spec.shape[-1]
        specs = {}
        for k, v in node.params.items():
            v = np.asarray(v)
            if k in _O_PARAMS and v.shape[-1] == o:
                specs[k] = P(*([None] * (v.ndim - 1) + [sh.model_axis]))
            else:
                specs[k] = P()
        return specs

    for node in order:
        if node.op == "InputLayer":
            shape = node.out_spec.shape
            parts: List[Optional[str]] = [None] * len(shape)
            if _divides(shape[0], dp):
                parts[0] = sh.data_axis
            h_sh = len(shape) == 4 and _divides(shape[1], sp)
            if h_sh:
                parts[1] = sh.spatial_axis
            input_specs[node.name] = P(*parts)
            state[node.name] = h_sh
            nodes[node.name] = NodePlan(mode="input")
            continue

        in_states = [state[i] for i in node.inputs]
        h_sh = any(in_states)
        mismatch = h_sh and not all(in_states)
        plan = NodePlan(mode="local", gather_inputs=mismatch)
        if mismatch:
            h_sh = False  # reconcile by gathering all inputs

        op = canonical_op(node.op)
        out = node.out_spec
        if op == "Conv2D" and out.rank == 4:
            plan.tp = _divides(out.c, tp) and all(
                np.asarray(v).shape[-1] == out.c
                for k, v in node.params.items() if k in _O_PARAMS
            )
            if h_sh:
                in_spec = graph.nodes[node.inputs[0]].out_spec
                geo = _conv_geometry(node, in_spec.h, out.h, sp)
                if geo is not None:
                    plan.mode, (plan.halo_up, plan.halo_dn) = "halo_conv", geo
                else:
                    plan.mode, h_sh = "gather", False
        elif op == "SeparableConv2D":
            in_spec = graph.nodes[node.inputs[0]].out_spec
            plan.tp = _divides(in_spec.c, tp) and _divides(out.c, tp)
            if h_sh:
                geo = _conv_geometry(node, in_spec.h, out.h, sp)
                if geo is not None:
                    plan.mode, (plan.halo_up, plan.halo_dn) = "dw_conv", geo
                else:
                    # The gather branch runs the op on the full-channel
                    # input, which O-sliced depthwise weights cannot take.
                    plan.mode, h_sh, plan.tp = "gather", False, False
            else:
                plan.mode = "dw_conv"
        elif op == "Conv2DTranspose":
            plan.tp = _divides(out.c, tp)
            if h_sh:
                plan.mode, h_sh = "gather", False  # strided upsample mixes rows
        elif op == "Dense":
            plan.mode = "dense"
            plan.tp = _divides(int(node.attr("units")), tp)
            if h_sh:  # image input straight into Dense: need full H locally
                plan.gather_inputs = True
            h_sh = False
        elif op in ("MaxPooling2D", "AveragePooling2D"):
            if h_sh:
                in_spec = graph.nodes[node.inputs[0]].out_spec
                geo = _conv_geometry(node, in_spec.h, out.h, sp)
                if geo is not None:
                    # Fill-value halos keep pools shard-local: -inf at the
                    # frame edge for max, a validity mask for average.
                    plan.mode, (plan.halo_up, plan.halo_dn) = "pool_halo", geo
                else:
                    plan.mode, h_sh = "gather", False
        elif op == "AdaptiveAvgPool2d":
            oh = int(node.attr("output_height", node.attr("output_size", 1)))
            ow = int(node.attr("output_width", node.attr("output_size", 1)))
            if h_sh:
                if oh == 1 and ow == 1:
                    plan.mode, h_sh = "gap", False  # psum'd: replicated out
                else:
                    plan.mode, h_sh = "gather", False
        elif op == "InstanceNormalization":
            if h_sh:
                plan.mode = "instnorm"
        elif op == "UpSampling2D":
            # Nearest upsampling expands rows one by one; bilinear mixes rows
            # across shard seams.
            interp = str(node.attr("interpolation", "nearest")).lower()
            if h_sh and interp not in ("nearest", "nearest_neighbor"):
                plan.mode, h_sh = "gather", False
        elif op == "Subpixel":
            pass  # per-row expansion: shard-local under SP
        elif op == "SpaceToDepth":
            if h_sh:
                in_spec = graph.nodes[node.inputs[0]].out_spec
                r = int(node.attr("scale", 2))
                if (in_spec.h // sp) % r != 0:
                    plan.mode, h_sh = "gather", False
        elif op == "ZeroPadding2D":
            t, b, _, _ = Pad._pads(node)
            if h_sh and (t or b):
                plan.mode, h_sh = "gather", False
        elif op in ("Flatten", "YOLO"):
            if h_sh:
                plan.mode, h_sh = "gather", False
        elif op in ("Add", "Concatenate", "Activation", "Unary", "Calculate",
                    "BatchNormalization"):
            pass  # elementwise / per-channel: shard-local
        else:
            if h_sh:  # unknown op: be conservative
                plan.mode, h_sh = "gather", False

        # After a gather, re-split H if the output is an image that divides.
        if plan.mode == "gather" and out.rank == 4 and _divides(out.h, sp):
            plan.resplit = True
            h_sh = True

        if plan.tp and node.params:
            param_specs[node.name] = tp_spec(node)
        elif node.params:
            param_specs[node.name] = {k: P() for k in node.params}
        nodes[node.name] = plan
        state[node.name] = h_sh

    output_specs: Dict[str, P] = {}
    for name in graph.output_names:
        spec = graph.nodes[name].out_spec
        parts = [None] * spec.rank
        if _divides(spec.shape[0], dp):
            parts[0] = sh.data_axis
        if state[name]:
            parts[1] = sh.spatial_axis
        output_specs[name] = P(*parts)
    return SpmdPlan(nodes, state, param_specs, input_specs, output_specs)


# ---------------------------------------------------------------------------
# Execution


def _local_backend(node: Node, graph: Graph, options: EngineOptions) -> BackendKind:
    """Backend of the per-shard program: each shard is an ordinary
    single-device program, so the kernels are usable: resolved with the
    sharding stripped."""
    from shadernn_tpu_torch.engine.compile import resolve_backend

    local = dataclasses.replace(options, sharding=ShardingOptions())
    return resolve_backend(node, graph, local)


def _kernel_admits(node, x: torch.Tensor, use_kernel: bool) -> bool:
    """Does this conv run on the implicit-GEMM kernel on this shard? Its
    backend is KERNEL and the kernel's gate (the JAX package's
    `pallas_conv_supported` limits, an epilogue activation) admits it."""
    from shadernn_tpu_torch.kernels.conv_igemm import igemm_conv_supported

    return use_kernel and igemm_conv_supported(node, x.shape[-1])


def _conv_local(node, x: torch.Tensor, stride: int, pads, operands) -> torch.Tensor:
    """One conv on local (already halo-extended) rows with explicit pads,
    the epilogue in the folded per-channel (scale, offset) form. The
    implicit-GEMM kernel where `operands` are its own (kernels/conv_igemm.py
    `prepare`, where `_kernel_admits`); else, on ops/conv.py
    folded_operands, float32 sums on the compute-dtype values (int8 weights
    are exact there, their scale is in the epilogue)."""
    from shadernn_tpu_torch.kernels import conv_igemm
    from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32

    act = node.attr("activation", "linear")
    alpha = float(node.attr("leaky_alpha", 0.3))
    if isinstance(operands, conv_igemm.IgemmOperands):
        return conv_igemm.run(x.contiguous(), operands, stride=stride, pads=tuple(pads),
                              activation=act, alpha=alpha)
    w, scale, offset = operands
    y = conv2d_nhwc_f32(x, w.to(x.dtype), tuple(pads), stride)
    return apply_activation(y * scale + offset, act, alpha).to(x.dtype)


def _epilogue_f32(node, y: torch.Tensor, scale, offset, dtype) -> torch.Tensor:
    y = y * scale + offset
    return apply_activation(y, node.attr("activation", "linear"),
                            float(node.attr("leaky_alpha", 0.3))).to(dtype)


class Collectives:
    """The executor's collectives over a mesh. Values are lists indexed like
    `mesh.coords`, None at the shards this process does not own; each
    operation works group by group along one axis and gives every member
    its result on its own device (computed once per device of a group)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.index = {c: i for i, c in enumerate(mesh.coords)}
        self.local = [i for i, c in enumerate(mesh.coords) if mesh.is_local(c)]
        self.devices = [mesh.device_at(c) for c in mesh.coords]

    def groups(self, axis: str) -> List[List[int]]:
        seen, out = set(), []
        for i in self.local:
            g = [self.index[c] for c in self.mesh.group(self.mesh.coords[i], axis)]
            if g[0] not in seen:
                seen.add(g[0])
                out.append(g)
        return out

    def axis_index(self, i: int, axis: str) -> int:
        return self.mesh.axis_index(self.mesh.coords[i], axis)

    def _reduce(self, vals: List, axis: str, combine: Callable) -> List:
        out = list(vals)
        for g in self.groups(axis):
            done: Dict[torch.device, torch.Tensor] = {}
            for i in g:
                dev = self.devices[i]
                if dev not in done:
                    done[dev] = combine([vals[j].to(dev) for j in g])
                out[i] = done[dev]
        return out

    def gather(self, vals: List, axis: str, dim: int) -> List:
        """all_gather (tiled) along `dim` over `axis`."""
        return self._reduce(vals, axis, lambda parts: torch.cat(parts, dim=dim))

    def psum(self, vals: List, axis: str) -> List:
        return self._reduce(vals, axis, lambda parts: functools.reduce(torch.add, parts))

    def halo(self, vals: List, axis: str, up: int, dn: int, fill: float = 0.0) -> List:
        out = list(vals)
        for g in self.groups(axis):
            for i, y in zip(g, halo_exchange([vals[j] for j in g], up, dn, fill)):
                out[i] = y
        return out


def build_spmd_forward(graph: Graph, options: EngineOptions, mesh: Mesh,
                       plan: Optional[SpmdPlan] = None, use_kernels: bool = True):
    """(forward, plan): `forward(shard_params, shard_inputs)` takes and
    returns lists indexed like `mesh.coords` (None at the shards another
    process owns): each shard's params (weights.shard_params) and input
    tensors, and each shard's outputs as `plan.output_specs` lay them out.
    `use_kernels=False` runs TORCH on every shard."""
    plan = plan or plan_spmd(graph, options)
    sh = options.sharding
    sp_ax, tp_ax = sh.spatial_axis, sh.model_axis
    order = graph.toposort()
    act_dtype = options.precision.activation_dtype
    coll = Collectives(mesh)
    local = coll.local
    nshards = len(mesh.coords)
    backends = {
        n.name: (_local_backend(n, graph, options) if use_kernels else BackendKind.TORCH)
        for n in order if n.op != "InputLayer"
    }
    # What each shard derives from its params (kernel and folded operands,
    # the TORCH layer weight), under (shard, node, what, dtype).
    store = OperandStore()

    from shadernn_tpu_torch.kernels.conv_igemm import prepare
    from shadernn_tpu_torch.ops.conv import folded_operands

    def each(fn) -> List:
        out = [None] * nshards
        for i in local:
            out[i] = fn(i)
        return out

    def forward(shard_params: List, shard_inputs: List) -> List:
        store.sync(shard_params)
        env: Dict[str, List] = {}
        dumps: Dict[str, List] = {}
        for node in order:
            np_ = plan.nodes[node.name]
            if node.op == "InputLayer":
                env[node.name] = each(lambda i: shard_inputs[i][node.name].to(act_dtype))
                continue
            views = each(lambda i: NodeView(node, shard_params[i].get(node.name, {})))
            xs = [env[i] for i in node.inputs]
            if np_.gather_inputs or np_.mode == "gather":
                xs = [coll.gather(x, sp_ax, 1) if plan.out_state[i] else x
                      for x, i in zip(xs, node.inputs)]
            backend = backends[node.name]
            use_kernel = backend == BackendKind.KERNEL
            mode = np_.mode

            def operands(i, x, kernel=False):
                """The implicit-GEMM kernel's operands, else the folded ones."""
                def make():
                    folded = folded_operands(views[i], x.dtype)
                    return prepare(*folded, x.dtype) if kernel else folded
                return store.get((i, node.name, "igemm" if kernel else "folded", x.dtype), make)

            if mode in ("local", "gather"):
                op = get_op(node.op)

                def run(i):
                    ins = [x[i] for x in xs]
                    ctx = RunCtx(precision=options.precision, backend=backend,
                                 cache=functools.partial(store.get, (i, node.name, "w")))
                    if use_kernel and node.op == "Conv2D":
                        xin = ins[0] if len(ins) == 1 else torch.cat(ins, dim=-1)
                        if _kernel_admits(node, xin, True):
                            ctx.operands = operands(i, xin, True)
                        else:
                            ctx.backend = BackendKind.TORCH
                    return op.run(views[i], ins, ctx)

                y = each(run)
                if np_.tp:
                    y = coll.gather(y, tp_ax, -1)
                if mode == "gather" and np_.resplit:
                    def split(i):
                        h_l = y[i].shape[1] // sh.spatial
                        s = coll.axis_index(i, sp_ax)
                        return y[i][:, s * h_l:(s + 1) * h_l]
                    y = each(split)
            elif mode == "halo_conv":
                x = xs[0] if len(xs) == 1 else each(lambda i: torch.cat([v[i] for v in xs], -1))
                k = int(node.attr("kernel_size"))
                st = int(node.attr("stride", 1))
                _, _, pl_, pr = padding_offsets(node.attr("padding", "same"), k)
                up, dn = np_.halo_up, np_.halo_dn
                probe = x[local[0]]
                if (up or dn) and st == 1 and not _kernel_admits(node, probe, use_kernel):
                    # The overlapped interior/border split (parallel/halo.py).
                    pads = (up, k - 1 - up, pl_, pr)
                    y = list(x)
                    for g in coll.groups(sp_ax):
                        ops = [operands(i, x[i]) for i in g]
                        accs = halo_conv2d_shard([x[i] for i in g],
                                                 [o[0].to(x[i].dtype) for i, o in zip(g, ops)],
                                                 pads=pads, overlap=True)
                        for i, acc, (_, scale, offset) in zip(g, accs, ops):
                            y[i] = _epilogue_f32(node, acc, scale, offset, x[i].dtype)
                else:
                    xh = coll.halo(x, sp_ax, up, dn) if (up or dn) else x
                    y = each(lambda i: _conv_local(views[i], xh[i], st, (0, 0, pl_, pr), operands(
                        i, xh[i], _kernel_admits(node, xh[i], use_kernel))))
                if np_.tp:
                    y = coll.gather(y, tp_ax, -1)
            elif mode == "dw_conv":
                k = int(node.attr("kernel_size"))
                st = int(node.attr("stride", 1))
                pt, pb, pl_, pr = padding_offsets(node.attr("padding", "same"), k)
                x = xs[0]
                if np_.tp:
                    # O-sliced weights = input-channel-sliced (feature groups
                    # follow input channels): take the matching channels.
                    def cslice(i):
                        c_l = x[i].shape[-1] // sh.model
                        m = coll.axis_index(i, tp_ax)
                        return x[i][..., m * c_l:(m + 1) * c_l]
                    x = each(cslice)
                hs = plan.out_state[node.name]
                if hs and (np_.halo_up or np_.halo_dn):
                    x = coll.halo(x, sp_ax, np_.halo_up, np_.halo_dn)
                pads_v = (0, 0) if hs else (pt, pb)

                def dw(i):
                    from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32

                    w, scale, offset = operands(i, x[i])
                    acc = conv2d_nhwc_f32(x[i], w, pads_v + (pl_, pr), st, groups=x[i].shape[-1])
                    return _epilogue_f32(node, acc, scale, offset, act_dtype)

                y = each(dw)
                if np_.tp:
                    y = coll.gather(y, tp_ax, -1)
            elif mode == "pool_halo":
                x = xs[0]
                k = int(node.attr("kernel_size"))
                st = int(node.attr("stride", 1))
                _, _, pl_, pr = padding_offsets(node.attr("padding", "same"), k)
                hu, hd = np_.halo_up, np_.halo_dn
                if node.op.startswith("Max"):
                    xh = coll.halo(x, sp_ax, hu, hd, fill=float("-inf"))
                    y = each(lambda i: F.max_pool2d(
                        F.pad(xh[i].permute(0, 3, 1, 2), (pl_, pr), value=float("-inf")), k, st)
                        .permute(0, 2, 3, 1).contiguous())
                else:  # count-correct average: exchange a validity mask
                    xh = coll.halo(x, sp_ax, hu, hd)
                    ones = coll.halo(each(lambda i: x[i].new_ones((1, x[i].shape[1],
                                                                   x[i].shape[2], 1))),
                                     sp_ax, hu, hd)

                    def window_sums(t):
                        return F.avg_pool2d(F.pad(t.permute(0, 3, 1, 2), (pl_, pr)), k, st,
                                            divisor_override=1)

                    y = each(lambda i: (window_sums(xh[i]) / window_sums(ones[i]))
                             .permute(0, 2, 3, 1).contiguous())
            elif mode == "dense":
                x = xs[0]

                def dense(i):
                    xi = x[i].reshape(x[i].shape[0], -1) if x[i].dim() > 2 else x[i]
                    w, scale, offset = operands(i, xi)
                    return (xi.float() @ w.float()) * scale + offset

                y = each(dense)
                if np_.tp:
                    # Gather BEFORE the activation: a softmax head normalizes
                    # over every unit.
                    y = coll.gather(y, tp_ax, -1)
                y = each(lambda i: apply_activation(
                    y[i], node.attr("activation", "linear"),
                    float(node.attr("leaky_alpha", 0.3))).to(act_dtype))
            elif mode == "instnorm":
                x = xs[0]
                eps = float(node.attr("epsilon", 1e-5))
                xf = each(lambda i: x[i].float())
                s1 = coll.psum(each(lambda i: xf[i].sum(dim=(1, 2), keepdim=True)), sp_ax)
                s2 = coll.psum(each(lambda i: (xf[i] * xf[i]).sum(dim=(1, 2), keepdim=True)),
                               sp_ax)

                def norm(i):
                    cnt = x[i].shape[1] * sh.spatial * x[i].shape[2]
                    mean = s1[i] / cnt
                    var = s2[i] / cnt - mean * mean
                    y = (xf[i] - mean) * torch.rsqrt(var + eps)
                    for key, fn in (("gamma", torch.mul), ("beta", torch.add)):
                        if key in views[i].params:
                            y = fn(y, torch.as_tensor(views[i].params[key]).to(y.device,
                                                                                torch.float32))
                    return apply_activation(y, node.attr("activation", "linear"),
                                            float(node.attr("leaky_alpha", 0.3))).to(act_dtype)

                y = each(norm)
            elif mode == "gap":
                x = xs[0]
                s = coll.psum(each(lambda i: x[i].float().sum(dim=(1, 2), keepdim=True)), sp_ax)
                y = each(lambda i: (s[i] / (x[i].shape[1] * sh.spatial * x[i].shape[2]))
                         .to(x[i].dtype))
            else:  # pragma: no cover - the planner emits only the modes above
                raise AssertionError(f"unknown mode {mode}")
            env[node.name] = y
            if options.dump_outputs:
                d = coll.gather(y, sp_ax, 1) if plan.out_state[node.name] else y
                dumps[node.name] = each(lambda i: d[i].float())

        def outs(i):
            o = {name: env[name][i].float() for name in graph.output_names}
            if options.dump_outputs:
                o["__dumps__"] = {name: d[i] for name, d in dumps.items()}
            return o

        return each(outs)

    # The convs each shard runs on the implicit-GEMM kernel (the sharded
    # counterpart of compile.py's kernel_conv_plan: one launch per shard).
    forward.kernel_conv_plan = [n for n, b in backends.items()
                                if b == BackendKind.KERNEL and graph.nodes[n].op == "Conv2D"]
    # The YOLO nodes: on CUDA devices one NMS launch each per shard.
    forward.nms_plan = [n.name for n in order if n.op == "YOLO"]
    # At bfloat16 the InstanceNormalization nodes a shard runs whole (not in
    # "instnorm" mode, whose statistics are psum'd): on CUDA devices one
    # launch of each instance-norm kernel each per shard.
    forward.instnorm_plan = [n.name for n in order if act_dtype == torch.bfloat16
                             and n.op == "InstanceNormalization"
                             and plan.nodes[n.name].mode != "instnorm"]
    forward.store = store
    return forward, plan


def shard_compiled_spmd(graph: Graph, options: EngineOptions, params, mesh: Mesh,
                        plan: Optional[SpmdPlan] = None, use_kernels: bool = True):
    """The explicit-SPMD program as a sharded CompiledModel: `params` (numpy,
    as extract_params gives them) cut by the plan onto each shard's device."""
    from shadernn_tpu_torch.engine.compile import ShardedModel
    from shadernn_tpu_torch.weights import params_from_numpy, shard_params

    fwd, plan = build_spmd_forward(graph, options, mesh, plan, use_kernels)
    logger.info("spmd plan: %s", plan.summary())
    glob = params_from_numpy(params, "cpu")
    input_specs = {n: graph.nodes[n].out_spec.shape for n in graph.input_names}
    return ShardedModel(graph, options, shard_params(glob, plan, mesh), fwd, input_specs,
                        mesh.first_device, mesh=mesh, spmd_plan=plan)
