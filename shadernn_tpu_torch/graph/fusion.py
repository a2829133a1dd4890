"""Graph-level optimizations: BatchNorm folding and constant-ish fusions.

The reference fuses Conv2D+BatchNorm+Activation into a single generated
shader at model-load time (docs/Operators.md:11, conv2dGL.cpp:666-747).
Here the same fusion is done once on the Graph:

- `fold_batchnorm`: folds a conv's attached BN statistics (or a standalone
  following BatchNormalization node) directly into the conv weights/bias,
  removing the runtime epilogue entirely. Works for Conv2D,
  SeparableConv2D and Conv2DTranspose (per-output-channel scaling).
- `fuse_activation_into_conv`: moves a following Activation node's
  nonlinearity into the conv's fused epilogue when the conv is its only
  consumer and has no activation of its own.

These are numpy rewrites of the Graph, copied from
shadernn_tpu/graph/fusion.py so that both packages optimize a graph into
the same nodes; tests/test_torch_graph.py holds them to that. Folding
leaves fewer ops to launch and lets conv chains form across Pad and
Activation nodes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph, Node

_CONV_OPS = ("Conv2D", "SeparableConv2D", "Conv2DTranspose")


def _fold_bn_into_weights(node: Node, gamma, beta, mean, var, eps: float) -> None:
    """w' = w * s_o, b' = (b - mean) * s_o + beta with s_o = gamma/sqrt(var+eps).

    Weight layouts put the output channel last (HWIO / HW1(C*m) / HWIO),
    so scaling the trailing axis is correct for all three conv flavors.
    For Conv2DTranspose HWIO has O in axis -1 as well.
    """
    s = gamma / np.sqrt(var + eps)
    if "weight_q" in node.params:
        # INT8 storage keeps int weights; fold into the per-channel scale.
        node.params["weight_scale"] = node.params["weight_scale"] * s.astype(np.float32)
    else:
        node.params["weight"] = (node.params["weight"] * s).astype(np.float32)
    bias = node.params.get("bias", np.zeros_like(mean))
    node.params["bias"] = ((bias - mean) * s + beta).astype(np.float32)
    node.attrs["use_bias"] = True
    node.attrs["use_batchnorm"] = False
    for k in ("bn_gamma", "bn_beta", "bn_mean", "bn_variance"):
        node.params.pop(k, None)


def fold_batchnorm(graph: Graph) -> int:
    """Fold BN into conv weights. Returns number of folds performed."""
    folds = 0
    # 1. BN attached to the conv itself (JSON useBatchNormalization=True).
    for n in graph.nodes.values():
        if n.op in _CONV_OPS and n.attr("use_batchnorm", False) and "bn_gamma" in n.params:
            _fold_bn_into_weights(
                n,
                n.params["bn_gamma"].astype(np.float64),
                n.params["bn_beta"].astype(np.float64),
                n.params["bn_mean"].astype(np.float64),
                n.params["bn_variance"].astype(np.float64),
                float(n.attr("bn_epsilon", 1e-3)),
            )
            folds += 1

    # 2. Standalone BatchNormalization immediately after a conv that is its
    #    only consumer and applies no activation before the BN.
    to_remove = []
    for n in list(graph.nodes.values()):
        if n.op != "BatchNormalization" or "gamma" not in n.params:
            continue
        if n.attr("activation", "linear") not in ("linear", "", None):
            act_moves = True  # BN's activation moves onto the conv
        else:
            act_moves = False
        (src_name,) = n.inputs
        src = graph.nodes[src_name]
        if src.op not in _CONV_OPS:
            continue
        if src.attr("activation", "linear") not in ("linear", "", None):
            continue  # conv already activates before BN; cannot fold past it
        if len(graph.consumers(src_name)) != 1:
            continue
        _fold_bn_into_weights(
            src,
            n.params["gamma"].astype(np.float64),
            n.params["beta"].astype(np.float64),
            n.params["mean"].astype(np.float64),
            n.params["variance"].astype(np.float64),
            float(n.attr("epsilon", 1e-3)),
        )
        if act_moves:
            src.attrs["activation"] = n.attr("activation")
            src.attrs["leaky_alpha"] = n.attr("leaky_alpha", 0.3)
        to_remove.append(n.name)
        folds += 1

    _remove_passthrough(graph, to_remove)
    return folds


def fuse_activation_into_conv(graph: Graph) -> int:
    """Merge a lone Activation node into its producing conv/add/dense."""
    fusable_producers = _CONV_OPS + ("Dense", "Add", "BatchNormalization")
    to_remove = []
    for n in list(graph.nodes.values()):
        if n.op != "Activation" or len(n.inputs) != 1:
            continue
        src = graph.nodes[n.inputs[0]]
        if src.op not in fusable_producers:
            continue
        if src.attr("activation", "linear") not in ("linear", "", None):
            continue
        if len(graph.consumers(src.name)) != 1:
            continue
        src.attrs["activation"] = n.attr("activation", n.attr("kind", "relu"))
        src.attrs["leaky_alpha"] = n.attr("leaky_alpha", 0.3)
        to_remove.append(n.name)
    _remove_passthrough(graph, to_remove)
    return len(to_remove)


def fold_pad_into_conv(graph: Graph) -> int:
    """Merge a zero-constant ZeroPadding2D into its sole consuming conv's
    explicit padding (the reference's converter emits Pad+Conv pairs; the
    conv shader handles the offsets itself, padlayer + conv2d
    getPaddingOffset). Keeps kernel conv chains unbroken."""
    from shadernn_tpu_torch.ops.common import padding_offsets
    from shadernn_tpu_torch.ops.shape_ops import Pad as PadOp

    removed = []
    for n in list(graph.nodes.values()):
        if n.op != "ZeroPadding2D":
            continue
        if str(n.attr("mode", "constant")).lower() not in ("constant", "zero"):
            continue
        if float(n.attr("value", 0.0)) != 0.0:
            continue
        consumers = graph.consumers(n.name)
        if len(consumers) != 1 or consumers[0].op != "Conv2D":
            continue
        if n.name in graph.output_names:
            continue
        conv = consumers[0]
        pt, pb, pl_, pr = PadOp._pads(n)
        k = int(conv.attr("kernel_size"))
        ct, cb, cl, cr = padding_offsets(conv.attr("padding", "same"), k)
        conv.attrs["padding"] = (pt + ct, pb + cb, pl_ + cl, pr + cr)
        removed.append(n.name)
    _remove_passthrough(graph, removed)
    return len(removed)


# Ops that permute/reshape elements without changing values: an elementwise
# activation commutes with them.
_PERMUTATION_OPS = ("Subpixel", "Flatten")


def fuse_activation_through_permutation(graph: Graph) -> int:
    """Move Activation(permute(conv(x))) -> permute(conv+act(x)): lets the
    activation ride the conv's fused epilogue (e.g. ESPCN's tanh after
    depth_to_space lands in the chain kernel's last layer)."""
    moved = []
    for n in list(graph.nodes.values()):
        if n.op != "Activation" or len(n.inputs) != 1:
            continue
        perm = graph.nodes[n.inputs[0]]
        if perm.op not in _PERMUTATION_OPS or len(graph.consumers(perm.name)) != 1:
            continue
        src = graph.nodes[perm.inputs[0]]
        if src.op not in _CONV_OPS + ("Dense",):
            continue
        if src.attr("activation", "linear") not in ("linear", "", None):
            continue
        if len(graph.consumers(src.name)) != 1:
            continue
        src.attrs["activation"] = n.attr("activation", "linear")
        src.attrs["leaky_alpha"] = n.attr("leaky_alpha", 0.3)
        moved.append(n.name)
    _remove_passthrough(graph, moved)
    return len(moved)


def fold_stride2_convs(graph: Graph) -> int:
    """Rewrite each stride-2 Conv2D as SpaceToDepth(2) + a stride-1 Conv2D
    with block-rearranged weights — exact arithmetic, just reindexed.

    Why: stride-2 convs are excluded from the stride-1 kernel conv chain.
    Derivation: with
    x2 = space_to_depth(x) (block-major), out[i,j] = sum_dy x[2i+dy-pt]...
    maps tap dy to (a_y, r_y) via u = dy-pt, a_y = floor(u/2)+ceil(pt/2),
    r_y = u mod 2, giving a k2 = floor((k-1-pt)/2)+ceil(pt/2)+1 kernel over
    4C channels with pads (ceil(pt/2), pb2, ceil(pl/2), pr2) chosen to
    reproduce the original output size.
    """
    from shadernn_tpu_torch.ops.common import padding_offsets

    if any(n.out_spec is None for n in graph.nodes.values()):
        graph.infer_shapes()
    count = 0
    for name in list(graph.nodes):
        node = graph.nodes[name]
        if (
            node.op != "Conv2D"
            or int(node.attr("stride", 1)) != 2
            or len(node.inputs) != 1
        ):
            continue
        k = int(node.attr("kernel_size"))
        pt, pb, pl, pr = padding_offsets(node.attr("padding", "same"), k)
        if pt != pl:  # keep the rewritten kernel square
            continue
        in_spec = graph.nodes[node.inputs[0]].out_spec
        if not in_spec.is_image:
            continue
        h, w, c = in_spec.h, in_spec.w, in_spec.c
        if h % 2 or w % 2:
            continue
        pt2 = -((-pt) // 2)  # ceil(pt/2)
        k2 = (k - 1 - pt) // 2 + pt2 + 1
        # Fold ONLY when the folded conv lands in the small-channel chain
        # window of the AUTO policy (engine/compile.py resolve_backend):
        # there the fold chains the layer into one fused kernel; elsewhere
        # the space-to-depth shuffle is pure overhead. The window is the
        # JAX package's, so that both packages plan the same graph.
        o = int(node.attr("out_channels"))
        if not (2 <= k2 <= 4 and max(4 * c, o) <= 16):
            continue
        h_out = (h + pt + pb - k) // 2 + 1
        w_out = (w + pl + pr - k) // 2 + 1
        pb2 = h_out - (h // 2 + pt2 - k2 + 1)
        pr2 = w_out - (w // 2 + pt2 - k2 + 1)
        if pb2 < 0 or pr2 < 0 or pb2 >= k2 or pr2 >= k2:
            continue
        # Rearrange every weight-shaped param the same way (float or int8).
        def rearrange(wt):
            w2 = np.zeros((k2, k2, 4 * c) + wt.shape[3:], dtype=wt.dtype)
            for dy in range(k):
                uy = dy - pt
                ay, ry = uy // 2 + pt2, uy % 2
                for dx in range(k):
                    ux = dx - pt
                    ax, rx = ux // 2 + pt2, ux % 2
                    blk = (ry * 2 + rx) * c
                    w2[ay, ax, blk : blk + c] = wt[dy, dx]
            return w2

        for key in ("weight", "weight_q"):
            if key in node.params:
                node.params[key] = rearrange(np.asarray(node.params[key]))
        s2d = Node(
            f"{name}_s2d", "SpaceToDepth", [node.inputs[0]], {"scale": 2}
        )
        graph.add(s2d)
        node.inputs = [s2d.name]
        node.attrs["kernel_size"] = k2
        node.attrs["stride"] = 1
        node.attrs["padding"] = (pt2, pb2, pt2, pr2)
        node.out_spec = None  # re-infer below
        count += 1
    if count:
        graph.nodes = {n.name: n for n in graph.toposort()}
        graph.infer_shapes()
    return count


def fold_deconv2_convs(graph: Graph) -> int:
    """Rewrite each stride-2 SAME Conv2DTranspose as a stride-1 Conv2D
    (out_channels x4, parity-rearranged weights) + Subpixel — exact.

    Why: a stride-2 transposed conv computed as an input-dilated conv
    wastes 75% of the MACs on inserted zeros; the dense form also joins
    the kernel conv chain. Derivation (Keras scatter semantics
    y[i] = sum_m x[m]·w[i-2m+pb], pb=(k-2)//2): output parity p selects
    taps t = 2u+p+pb, giving per-parity correlations that combine into one
    conv with kernel K[a] = w[2(pt2-a)+p+pb] (zero outside [0,k)), pads
    (pt2, k2-1-pt2) with pt2 = max_p (k-1-p-pb)//2 and
    k2 = pt2 + max_p (p+pb)//2 + 1; depth_to_space restores the geometry.
    Per-output-channel epilogues (bias/BN/act/int8 scale) tile x4 since
    they commute with depth_to_space.
    """
    from shadernn_tpu_torch.ops.common import is_same_padding

    count = 0
    for name in list(graph.nodes):
        node = graph.nodes[name]
        if (
            node.op != "Conv2DTranspose"
            or int(node.attr("stride", 1)) != 2
            or len(node.inputs) != 1
            or not is_same_padding(node.attr("padding", "same"))
        ):
            continue
        k = int(node.attr("kernel_size"))
        if k < 2:
            continue
        pb = (k - 2) // 2
        u_hi = [(k - 1 - p - pb) // 2 for p in (0, 1)]
        u_lo = [-((p + pb) // 2) for p in (0, 1)]
        pt2 = max(u_hi)
        k2 = pt2 - min(u_lo) + 1
        # Same small-channel chain window as fold_stride2_convs (the JAX
        # package's, so that both packages plan the same graph).
        in_c = int(np.asarray(
            node.params.get("weight", node.params.get("weight_q"))
        ).shape[2])
        o_gate = int(node.attr("out_channels"))
        if not (2 <= k2 <= 4 and max(in_c, 4 * o_gate) <= 16):
            continue

        def rearrange(wt):
            c, o = wt.shape[2], wt.shape[3]
            w2 = np.zeros((k2, k2, c, 4 * o), dtype=wt.dtype)
            for py in (0, 1):
                for px in (0, 1):
                    blk = (py * 2 + px) * o
                    for ay in range(k2):
                        ty = 2 * (pt2 - ay) + py + pb
                        if not 0 <= ty < k:
                            continue
                        for ax in range(k2):
                            tx = 2 * (pt2 - ax) + px + pb
                            if 0 <= tx < k:
                                w2[ay, ax, :, blk : blk + o] = wt[ty, tx]
            return w2

        o = int(node.attr("out_channels"))
        conv = Node(
            f"{name}_s1",
            "Conv2D",
            list(node.inputs),
            {
                "kernel_size": k2,
                "stride": 1,
                "padding": (pt2, k2 - 1 - pt2, pt2, k2 - 1 - pt2),
                "out_channels": 4 * o,
                "activation": node.attr("activation", "linear"),
                "leaky_alpha": node.attr("leaky_alpha", 0.3),
                "use_bias": node.attr("use_bias", True),
                "use_batchnorm": node.attr("use_batchnorm", False),
            },
        )
        for key in ("weight", "weight_q"):
            if key in node.params:
                conv.params[key] = rearrange(np.asarray(node.params[key]))
        for key in ("bias", "weight_scale", "bn_gamma", "bn_beta",
                    "bn_mean", "bn_variance"):
            if key in node.params:
                conv.params[key] = np.tile(np.asarray(node.params[key]), 4)
        if "bn_epsilon" in node.attrs:
            conv.attrs["bn_epsilon"] = node.attrs["bn_epsilon"]
        graph.add(conv)
        # the original node becomes the depth_to_space, keeping its name so
        # consumers and output_names stay valid
        node.op = "Subpixel"
        node.inputs = [conv.name]
        node.attrs = {"scale": 2}
        node.params = {}
        node.out_spec = None
        count += 1
    if count:
        graph.nodes = {n.name: n for n in graph.toposort()}
        graph.infer_shapes()
    return count


def _remove_passthrough(graph: Graph, names) -> None:
    """Remove single-input nodes, rewiring consumers to their producer."""
    for name in names:
        node = graph.nodes[name]
        (src,) = node.inputs
        for consumer in graph.consumers(name):
            consumer.inputs = [src if i == name else i for i in consumer.inputs]
        graph.output_names = [src if o == name else o for o in graph.output_names]
        del graph.nodes[name]


def optimize(
    graph: Graph, fold_bn: bool = True, fold_stride2: bool = True
) -> Dict[str, int]:
    """Run the standard pipeline; returns fusion counts for logging."""
    stats = {}
    if fold_bn:
        stats["batchnorm_folds"] = fold_batchnorm(graph)
    stats["activation_fusions"] = fuse_activation_into_conv(graph)
    stats["pad_folds"] = fold_pad_into_conv(graph)
    stats["permuted_activation_fusions"] = fuse_activation_through_permutation(graph)
    if fold_stride2:
        stats["stride2_folds"] = fold_stride2_convs(graph)
        stats["deconv2_folds"] = fold_deconv2_convs(graph)
    return stats
