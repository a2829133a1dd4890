"""Graph -> ONNX exporter (wire-format writer, no `onnx` package;
counterpart of shadernn_tpu/tools/onnx_export.py, whose bytes it writes
byte for byte).

The reference converts *from* ONNX only (tools/convertTool); exporting back
out gives the TPU framework a loss-free interchange path and, more
importantly here, lets the test suite round-trip every zoo model through
the real ONNX bytes: build -> export_onnx -> convert_onnx -> compare
outputs. That exercises the importer (tools/convert.py:convert_onnx_graph)
against the full reference layer vocabulary instead of hand-rolled
fragments.

Layout conventions (inverse of the importer):
- activations NCHW, weights OIHW (Conv), (C, O/g, kh, kw) (ConvTranspose),
  depthwise (C*m, 1, kh, kw) with group=C.
- Gemm weights are CHW-major on flattened image features; our Flatten is
  HWC-major, so dense weight rows are permuted HWC->CHW on export (the
  importer permutes back).
- "same" padding is emitted as explicit `pads` digits [t, l, b, r].
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.ops.common import is_same_padding, padding_offsets
from shadernn_tpu_torch.ops.registry import canonical_op
from shadernn_tpu_torch.ops.shape_ops import Pad

# --- protobuf wire-format primitives ---------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & ((1 << 64) - 1))


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
          np.dtype(np.int32): 6, np.dtype(np.int8): 3}[arr.dtype]
    out = b""
    for d in arr.shape:
        out += _int_field(1, d)
    out += _int_field(2, dt)
    out += _len_field(8, name.encode())
    out += _len_field(9, arr.tobytes())
    return out


def attr_ints(name: str, vals: Sequence[int]) -> bytes:
    out = _len_field(1, name.encode())
    for v in vals:
        out += _int_field(8, int(v))
    return out + _int_field(20, 7)  # AttributeProto.Type INTS


def attr_int(name: str, v: int) -> bytes:
    return _len_field(1, name.encode()) + _int_field(3, int(v)) + _int_field(20, 2)


def attr_float(name: str, v: float) -> bytes:
    return _len_field(1, name.encode()) + _float_field(2, float(v)) + _int_field(20, 1)


def attr_str(name: str, s: str) -> bytes:
    return _len_field(1, name.encode()) + _len_field(4, s.encode()) + _int_field(20, 3)


def onnx_node(op: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(3, (name or outputs[0]).encode())
    out += _len_field(4, op.encode())
    for a in attrs:
        out += _len_field(5, a)
    return out


def value_info(name: str, shape: Sequence[Optional[int]]) -> bytes:
    dims = b""
    for d in shape:
        dim = _int_field(1, d) if d is not None else _len_field(2, b"d")
        dims += _len_field(1, dim)
    tensor_type = _int_field(1, 1) + _len_field(2, dims)  # elem_type f32
    type_proto = _len_field(1, tensor_type)
    return _len_field(1, name.encode()) + _len_field(2, type_proto)


def onnx_model(nodes: List[bytes], initializers: List[bytes],
               inputs: List[bytes], outputs: List[bytes],
               name: str = "model") -> bytes:
    graph = b""
    for n in nodes:
        graph += _len_field(1, n)
    graph += _len_field(2, name.encode())
    for t in initializers:
        graph += _len_field(5, t)
    for i in inputs:
        graph += _len_field(11, i)
    for o in outputs:
        graph += _len_field(12, o)
    return _int_field(1, 7) + _len_field(7, graph)


# --- graph walk -------------------------------------------------------------

_ACT_ONNX = {
    "relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh", "softmax": "Softmax",
}


class OnnxExportError(ValueError):
    pass


def export_onnx(graph: Graph, path: Optional[str] = None) -> bytes:
    """Serialize a Graph as ONNX ModelProto bytes (opset-11 CNN subset)."""
    if any(n.out_spec is None for n in graph.nodes.values()):
        graph.infer_shapes()
    nodes: List[bytes] = []
    inits: List[bytes] = []
    val: Dict[str, str] = {}  # graph node name -> ONNX value name
    emitted_acts: List[str] = []

    def emit_activation(base: str, act: str, alpha: float) -> str:
        """Split a fused activation attr into its own ONNX node."""
        if act in (None, "", "linear"):
            return base
        out = f"{base}__act"
        if act in _ACT_ONNX:
            nodes.append(onnx_node(_ACT_ONNX[act], [base], [out], out))
        elif act in ("leaky_relu", "leakyrelu", "leakyRelu"):
            nodes.append(onnx_node("LeakyRelu", [base], [out], out,
                                   [attr_float("alpha", alpha)]))
        elif act == "relu6":
            nodes.append(onnx_node("Clip", [base], [out], out,
                                   [attr_float("min", 0.0), attr_float("max", 6.0)]))
        elif act in ("silu", "swish"):
            sig = f"{base}__sig"
            nodes.append(onnx_node("Sigmoid", [base], [sig], sig))
            nodes.append(onnx_node("Mul", [base, sig], [out], out))
        else:
            raise OnnxExportError(f"activation {act!r} has no ONNX mapping")
        emitted_acts.append(out)
        return out

    for node in graph.toposort():
        op = canonical_op(node.op)
        name = node.name
        ins = [val[i] for i in node.inputs]
        act = str(node.attr("activation", "linear"))
        alpha = float(node.attr("leaky_alpha", 0.3))
        use_bn = bool(node.attr("use_batchnorm", False)) and "bn_gamma" in node.params

        if op == "InputLayer":
            val[name] = name
            continue

        if op in ("Conv2D", "SeparableConv2D"):
            k = int(node.attr("kernel_size"))
            st = int(node.attr("stride", 1))
            pt, pb, pl_, pr = padding_offsets(node.attr("padding", "same"), k)
            attrs = [attr_ints("kernel_shape", [k, k]),
                     attr_ints("strides", [st, st]),
                     attr_ints("pads", [pt, pl_, pb, pr])]
            w = np.asarray(node.params["weight"], np.float32)
            if op == "SeparableConv2D":
                c_in = w.shape[2] if w.shape[2] != 1 else graph.nodes[node.inputs[0]].out_spec.c
                # HW1O -> (C*m, 1, kh, kw), group = C
                w_onnx = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                attrs.append(attr_int("group", c_in))
            else:
                w_onnx = np.ascontiguousarray(w.transpose(3, 2, 0, 1))  # OIHW
            inits.append(tensor(f"{name}.w", w_onnx))
            conv_in = [ins[0], f"{name}.w"]
            if len(ins) > 1:  # multi-input conv: concat first
                cc = f"{name}__cat"
                nodes.append(onnx_node("Concat", ins, [cc], cc, [attr_int("axis", 1)]))
                conv_in[0] = cc
            if "bias" in node.params and node.attr("use_bias", True):
                inits.append(tensor(f"{name}.b", np.asarray(node.params["bias"], np.float32)))
                conv_in.append(f"{name}.b")
            out = name if not (use_bn or act != "linear") else f"{name}__conv"
            nodes.append(onnx_node("Conv", conv_in, [out], out, attrs))
            cur = out
            if use_bn:
                bn_out = f"{name}__bn"
                for suffix, pkey in (("g", "bn_gamma"), ("bt", "bn_beta"),
                                     ("m", "bn_mean"), ("v", "bn_variance")):
                    inits.append(tensor(f"{name}.{suffix}",
                                        np.asarray(node.params[pkey], np.float32)))
                nodes.append(onnx_node(
                    "BatchNormalization",
                    [cur, f"{name}.g", f"{name}.bt", f"{name}.m", f"{name}.v"],
                    [bn_out], bn_out,
                    [attr_float("epsilon", float(node.attr("bn_epsilon", 1e-3)))]))
                cur = bn_out
            val[name] = emit_activation(cur, act, alpha) if act != "linear" else cur
            if val[name] != name and act == "linear" and not use_bn:
                val[name] = cur
            continue

        if op == "Conv2DTranspose":
            k = int(node.attr("kernel_size"))
            st = int(node.attr("stride", 1))
            total = (k - st) if is_same_padding(node.attr("padding", "same")) else 0
            pt = total // 2
            attrs = [attr_ints("kernel_shape", [k, k]),
                     attr_ints("strides", [st, st]),
                     attr_ints("pads", [pt, pt, total - pt, total - pt])]
            w = np.asarray(node.params["weight"], np.float32)  # HWIO
            inits.append(tensor(f"{name}.w", np.ascontiguousarray(w.transpose(2, 3, 0, 1))))
            conv_in = [ins[0], f"{name}.w"]
            if "bias" in node.params and node.attr("use_bias", True):
                inits.append(tensor(f"{name}.b", np.asarray(node.params["bias"], np.float32)))
                conv_in.append(f"{name}.b")
            out = name if act == "linear" else f"{name}__conv"
            nodes.append(onnx_node("ConvTranspose", conv_in, [out], out, attrs))
            val[name] = emit_activation(out, act, alpha)
            continue

        if op == "Dense":
            w = np.asarray(node.params["weight"], np.float32)  # (in, units)
            in_spec = graph.nodes[node.inputs[0]].out_spec
            src_node = graph.nodes[node.inputs[0]]
            if canonical_op(src_node.op) == "Flatten":
                img = graph.nodes[src_node.inputs[0]].out_spec
                if img.is_image and w.shape[0] == img.h * img.w * img.c:
                    # HWC-major rows -> CHW-major (ONNX Gemm convention)
                    idx = (np.arange(img.h * img.w * img.c)
                           .reshape(img.h, img.w, img.c)
                           .transpose(2, 0, 1).reshape(-1))
                    w = np.ascontiguousarray(w[idx])
            inits.append(tensor(f"{name}.w", w))
            gemm_in = [ins[0], f"{name}.w"]
            if "bias" in node.params and node.attr("use_bias", True):
                inits.append(tensor(f"{name}.b", np.asarray(node.params["bias"], np.float32)))
                gemm_in.append(f"{name}.b")
            out = name if act == "linear" else f"{name}__gemm"
            nodes.append(onnx_node("Gemm", gemm_in, [out], out))
            val[name] = emit_activation(out, act, alpha)
            continue

        if op == "BatchNormalization":
            for suffix, pkey in (("g", "gamma"), ("bt", "beta"),
                                 ("m", "mean"), ("v", "variance")):
                inits.append(tensor(f"{name}.{suffix}",
                                    np.asarray(node.params[pkey], np.float32)))
            out = name if act == "linear" else f"{name}__bn"
            nodes.append(onnx_node(
                "BatchNormalization",
                [ins[0], f"{name}.g", f"{name}.bt", f"{name}.m", f"{name}.v"],
                [out], out, [attr_float("epsilon", float(node.attr("epsilon", 1e-3)))]))
            val[name] = emit_activation(out, act, alpha)
            continue

        if op == "InstanceNormalization":
            for suffix, pkey in (("g", "gamma"), ("bt", "beta")):
                arr = node.params.get(pkey)
                if arr is None:
                    arr = (np.ones if pkey == "gamma" else np.zeros)(
                        node.out_spec.c, np.float32)
                inits.append(tensor(f"{name}.{suffix}", np.asarray(arr, np.float32)))
            out = name if act == "linear" else f"{name}__in"
            nodes.append(onnx_node(
                "InstanceNormalization", [ins[0], f"{name}.g", f"{name}.bt"],
                [out], out, [attr_float("epsilon", float(node.attr("epsilon", 1e-5)))]))
            val[name] = emit_activation(out, act, alpha)
            continue

        if op == "Activation":
            a = str(node.attr("activation", "relu"))
            val[name] = emit_activation(ins[0], a, alpha)
            # rename to node name for output mapping
            continue

        if op in ("MaxPooling2D", "AveragePooling2D"):
            k = int(node.attr("kernel_size"))
            st = int(node.attr("stride", 1))
            pt, pb, pl_, pr = padding_offsets(node.attr("padding", "same"), k)
            nodes.append(onnx_node(
                "MaxPool" if op == "MaxPooling2D" else "AveragePool",
                [ins[0]], [name], name,
                [attr_ints("kernel_shape", [k, k]), attr_ints("strides", [st, st]),
                 attr_ints("pads", [pt, pl_, pb, pr])]))
            val[name] = name
            continue

        if op == "AdaptiveAvgPool2d":
            oh = int(node.attr("output_height", node.attr("output_size", 1)))
            ow = int(node.attr("output_width", node.attr("output_size", 1)))
            if (oh, ow) != (1, 1):
                raise OnnxExportError("only global adaptive pooling exports")
            nodes.append(onnx_node("GlobalAveragePool", [ins[0]], [name], name))
            val[name] = name
            continue

        if op == "Add":
            cur = ins[0]
            for i, nxt in enumerate(ins[1:]):
                out = name if i == len(ins) - 2 and act == "linear" else f"{name}__{i}"
                nodes.append(onnx_node("Add", [cur, nxt], [out], out))
                cur = out
            val[name] = emit_activation(cur, act, alpha)
            continue

        if op == "Concatenate":
            out = name if act == "linear" else f"{name}__cat"
            nodes.append(onnx_node("Concat", ins, [out], out, [attr_int("axis", 1)]))
            val[name] = emit_activation(out, act, alpha)
            continue

        if op == "UpSampling2D":
            f = float(node.attr("scale", 2))
            interp = str(node.attr("interpolation", "nearest")).lower()
            inits.append(tensor(f"{name}.scales",
                                np.asarray([1.0, 1.0, f, f], np.float32)))
            nodes.append(onnx_node(
                "Upsample", [ins[0], f"{name}.scales"], [name], name,
                [attr_str("mode", "linear" if "li" in interp else "nearest")]))
            val[name] = name
            continue

        if op == "ZeroPadding2D":
            t, b, l, r = Pad._pads(node)
            mode = {"constant": "constant", "zero": "constant",
                    "reflect": "reflect", "replicate": "edge",
                    "edge": "edge"}[str(node.attr("mode", "constant")).lower()]
            nodes.append(onnx_node(
                "Pad", [ins[0]], [name], name,
                [attr_ints("pads", [0, 0, t, l, 0, 0, b, r]),
                 attr_str("mode", mode)]))
            val[name] = name
            continue

        if op == "Flatten":
            nodes.append(onnx_node("Flatten", [ins[0]], [name], name))
            val[name] = name
            continue

        if op == "Subpixel":
            nodes.append(onnx_node(
                "DepthToSpace", [ins[0]], [name], name,
                [attr_int("blocksize", int(node.attr("scale", 2))),
                 attr_str("mode", "DCR")]))
            val[name] = name
            continue

        raise OnnxExportError(f"op {node.op!r} has no ONNX mapping")

    # Export inputs as NCHW value_infos; Activation nodes may have renamed
    # outputs — map graph outputs through `val`.
    in_infos = []
    for iname in graph.input_names:
        s = graph.nodes[iname].out_spec
        in_infos.append(value_info(iname, [None, s.c, s.h, s.w]))
    out_infos = [value_info(val[o], []) for o in graph.output_names]
    data = onnx_model(nodes, inits, in_infos, out_infos, name=graph.name)
    if path:
        with open(path, "wb") as f:
            f.write(data)
    return data
