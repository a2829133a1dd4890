"""Model conversion: Keras H5 / ONNX -> Graph + artifact (counterpart of
shadernn_tpu/tools/convert.py: the same graphs, attributes and parameters).

Counterpart of the reference's convertTool (tools/convertTool/convertTool.py,
ModelConversion.md:19-33: `convertTool.py -f model.h5 [-d]` -> model JSON,
optionally decoupled into _layers.json + _weights.bin). Keras conv kernels
are already HWIO, matching our weight layout; BatchNormalization following
a conv is attached to it exactly as the reference's converter folds it
(conv2d.py layerinfo['batchNormalization']).

ONNX goes through the built-in wire-format reader (tools/onnx_reader.py),
with no `onnx` package. Keras is imported only inside `convert_h5`: this
module imports no keras, h5py or tensorflow.

CLI:  python -m shadernn_tpu_torch.tools.convert -f model.h5 [-d] [-o out.json]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph, Node
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.convert")

_ACT_MAP = {
    "linear": "linear", "relu": "relu", "relu6": "relu6", "tanh": "tanh",
    "sigmoid": "sigmoid", "softmax": "softmax", "swish": "silu",
    "silu": "silu", "leaky_relu": "leaky_relu", "gelu": "gelu",
}


def _keras_inbound(layer_conf: dict) -> List[str]:
    """Extract inbound layer names from a Keras (2 or 3) config entry."""
    nodes = layer_conf.get("inbound_nodes", [])
    names: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            # Keras 3 symbolic tensor ref: {'class_name': '__keras_tensor__',
            # 'config': {'keras_history': [layer_name, node_idx, tensor_idx]}}
            hist = obj.get("config", {}).get("keras_history")
            if obj.get("class_name") == "__keras_tensor__" and hist:
                names.append(hist[0])
                return
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            # Keras 2 style: ['layer_name', node_idx, tensor_idx, {...}]
            if (
                len(obj) >= 3
                and isinstance(obj[0], str)
                and isinstance(obj[1], int)
                and isinstance(obj[2], int)
            ):
                names.append(obj[0])
                return
            for v in obj:
                walk(v)

    walk(nodes)
    # de-dup preserving order
    seen, out = set(), []
    for n in names:
        if n not in seen:
            seen.add(n)
            out.append(n)
    return out


def convert_keras(model, input_hw: Optional[tuple] = None) -> Graph:
    """Convert a loaded Keras model (functional or sequential) to a Graph.

    input_hw overrides dynamic (None) spatial dims — the reference's models
    are built with None H/W and a concrete size chosen at engine init
    (modelInference.cpp inputList)."""
    conf = model.get_config()
    layers_conf = conf["layers"]
    weights = {l.name: l.get_weights() for l in model.layers}
    types = {l.name: type(l).__name__ for l in model.layers}
    keras_layers = {l.name: l for l in model.layers}

    g = Graph(conf.get("name", "keras_model"))
    prev_name: Optional[str] = None  # sequential chaining fallback

    for lc in layers_conf:
        cls = lc["class_name"]
        c = lc.get("config", {})
        name = c.get("name", lc.get("name"))
        inbound = _keras_inbound(lc) or ([prev_name] if prev_name else [])
        inbound = [i for i in inbound if i in g.nodes]

        if cls == "InputLayer":
            shape = c.get("batch_shape", c.get("batch_input_shape"))
            h, w = shape[1], shape[2]
            ch = shape[3]
            if h is None or w is None:
                if not input_hw:
                    raise ValueError("model has dynamic H/W; pass input_hw")
                h, w = input_hw
            g.add(Node(name, "InputLayer", [],
                       {"height": int(h), "width": int(w), "channels": int(ch)}))
        elif cls == "Conv2D":
            wts = weights[name]
            attrs = {
                "kernel_size": int(c["kernel_size"][0]),
                "stride": int(c["strides"][0]),
                "padding": c["padding"],
                "out_channels": int(c["filters"]),
                "use_bias": bool(c.get("use_bias", True)),
                "activation": _ACT_MAP.get(c.get("activation", "linear"), "linear"),
            }
            params = {"weight": np.asarray(wts[0], np.float32)}
            if attrs["use_bias"] and len(wts) > 1:
                params["bias"] = np.asarray(wts[1], np.float32)
            g.add(Node(name, "Conv2D", inbound, attrs, params))
        elif cls == "Conv2DTranspose":
            wts = weights[name]
            # Keras deconv kernel is (kh, kw, out, in) -> our HWIO (in, out)
            kern = np.asarray(wts[0], np.float32).transpose(0, 1, 3, 2)
            attrs = {
                "kernel_size": int(c["kernel_size"][0]),
                "stride": int(c["strides"][0]),
                "padding": c["padding"],
                "out_channels": int(c["filters"]),
                "use_bias": bool(c.get("use_bias", True)),
                "activation": _ACT_MAP.get(c.get("activation", "linear"), "linear"),
            }
            params = {"weight": kern}
            if attrs["use_bias"] and len(wts) > 1:
                params["bias"] = np.asarray(wts[1], np.float32)
            g.add(Node(name, "Conv2DTranspose", inbound, attrs, params))
        elif cls == "DepthwiseConv2D":
            wts = weights[name]
            kern = np.asarray(wts[0], np.float32)  # (kh, kw, C, mult)
            kh, kw, cin, mult = kern.shape
            kern = kern.reshape(kh, kw, 1, cin * mult)
            attrs = {
                "kernel_size": int(c["kernel_size"][0]),
                "stride": int(c["strides"][0]),
                "padding": c["padding"],
                "multiplier": int(c.get("depth_multiplier", 1)),
                "use_bias": bool(c.get("use_bias", True)),
                "activation": _ACT_MAP.get(c.get("activation", "linear"), "linear"),
            }
            params = {"weight": kern}
            if attrs["use_bias"] and len(wts) > 1:
                params["bias"] = np.asarray(wts[1], np.float32)
            g.add(Node(name, "SeparableConv2D", inbound, attrs, params))
        elif cls == "Dense":
            wts = weights[name]
            attrs = {
                "units": int(c["units"]),
                "use_bias": bool(c.get("use_bias", True)),
                "activation": _ACT_MAP.get(c.get("activation", "linear"), "linear"),
            }
            params = {"weight": np.asarray(wts[0], np.float32)}
            if attrs["use_bias"] and len(wts) > 1:
                params["bias"] = np.asarray(wts[1], np.float32)
            g.add(Node(name, "Dense", inbound, attrs, params))
        elif cls == "BatchNormalization":
            kl = keras_layers[name]
            g.add(Node(name, "BatchNormalization", inbound,
                       {"epsilon": float(c.get("epsilon", 1e-3))},
                       {"gamma": np.asarray(kl.gamma) if kl.gamma is not None else None,
                        "beta": np.asarray(kl.beta) if kl.beta is not None else None,
                        "mean": np.asarray(kl.moving_mean),
                        "variance": np.asarray(kl.moving_variance)}))
            node = g.nodes[name]
            c_dim = node.params["mean"].shape[0]
            if node.params["gamma"] is None:
                node.params["gamma"] = np.ones(c_dim, np.float32)
            if node.params["beta"] is None:
                node.params["beta"] = np.zeros(c_dim, np.float32)
        elif cls == "Activation":
            g.add(Node(name, "Activation", inbound,
                       {"activation": _ACT_MAP.get(c.get("activation"), "relu")}))
        elif cls in ("ReLU",):
            attrs = {"activation": "relu"}
            mx = c.get("max_value")
            if mx is not None and float(mx) == 6.0:
                attrs["activation"] = "relu6"
            g.add(Node(name, "Activation", inbound, attrs))
        elif cls == "LeakyReLU":
            g.add(Node(name, "Activation", inbound,
                       {"activation": "leaky_relu",
                        "leaky_alpha": float(c.get("negative_slope",
                                                   c.get("alpha", 0.3)))}))
        elif cls == "Add":
            g.add(Node(name, "Add", inbound, {}))
        elif cls == "Concatenate":
            g.add(Node(name, "Concatenate", inbound, {}))
        elif cls == "MaxPooling2D":
            g.add(Node(name, "MaxPooling2D", inbound,
                       {"kernel_size": int(c["pool_size"][0]),
                        "stride": int(c["strides"][0]),
                        "padding": c["padding"]}))
        elif cls == "AveragePooling2D":
            g.add(Node(name, "AveragePooling2D", inbound,
                       {"kernel_size": int(c["pool_size"][0]),
                        "stride": int(c["strides"][0]),
                        "padding": c["padding"]}))
        elif cls in ("GlobalAveragePooling2D",):
            g.add(Node(name, "AdaptiveAvgPool2d", inbound,
                       {"output_height": 1, "output_width": 1}))
            if not c.get("keepdims", False):
                g.add(Node(name + "_flat", "Flatten", [name], {}))
                prev_name = name + "_flat"
                continue
        elif cls == "UpSampling2D":
            interp = c.get("interpolation", "nearest")
            g.add(Node(name, "UpSampling2D", inbound,
                       {"scale": int(c["size"][0]), "interpolation": interp}))
        elif cls == "ZeroPadding2D":
            pad = c["padding"]  # ((t,b),(l,r))
            g.add(Node(name, "ZeroPadding2D", inbound,
                       {"pad_top": pad[0][0], "pad_bottom": pad[0][1],
                        "pad_left": pad[1][0], "pad_right": pad[1][1]}))
        elif cls == "Flatten":
            g.add(Node(name, "Flatten", inbound, {}))
        elif cls == "Lambda":
            # The reference's converter handles Lambda depth_to_space
            # (ESPCN subpixel) via custom-layer hooks
            # (userCustomLayers.py, docs Custom-Layer.md); we pattern-match
            # the common subpixel case.
            scale = _lambda_subpixel_scale(c, model, name)
            g.add(Node(name, "Subpixel", inbound, {"scale": scale}))
        elif cls in ("Dropout", "SpatialDropout2D"):
            # inference no-op: alias inbound
            prev_name = inbound[0] if inbound else prev_name
            continue
        else:
            raise ValueError(f"unsupported Keras layer {cls!r} ({name})")
        prev_name = name

    g.finalize()
    return g


def _lambda_subpixel_scale(conf: dict, model, name: str) -> int:
    """Infer the depth_to_space factor from a Lambda's I/O shapes."""
    try:
        layer = model.get_layer(name)
        in_shape = layer.input.shape
        out_shape = layer.output.shape
        if in_shape[1] and out_shape[1]:
            return int(out_shape[1] // in_shape[1])
        if in_shape[-1] and out_shape[-1]:
            return int(round((in_shape[-1] / out_shape[-1]) ** 0.5))
    except Exception:
        pass
    return 2


def convert_h5(path: str, input_hw: Optional[tuple] = None) -> Graph:
    import keras

    model = keras.models.load_model(path, compile=False, safe_mode=False)
    return convert_keras(model, input_hw=input_hw)


def convert_onnx(path: str, input_hw: Optional[tuple] = None) -> Graph:
    """ONNX (opset ~9-13 CNN subset) -> Graph, via the built-in wire-format
    reader (tools/onnx_reader.py — no `onnx` package needed). ONNX is NCHW;
    weights are transposed to our HWIO/NHWC conventions, and Gemm weights
    following a Flatten are row-permuted from CHW-major to HWC-major."""
    from shadernn_tpu_torch.tools.onnx_reader import load_onnx

    og = load_onnx(path)
    return convert_onnx_graph(og, input_hw=input_hw)


def convert_onnx_graph(og, input_hw: Optional[tuple] = None) -> Graph:
    """An OnnxGraph (tools/onnx_reader.py) -> Graph, shape-inferred."""
    g = Graph(og.name)
    inits = dict(og.initializers)
    # value name -> producing node name in our graph
    src: Dict[str, str] = {}

    for name, shape in og.inputs:
        if name in inits:
            continue
        n, c, h, w = (list(shape) + [None] * 4)[:4]
        if h is None or w is None:
            if not input_hw:
                raise ValueError("dynamic ONNX input dims; pass input_hw")
            h, w = input_hw
        node_name = f"input_{name}" if name in (None, "") else name
        g.add(Node(node_name, "InputLayer", [],
                   {"height": int(h), "width": int(w), "channels": int(c or 1)}))
        src[name] = node_name

    def get_init(vname):
        return inits[vname].data if vname in inits else None

    def uniq(base):
        name = base or "node"
        k = 1
        while name in g.nodes:
            k += 1
            name = f"{base}_{k}"
        return name

    for nd in og.nodes:
        op = nd.op_type
        out = nd.outputs[0]
        dyn_inputs = [src[i] for i in nd.inputs if i in src]
        attrs: dict = {}
        params: dict = {}
        name = uniq(nd.name or out)

        if op == "Constant":
            val = nd.attr("value")
            if val is not None:
                inits[out] = val
            continue
        if op in ("Identity", "Dropout"):
            if nd.inputs[0] in inits:
                inits[out] = inits[nd.inputs[0]]
            else:
                src[out] = src[nd.inputs[0]]
            continue
        if op == "Conv":
            w = np.asarray(get_init(nd.inputs[1]), np.float32)  # (O, C/g, kh, kw)
            b = get_init(nd.inputs[2]) if len(nd.inputs) > 2 else None
            group = int(nd.attr("group", 1) or 1)
            kh = int(nd.attr("kernel_shape", [w.shape[2]])[0])
            stride = int((nd.attr("strides") or [1])[0])
            pads = nd.attr("pads") or [0, 0, 0, 0]
            pt, pl_, pb, pr = (list(pads) + [0] * 4)[:4]
            if group > 1 and w.shape[1] == 1:
                # depthwise: (C*m, 1, kh, kw) -> HW1O
                params["weight"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
                attrs = {"kernel_size": kh, "stride": stride,
                         "padding": (pt, pb, pl_, pr),
                         "multiplier": w.shape[0] // group,
                         "use_bias": b is not None}
                opname = "SeparableConv2D"
            else:
                if group != 1:
                    raise ValueError(f"grouped conv g={group} unsupported")
                params["weight"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
                attrs = {"kernel_size": kh, "stride": stride,
                         "padding": (pt, pb, pl_, pr),
                         "out_channels": w.shape[0],
                         "use_bias": b is not None}
                opname = "Conv2D"
            if b is not None:
                params["bias"] = np.asarray(b, np.float32)
            g.add(Node(name, opname, dyn_inputs, attrs, params))
        elif op == "ConvTranspose":
            w = np.asarray(get_init(nd.inputs[1]), np.float32)  # (C, O/g, kh, kw)
            b = get_init(nd.inputs[2]) if len(nd.inputs) > 2 else None
            kh = w.shape[2]
            stride = int((nd.attr("strides") or [1])[0])
            pads = nd.attr("pads") or [0, 0, 0, 0]
            total = pads[0] + pads[2]
            padding = "same" if total == kh - stride else "valid"
            params["weight"] = np.ascontiguousarray(w.transpose(2, 3, 0, 1))
            if b is not None:
                params["bias"] = np.asarray(b, np.float32)
            g.add(Node(name, "Conv2DTranspose", dyn_inputs,
                       {"kernel_size": kh, "stride": stride, "padding": padding,
                        "out_channels": w.shape[1], "use_bias": b is not None},
                       params))
        elif op in ("Relu", "Sigmoid", "Tanh", "Softmax"):
            g.add(Node(name, "Activation", dyn_inputs,
                       {"activation": op.lower().replace("relu", "relu")}))
        elif op == "LeakyRelu":
            g.add(Node(name, "Activation", dyn_inputs,
                       {"activation": "leaky_relu",
                        "leaky_alpha": float(nd.attr("alpha", 0.01) or 0.01)}))
        elif op == "Clip":
            lo = nd.attr("min", 0.0)
            hi = nd.attr("max", 6.0)
            if lo is None and len(nd.inputs) > 1:
                lo = float(get_init(nd.inputs[1]))
            if hi is None and len(nd.inputs) > 2:
                hi = float(get_init(nd.inputs[2]))
            if float(lo or 0) == 0.0 and float(hi or 6) == 6.0:
                g.add(Node(name, "Activation", dyn_inputs, {"activation": "relu6"}))
            else:
                g.add(Node(name, "Unary", dyn_inputs,
                           {"op_type": "clip", "clip_range": (float(lo), float(hi))}))
        elif op == "Add":
            g.add(Node(name, "Add", dyn_inputs, {}))
        elif op == "Concat":
            if int(nd.attr("axis", 1)) not in (1, -3):
                raise ValueError("channel concat only")
            g.add(Node(name, "Concatenate", dyn_inputs, {}))
        elif op in ("MaxPool", "AveragePool"):
            k = int(nd.attr("kernel_shape")[0])
            stride = int((nd.attr("strides") or [k])[0])
            pads = nd.attr("pads") or [0, 0, 0, 0]
            pt, pl_, pb, pr = (list(pads) + [0] * 4)[:4]
            g.add(Node(name,
                       "MaxPooling2D" if op == "MaxPool" else "AveragePooling2D",
                       dyn_inputs,
                       {"kernel_size": k, "stride": stride,
                        "padding": (pt, pb, pl_, pr)}))
        elif op == "GlobalAveragePool":
            g.add(Node(name, "AdaptiveAvgPool2d", dyn_inputs,
                       {"output_height": 1, "output_width": 1}))
        elif op == "BatchNormalization":
            eps = float(nd.attr("epsilon", 1e-5) or 1e-5)
            g.add(Node(name, "BatchNormalization", dyn_inputs, {"epsilon": eps},
                       {"gamma": np.asarray(get_init(nd.inputs[1]), np.float32),
                        "beta": np.asarray(get_init(nd.inputs[2]), np.float32),
                        "mean": np.asarray(get_init(nd.inputs[3]), np.float32),
                        "variance": np.asarray(get_init(nd.inputs[4]), np.float32)}))
        elif op == "InstanceNormalization":
            eps = float(nd.attr("epsilon", 1e-5) or 1e-5)
            g.add(Node(name, "InstanceNormalization", dyn_inputs,
                       {"epsilon": eps},
                       {"gamma": np.asarray(get_init(nd.inputs[1]), np.float32),
                        "beta": np.asarray(get_init(nd.inputs[2]), np.float32)}))
        elif op in ("Upsample", "Resize"):
            scales = None
            for vin in nd.inputs[1:]:
                arr = get_init(vin)
                if arr is not None and arr.size >= 4:
                    scales = arr
            if scales is None:
                scales = np.asarray(nd.attr("scales", [1, 1, 2, 2]))
            mode = (nd.attr("mode", b"nearest") or b"nearest")
            mode = mode.decode() if isinstance(mode, bytes) else mode
            g.add(Node(name, "UpSampling2D", dyn_inputs[:1],
                       {"scale": int(round(float(scales[2]))),
                        "interpolation": "bilinear" if "linear" in mode else "nearest"}))
        elif op == "Pad":
            pads = nd.attr("pads")
            if pads is None and len(nd.inputs) > 1:
                pads = list(get_init(nd.inputs[1]))
            # NCHW pads: [n, c, t, l, n, c, b, r]
            t_, l_, b_, r_ = pads[2], pads[3], pads[6], pads[7]
            mode = nd.attr("mode", b"constant")
            mode = mode.decode() if isinstance(mode, bytes) else mode
            g.add(Node(name, "ZeroPadding2D", dyn_inputs[:1],
                       {"pad_top": int(t_), "pad_bottom": int(b_),
                        "pad_left": int(l_), "pad_right": int(r_),
                        "mode": {"constant": "constant", "reflect": "reflect",
                                 "edge": "replicate"}.get(mode, "constant")}))
        elif op in ("Flatten", "Reshape"):
            g.add(Node(name, "Flatten", dyn_inputs[:1], {"_onnx_nchw": True}))
        elif op == "Gemm":
            w = np.asarray(get_init(nd.inputs[1]), np.float32)
            if int(nd.attr("transB", 0) or 0) == 1:
                w = w.T  # -> (in, units)
            b = get_init(nd.inputs[2]) if len(nd.inputs) > 2 else None
            params = {"weight": w}
            if b is not None:
                params["bias"] = np.asarray(b, np.float32)
            g.add(Node(name, "Dense", dyn_inputs[:1],
                       {"units": w.shape[1], "use_bias": b is not None,
                        "_onnx_nchw_reorder": True}, params))
        elif op == "DepthToSpace":
            g.add(Node(name, "Subpixel", dyn_inputs,
                       {"scale": int(nd.attr("blocksize", 2) or 2)}))
        else:
            raise ValueError(f"unsupported ONNX op {op!r} ({nd.name})")
        src[out] = name
        for extra in nd.outputs[1:]:
            src[extra] = name

    g.finalize([src[o] for o in og.outputs if o in src] or None)
    g.infer_shapes()
    _fix_nchw_dense_order(g)
    return g


def _fix_nchw_dense_order(g: Graph) -> None:
    """ONNX Gemm weights expect CHW-major flattened features; our Flatten
    produces HWC-major. Permute the weight rows accordingly."""
    for node in list(g.nodes.values()):
        if not node.attrs.pop("_onnx_nchw_reorder", False):
            continue
        (flat_name,) = node.inputs
        flat = g.nodes[flat_name]
        if flat.op != "Flatten":
            continue
        spec = g.nodes[flat.inputs[0]].out_spec
        if not spec.is_image:
            continue
        h, w, c = spec.h, spec.w, spec.c
        wt = node.params["weight"]
        if wt.shape[0] != h * w * c:
            continue
        # rows indexed CHW -> reorder to HWC
        idx = np.arange(h * w * c).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)
        node.params["weight"] = np.ascontiguousarray(wt[idx])


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Convert a model to a shadernn_tpu artifact "
        "(reference convertTool.py flag surface)"
    )
    ap.add_argument("-f", "--file", required=True, help="input .h5/.onnx")
    ap.add_argument("-d", "--decouple", action="store_true",
                    help="emit _layers.json + _weights.bin instead of monolithic JSON")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    args = ap.parse_args(argv)

    input_hw = (args.height, args.width) if args.height else None
    ext = os.path.splitext(args.file)[1].lower()
    if ext == ".h5":
        graph = convert_h5(args.file, input_hw=input_hw)
    elif ext == ".onnx":
        graph = convert_onnx(args.file, input_hw=input_hw)
    else:
        raise SystemExit(f"unsupported input format {ext}")

    graph.infer_shapes()
    out = args.output or os.path.splitext(args.file)[0] + ".json"
    from shadernn_tpu_torch.graph.serialize import save_model

    save_model(graph, out, decouple=args.decouple)
    logger.info("wrote %s (%d layers, %d params)", out, len(graph.nodes),
                graph.num_params)
    print(graph.summary())


if __name__ == "__main__":
    main()
