"""ShaderNN model-artifact writer: Graph -> JSON (+ optional weights.bin)
(counterpart of shadernn_tpu/graph/serialize.py, whose files it writes byte
for byte).

Inverse of graph/parser.py, emitting the same schema the reference's
ModelParser reads (modelparser.cpp) and its convertTool produces
(tools/convertTool/layers/supportedLayers/conv2d.py:75-100): `Layer_<i>`
entries with `numLayers.count`, conv kernels flattened O-major OIHW,
`useBias`/`useBatchNormalization` as "True"/"False" strings, decoupled
mode writing a little-endian float32 `_weights.bin` stream.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np

from shadernn_tpu_torch.graph.ir import Graph, Node


def _pad_json(p):
    if isinstance(p, tuple) and len(p) == 4:
        return [[p[0], p[1]], [p[2], p[3]]]
    return p


def _conv_kernel_flat(w_hwio: np.ndarray) -> np.ndarray:
    # HWIO -> OIHW, flattened O-major (parser reads for o: for i: k*k).
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)).reshape(-1)


def serialize_graph(
    graph: Graph, decouple: bool = False
) -> Tuple[dict, Optional[np.ndarray]]:
    """Returns (model_dict, weight_stream or None). A graph not yet
    shape-inferred is inferred first (pooled and normalized layers write
    their widths), as export_onnx does."""
    if any(n.out_spec is None for n in graph.nodes.values()):
        graph.infer_shapes()
    name_to_idx = {n: i for i, n in enumerate(graph.nodes)}
    model: dict = {"numLayers": {"count": len(graph.nodes)}}
    if graph.meta.get("inputRange"):
        model["inputRange"] = graph.meta["inputRange"]
    stream: List[np.ndarray] = []

    def put_weights(layer_json: dict, node: Node):
        """Weights into JSON (inline) or the bin stream (decoupled), in the
        exact order the reference's bin reader consumes them."""

        def emit(key_path, arr):
            if decouple:
                stream.append(np.asarray(arr, "<f4").reshape(-1))
            else:
                d = layer_json
                for k in key_path[:-1]:
                    d = d.setdefault(k, {})
                d[key_path[-1]] = np.asarray(arr, np.float32).reshape(-1).tolist()

        op = node.op
        if op in ("Conv2D", "Conv2DTranspose"):
            emit(("weights", "kernel"), _conv_kernel_flat(node.params["weight"]))
            if node.attr("use_bias", True) and "bias" in node.params:
                emit(("weights", "bias"), node.params["bias"])
            if node.attr("use_batchnorm", False):
                for snn_key, pkey in (
                    ("gamma", "bn_gamma"), ("beta", "bn_beta"),
                    ("movingMean", "bn_mean"), ("movingVariance", "bn_variance"),
                ):
                    emit(("batchNormalization", snn_key), node.params[pkey])
        elif op == "SeparableConv2D":
            w = node.params["weight"]  # HW1O
            flat = np.ascontiguousarray(w[:, :, 0, :].transpose(2, 0, 1)).reshape(-1)
            if decouple:
                stream.append(np.asarray(flat, "<f4"))
            else:
                layer_json["depthwise_weights"] = flat.tolist()
            if node.attr("use_bias", True) and "bias" in node.params:
                emit(("weights", "bias"), node.params["bias"])
            if node.attr("use_batchnorm", False):
                for snn_key, pkey in (
                    ("gamma", "bn_gamma"), ("beta", "bn_beta"),
                    ("movingMean", "bn_mean"), ("movingVariance", "bn_variance"),
                ):
                    emit(("batchNormalization", snn_key), node.params[pkey])
        elif op == "Dense":
            emit(("weights", "kernel"), np.asarray(node.params["weight"]).reshape(-1))
            if node.attr("use_bias", True) and "bias" in node.params:
                emit(("weights", "bias"), node.params["bias"])
        elif op == "BatchNormalization":
            for snn_key, pkey in (
                ("gamma", "gamma"), ("beta", "beta"),
                ("movingMean", "mean"), ("movingVariance", "variance"),
            ):
                emit(("batchNormalization", snn_key), node.params[pkey])
        elif op == "InstanceNormalization":
            if "gamma" in node.params:
                emit(("batchNormalization", "gamma"), node.params["gamma"])
                emit(("batchNormalization", "beta"), node.params["beta"])

    for i, node in enumerate(graph.nodes.values()):
        spec = node.out_spec
        lj: dict = {
            "name": node.name,
            "type": node.op,
            "numInputs": len(node.inputs),
            "inputId": [name_to_idx[x] for x in node.inputs],
        }
        op = node.op
        if op == "InputLayer":
            lj.update({
                "Input Width": int(node.attrs["width"]),
                "Input Height": int(node.attrs["height"]),
                "outputPlanes": int(node.attrs["channels"]),
                "inputIndex": int(node.attr("index", 0)),
            })
        elif op in ("Conv2D", "Conv2DTranspose"):
            w = node.params["weight"]
            lj.update({
                "kernel_size": int(node.attr("kernel_size")),
                "strides": int(node.attr("stride", 1)),
                "padding": _pad_json(node.attr("padding", "same")),
                "inputPlanes": int(w.shape[2]),
                "outputPlanes": int(w.shape[3]),
                "useBias": str(bool(node.attr("use_bias", True) and "bias" in node.params)),
                "useBatchNormalization": str(bool(node.attr("use_batchnorm", False))),
                "activation": node.attr("activation", "linear"),
            })
            if node.attr("activation") == "leaky_relu":
                lj["leakyReluAlpha"] = float(node.attr("leaky_alpha", 0.3))
            put_weights(lj, node)
        elif op == "SeparableConv2D":
            w = node.params["weight"]
            lj.update({
                "kernel_size": int(node.attr("kernel_size")),
                "strides": int(node.attr("stride", 1)),
                "padding": _pad_json(node.attr("padding", "same")),
                "depth_multiplier": int(node.attr("multiplier", 1)),
                "inputPlanes": int(w.shape[3]) // int(node.attr("multiplier", 1)),
                "outputPlanes": int(w.shape[3]),
                "useBias": str(bool(node.attr("use_bias", True) and "bias" in node.params)),
                "useBatchNormalization": str(bool(node.attr("use_batchnorm", False))),
                "activation": node.attr("activation", "linear"),
            })
            put_weights(lj, node)
        elif op == "Dense":
            w = node.params["weight"]
            lj.update({
                "units": int(node.attr("units")),
                "inputPlanes": int(w.shape[0]),
                "outputPlanes": int(node.attr("units")),
                "useBias": str(bool(node.attr("use_bias", True) and "bias" in node.params)),
                "activation": node.attr("activation", "linear"),
            })
            put_weights(lj, node)
        elif op in ("MaxPooling2D", "AveragePooling2D"):
            lj.update({
                "pool_size": int(node.attr("kernel_size")),
                "strides": int(node.attr("stride")),
                "padding": _pad_json(node.attr("padding", "valid")),
                "inputPlanes": int(spec.c),
                "outputPlanes": int(spec.c),
            })
        elif op == "AdaptiveAvgPool2d":
            lj.update({
                "output_size": int(node.attr("output_height", 1)),
                "inputPlanes": int(spec.c),
                "outputPlanes": int(spec.c),
            })
        elif op in ("BatchNormalization", "InstanceNormalization"):
            lj.update({
                "epsilon": float(node.attr("epsilon", 1e-3 if op == "BatchNormalization" else 1e-5)),
                "inputPlanes": int(spec.c),
                "outputPlanes": int(spec.c),
                "activation": node.attr("activation", "linear"),
            })
            put_weights(lj, node)
        elif op == "Activation":
            lj.update({"activation": node.attr("activation", "relu")})
            if node.attr("activation") == "leaky_relu":
                lj["leakyReluAlpha"] = float(node.attr("leaky_alpha", 0.3))
        elif op == "Add":
            if node.attr("activation"):
                lj["activation"] = node.attr("activation")
        elif op == "UpSampling2D":
            lj.update({
                "scale": int(node.attr("scale", 2)),
                "interpolation": node.attr("interpolation", "nearest"),
            })
        elif op == "ZeroPadding2D":
            from shadernn_tpu_torch.ops.shape_ops import Pad

            lj.update({"pads": list(Pad._pads(node)), "mode": node.attr("mode", "constant"),
                       "padding_value": float(node.attr("value", 0.0))})
        elif op == "Subpixel":
            lj.update({"scale": int(node.attr("scale", 2))})
        elif op == "YOLO":
            lj.update({k: node.attrs[k] for k in
                       ("num_classes", "net_hw", "max_detections", "anchors", "masks")
                       if k in node.attrs})
        elif op == "Unary":
            lj.update({"op_type": node.attr("op_type"), "op_value": node.attr("op_value", 1.0)})
        elif op in ("Concatenate", "Flatten", "Calculate"):
            pass
        else:
            raise ValueError(f"cannot serialize op {op!r}")
        model[f"Layer_{i}"] = lj

    weights = np.concatenate(stream) if stream else None
    return model, weights


def save_model(graph: Graph, path: str, decouple: bool = False) -> None:
    """Write `path`.json (monolithic) or `path`_layers.json +
    `path`_weights.bin (decoupled)."""
    model, weights = serialize_graph(graph, decouple=decouple)
    if decouple:
        base = path[:-5] if path.endswith(".json") else path
        with open(base + "_layers.json", "w") as f:
            json.dump(model, f)
        (weights if weights is not None else np.zeros(0, "<f4")).astype("<f4").tofile(
            base + "_weights.bin"
        )
    else:
        with open(path if path.endswith(".json") else path + ".json", "w") as f:
            json.dump(model, f)
