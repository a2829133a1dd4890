"""ShaderNN model-artifact reader: JSON (inline weights) or decoupled
`*_layers.json` + `*_weights.bin` -> Graph.

Faithful to the reference's ModelParser (core/src/ic2/modelparser.cpp):

- Top level: `numLayers.count` (modelparser.cpp:40-44), `Layer_<i>` objects,
  optional model block `node` {upscale, inputChannels, useSubpixel} and
  `block_0` {"Input Width"/"Input Height"} (modelparser.cpp:260-286),
  `inputRange` (modelparser.cpp:31-36).
- Per layer: `type` (with Lambda resolved via `name`, modelparser.cpp:81-88),
  `numInputs` + `inputId` wiring, per-type fields as read by the
  get*Layer methods.
- Conv kernels are streamed O-major: for o in O: for i in I: k*k row-major
  (modelparser.cpp getConvolutionLayer weight loop) -> converted here to
  our HWIO layout by the native runtime (native.py), as the JAX parser
  does.
- Decoupled mode: weights in a little-endian float32 stream, consumed in
  layer order: kernel, bias (if useBias), then BN gamma, beta, movingMean,
  movingVariance (if useBatchNormalization) (modelparser.cpp:512-721).
- Padding field variants: scalar number, string ("same"/"valid"/digits),
  [v, h] pair, or [[t,b],[l,r]] nested + "mode"
  (modelparser.cpp getConvolutionLayer padding try-chain).
"""

from __future__ import annotations

import json
import os
from typing import BinaryIO, Dict, Optional

import numpy as np

from shadernn_tpu_torch import native
from shadernn_tpu_torch.graph.ir import Graph, Node


def _as_bool(v, default=False) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() == "true"
    if v is None:
        return default
    return bool(v)


def _padding_attr(layer: dict):
    """Normalize the reference's padding field variants to our attr form."""
    p = layer.get("padding", "same")
    if isinstance(p, list):
        if p and isinstance(p[0], list):  # [[t,b],[l,r]]
            return (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
        if len(p) == 2:  # [vertical, horizontal]
            return (int(p[0]), int(p[0]), int(p[1]), int(p[1]))
        return tuple(int(x) for x in p)
    if isinstance(p, (int, float)):
        return int(p)
    return str(p)


class _WeightStream:
    """Sequential float32 reader over *_weights.bin (modelparser.cpp:512+).
    In monolithic mode, reads from inline JSON arrays instead."""

    def __init__(self, f: Optional[BinaryIO]):
        self.f = f

    def read(self, count: int) -> np.ndarray:
        assert self.f is not None, "decoupled artifact missing weights.bin"
        data = np.fromfile(self.f, dtype="<f4", count=count)
        if data.size != count:
            raise ValueError(
                f"weights.bin exhausted: wanted {count} floats, got {data.size}"
            )
        return data


def _conv_weights(layer, stream, o, i, k, is_bin):
    if is_bin:
        flat = stream.read(o * i * k * k)
    else:
        flat = np.asarray(layer["weights"]["kernel"], np.float32)
    # OIHW -> HWIO in the native runtime (native.py)
    return native.repack_oihw_to_hwio(flat, o, i, k, k)


def _bias(layer, stream, o, is_bin):
    if not _as_bool(layer.get("useBias", "True"), True):
        return None
    if is_bin:
        return stream.read(o)
    return np.asarray(layer["weights"]["bias"], np.float32)


def _bn_params(layer, stream, o, is_bin) -> Dict[str, np.ndarray]:
    if is_bin:
        gamma, beta = stream.read(o), stream.read(o)
        mean, var = stream.read(o), stream.read(o)
    else:
        bn = layer["batchNormalization"]
        gamma = np.asarray(bn["gamma"], np.float32)
        beta = np.asarray(bn["beta"], np.float32)
        mean = np.asarray(bn.get("movingMean", bn.get("moving_mean")), np.float32)
        var = np.asarray(
            bn.get("movingVariance", bn.get("moving_variance")), np.float32
        )
    return {"gamma": gamma, "beta": beta, "mean": mean, "variance": var}


def _act_attrs(layer) -> dict:
    attrs = {}
    act = layer.get("activation")
    if act:
        attrs["activation"] = act
        if act in ("leakyRelu", "leaky_relu", "LeakyReLU"):
            attrs["activation"] = "leaky_relu"
            alpha = layer.get("leakyReluAlpha", layer.get("alpha", 0.3))
            attrs["leaky_alpha"] = float(alpha)
    return attrs


def parse_model_dict(model: dict, bin_file: Optional[BinaryIO] = None,
                     name: str = "model",
                     input_hw: Optional[tuple] = None) -> Graph:
    """`input_hw` overrides the artifact's frame geometry — CNN weights are
    size-agnostic, and the reference runs the same artifact at whatever
    frame size the processor feeds it (inferenceProcessor resize path). A
    YOLO layer's `net_hw` follows it: the decode divides the anchors by the
    size of the frame the network sees. (The JAX parser keeps the
    artifact's `net_hw`.)"""
    g = Graph(name)
    g.meta["inputRange"] = model.get("inputRange")
    count = int(model["numLayers"]["count"])
    stream = _WeightStream(bin_file)
    is_bin = bin_file is not None
    idx_to_name: Dict[int, str] = {}

    for idx in range(count):
        layer = model[f"Layer_{idx}"]
        ltype = layer["type"]
        if ltype == "Lambda":  # Lambda resolved via name (modelparser.cpp:84)
            ltype = layer["name"]
        lname = layer.get("name", f"layer_{idx}")
        if lname in g.nodes:
            lname = f"{lname}_{idx}"
        num_in = int(layer.get("numInputs", 1 if idx > 0 else 0))
        in_ids = [int(i) for i in layer.get("inputId", [])][:num_in]
        inputs = [idx_to_name[i] for i in in_ids]

        attrs: dict = {}
        params: Dict[str, np.ndarray] = {}
        out_planes = int(layer.get("outputPlanes", 0) or 0)
        in_planes = int(layer.get("inputPlanes", 0) or 0)

        if ltype == "InputLayer":
            attrs = {
                "height": int(input_hw[0]) if input_hw else int(layer["Input Height"]),
                "width": int(input_hw[1]) if input_hw else int(layer["Input Width"]),
                "channels": out_planes or 1,
                "index": int(layer.get("inputIndex", 0)),
            }
            op = "InputLayer"
        elif ltype in ("Conv2D", "Convolution"):
            k = int(layer["kernel_size"])
            attrs = {
                "kernel_size": k,
                "stride": int(layer.get("strides", layer.get("stride", 1))),
                "padding": _padding_attr(layer),
                "out_channels": out_planes,
                "use_bias": _as_bool(layer.get("useBias", "True"), True),
                **_act_attrs(layer),
            }
            if "mode" in layer:
                attrs["padding_mode"] = layer["mode"]
            params["weight"] = _conv_weights(layer, stream, out_planes, in_planes, k, is_bin)
            b = _bias(layer, stream, out_planes, is_bin)
            if b is not None:
                params["bias"] = b
            if _as_bool(layer.get("useBatchNormalization")):
                bn = _bn_params(layer, stream, out_planes, is_bin)
                attrs["use_batchnorm"] = True
                params.update({f"bn_{k_}" if k_ != "variance" else "bn_variance": v
                               for k_, v in bn.items()})
            if _as_bool(layer.get("use_multi_inputs")):
                attrs["use_multi_inputs"] = True
            op = "Conv2D"
        elif ltype in ("SeparableConv2D", "DepthwiseConv2D"):
            k = int(layer.get("kernel_size", layer.get("Depthwise_Kernel", 3)))
            mult = int(layer.get("depth_multiplier", 1))
            attrs = {
                "kernel_size": k,
                "stride": int(layer.get("strides", layer.get("stride", 1))),
                "padding": _padding_attr(layer),
                "multiplier": mult,
                "use_bias": _as_bool(layer.get("useBias", "True"), True),
                **_act_attrs(layer),
            }
            o = out_planes or in_planes * mult
            if is_bin:
                flat = stream.read(o * k * k)
            else:
                flat = np.asarray(layer.get("depthwise_weights",
                                            layer.get("weights", {}).get("kernel")),
                                  np.float32)
            # depthwise stream is per-output-channel kxk -> HW1O
            params["weight"] = native.repack_dw_to_hw1o(flat, o, k, k)
            b = _bias(layer, stream, o, is_bin)
            if b is not None:
                params["bias"] = b
            if _as_bool(layer.get("useBatchNormalization")):
                bn = _bn_params(layer, stream, o, is_bin)
                attrs["use_batchnorm"] = True
                params.update({f"bn_{k_}" if k_ != "variance" else "bn_variance": v
                               for k_, v in bn.items()})
            op = "SeparableConv2D"
        elif ltype == "Conv2DTranspose":
            k = int(layer["kernel_size"])
            attrs = {
                "kernel_size": k,
                "stride": int(layer.get("strides", layer.get("stride", 1))),
                "padding": _padding_attr(layer),
                "out_channels": out_planes,
                "use_bias": _as_bool(layer.get("useBias", "True"), True),
                **_act_attrs(layer),
            }
            params["weight"] = _conv_weights(layer, stream, out_planes, in_planes, k, is_bin)
            b = _bias(layer, stream, out_planes, is_bin)
            if b is not None:
                params["bias"] = b
            op = "Conv2DTranspose"
        elif ltype == "Dense":
            units = int(layer.get("units", out_planes))
            attrs = {"units": units,
                     "use_bias": _as_bool(layer.get("useBias", "True"), True),
                     **_act_attrs(layer)}
            if is_bin:
                w = stream.read(in_planes * units).reshape(in_planes, units)
            else:
                flat = np.asarray(layer["weights"]["kernel"], np.float32)
                w = flat.reshape(-1, units)
            params["weight"] = w
            b = _bias(layer, stream, units, is_bin)
            if b is not None:
                params["bias"] = b
            op = "Dense"
        elif ltype in ("MaxPooling2D", "AveragePooling2D"):
            attrs = {
                "kernel_size": int(layer.get("pool_size", layer.get("pool", 2))),
                "stride": int(layer.get("strides", layer.get("stride", 2))),
                "padding": _padding_attr(layer),
            }
            op = ltype
        elif ltype == "AdaptiveAvgPool2d":
            out_sz = int(layer.get("output_size", layer.get("pool_size", 1)))
            attrs = {"output_height": out_sz, "output_width": out_sz}
            op = "AdaptiveAvgPool2d"
        elif ltype == "BatchNormalization":
            attrs = {"epsilon": float(layer.get("epsilon", 1e-3)), **_act_attrs(layer)}
            params.update(_bn_params(layer, stream, out_planes, is_bin))
            op = "BatchNormalization"
        elif ltype in ("InstanceNormalization", "InstanceNorm"):
            attrs = {"epsilon": float(layer.get("epsilon", 1e-5)), **_act_attrs(layer)}
            if is_bin:
                params["gamma"] = stream.read(out_planes)
                params["beta"] = stream.read(out_planes)
            elif "batchNormalization" in layer:
                bn = layer["batchNormalization"]
                params["gamma"] = np.asarray(bn["gamma"], np.float32)
                params["beta"] = np.asarray(bn["beta"], np.float32)
            op = "InstanceNormalization"
        elif ltype == "Add":
            attrs = _act_attrs(layer)
            op = "Add"
        elif ltype == "Concatenate":
            op = "Concatenate"
        elif ltype == "Activation":
            attrs = _act_attrs(layer) or {"activation": "relu"}
            op = "Activation"
        elif ltype == "Flatten":
            op = "Flatten"
        elif ltype == "UpSampling2D":
            attrs = {
                "scale": int(float(layer.get("scale", layer.get("scaleFactor", 2)))),
                "interpolation": layer.get("interpolation", "nearest"),
            }
            op = "UpSampling2D"
        elif ltype in ("ZeroPadding2D", "Pad"):
            pads = layer.get("pads", layer.get("padding", [0, 0, 0, 0]))
            attrs = {"padding": _padding_attr({"padding": pads}),
                     "mode": layer.get("mode", "constant"),
                     "value": float(layer.get("padding_value", 0.0))}
            op = "ZeroPadding2D"
        elif ltype in ("Subpixel", "DepthToSpace"):
            attrs = {"scale": int(layer.get("scale", layer.get("scaleFactor", 2)))}
            op = "Subpixel"
        elif ltype == "Calculate":
            attrs = {"expr": layer.get("expr", "merge_y_uv")}
            op = "Calculate"
        elif ltype == "YOLO":
            attrs = {k: layer[k] for k in
                     ("num_classes", "net_hw", "max_detections", "anchors", "masks")
                     if k in layer}
            if input_hw:  # the decode scales the anchors by the frame it runs on
                attrs["net_hw"] = [int(input_hw[0]), int(input_hw[1])]
            op = "YOLO"
        elif ltype == "Unary":
            attrs = {"op_type": layer.get("op_type", "abs"),
                     "op_value": float(layer.get("op_value", 1.0))}
            op = "Unary"
        else:
            raise ValueError(f"unknown layer type {ltype!r} at Layer_{idx}")

        g.add(Node(lname, op, inputs, attrs, params))
        idx_to_name[idx] = lname

    g.finalize()
    return g


def parse_model_file(path, input_hw: Optional[tuple] = None) -> Graph:
    """Load monolithic JSON or a decoupled `*_layers.json` (+ sibling
    `*_weights.bin`, following the reference's naming convention,
    modelparser.cpp:238-253). `input_hw` optionally re-targets the frame
    geometry (see parse_model_dict)."""
    path = os.fspath(path)
    with open(path) as f:
        model = json.load(f)
    bin_file = None
    if path.endswith("_layers.json"):
        bin_path = path[: -len("_layers.json")] + "_weights.bin"
        if "bin_file_name" in model:
            bin_path = os.path.join(os.path.dirname(path), model["bin_file_name"])
        bin_file = open(bin_path, "rb")
    try:
        name = os.path.splitext(os.path.basename(path))[0]
        return parse_model_dict(model, bin_file, name=name, input_hw=input_hw)
    finally:
        if bin_file:
            bin_file.close()
