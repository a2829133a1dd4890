"""A float32 forward of a list of layers, in plain PyTorch, and the table of
ops that both it and the cost model (`harness/cost.py`) dispatch through.

A family module (`reference/<family>.py`) makes the layer dicts from a
configuration's sizes (``layers(config)``). Each dict names its ``op``; the
op's entry in the table says everything the benchmark knows of it: the
weights it reads from the artifact's stream, the shape it makes, the
operations it costs and its forward. The ops every family may use are
below (`OPS`); a family that needs another exports ``OPS`` (and new
activations ``ACTS``) of its own, so a new architecture is one new file.
An op or activation that no table holds is an error, here and in the cost
model alike.

- ``conv``: k x k convolution, ``cin`` -> ``cout``, ``stride``, ``groups``
  (default 1; ``cin`` for a depthwise conv); zero padding of k // 2 on every
  side (ShaderNN's "same" for odd k), bias.
- ``conv_transpose``: the scatter y[i * s + a] += x[i] * w[a] of a k x k
  kernel at stride s, cropped to s times the input ("same"), bias.
- ``instance_norm``: per frame and channel over H and W, biased variance,
  ``eps``, gamma and beta.
- ``add``: the previous output plus the output of layer ``skip`` (a name).
- ``depth_to_space``: TensorFlow's order, channel (py * r + px) * co + c.
- ``act``: the activation alone.

Every layer ends with its ``act`` (default ``linear``). Operations are the
products of the layer equations, two to a multiply-add: 2 * kh * kw *
(Cin / groups) * Cout per output pixel of a conv, per input pixel of a
transposed conv. Ops that multiply no weights (norms, adds, pooling,
activations) cost none.

The weights are the artifact's little-endian float32 stream, in layer order
and, within a layer, in the order of its ``weights`` (a conv's kernel
O-major (O, I / groups, kh, kw), then its bias; an instance norm's gamma,
then beta). Every value of the stream is used once.

``quantize`` (a function of a tensor) makes the precision control: it is
applied to every weight and to every conv's input, so that the products
run on values of that precision.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

HWC = Tuple[int, int, int]


class Op(NamedTuple):
    weights: Callable[[dict], Dict[str, tuple]]  # layer -> {name: shape}, in stream order
    shape: Callable[[dict, HWC], HWC]  # layer, input (h, w, c) -> output (h, w, c)
    ops: Callable[[dict, HWC, HWC], int]  # layer, input, output -> operations of a frame
    forward: Callable  # (layer, params, y NCHW, earlier outputs, quantize) -> y


def _none(layer):
    return {}


def _same(layer, hwc):
    return hwc


def _free(layer, hwc_in, hwc_out):
    return 0


def _conv_shape(layer, hwc):
    h, w, _ = hwc
    k, s = layer["k"], layer["stride"]
    return (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1, layer["cout"]


def _conv_weights(layer):
    k = layer["k"]
    return {"w": (layer["cout"], layer["cin"] // layer.get("groups", 1), k, k),
            "b": (layer["cout"],)}


def _conv_forward(layer, p, y, outs, q):
    return F.conv2d(q(y), q(p["w"]), p["b"], stride=layer["stride"], padding=layer["k"] // 2,
                    groups=layer.get("groups", 1))


def _deconv_forward(layer, p, y, outs, q):
    s, (h, w) = layer["stride"], y.shape[2:]
    y = F.conv_transpose2d(q(y), q(p["w"]).transpose(0, 1), p["b"], stride=s)
    return y[:, :, :h * s, :w * s]


def _norm_forward(layer, p, y, outs, q):
    mean = y.mean(dim=(2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (y - mean) * torch.rsqrt(var + layer["eps"])
    return y * p["gamma"].view(1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1)


def _d2s_forward(layer, p, y, outs, q):
    r = layer["scale"]
    n, c, h, w = y.shape
    co = c // (r * r)
    return y.view(n, r, r, co, h, w).permute(0, 3, 4, 1, 5, 2).reshape(n, co, h * r, w * r)


OPS: Dict[str, Op] = {
    "conv": Op(_conv_weights, _conv_shape,
               lambda l, i, o: 2 * l["k"] * l["k"] * (l["cin"] // l.get("groups", 1))
               * l["cout"] * o[0] * o[1],
               _conv_forward),
    "conv_transpose": Op(
        lambda l: {"w": (l["cout"], l["cin"], l["k"], l["k"]), "b": (l["cout"],)},
        lambda l, i: (i[0] * l["stride"], i[1] * l["stride"], l["cout"]),
        lambda l, i, o: 2 * l["k"] * l["k"] * l["cin"] * l["cout"] * i[0] * i[1],
        _deconv_forward),
    "instance_norm": Op(lambda l: {"gamma": (l["c"],), "beta": (l["c"],)}, _same, _free,
                        _norm_forward),
    "add": Op(_none, _same, _free, lambda l, p, y, outs, q: y + outs[l["skip"]]),
    "depth_to_space": Op(_none,
                         lambda l, i: (i[0] * l["scale"], i[1] * l["scale"],
                                       i[2] // l["scale"] ** 2),
                         _free, _d2s_forward),
    "act": Op(_none, _same, _free, lambda l, p, y, outs, q: y),
}

ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda t: t,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


class Model(NamedTuple):
    """A family's layers at a configuration's sizes, with the tables they
    dispatch through."""
    layers: List[dict]
    ops: Dict[str, Op]
    acts: Dict[str, Callable]

    def op(self, layer: dict) -> Op:
        if layer["op"] not in self.ops:
            raise ValueError(f"layer {layer.get('name')!r}: unknown op {layer['op']!r} "
                             f"(the tables hold {sorted(self.ops)})")
        return self.ops[layer["op"]]

    def act(self, layer: dict) -> Callable:
        name = layer.get("act", "linear")
        if name not in self.acts:
            raise ValueError(f"layer {layer.get('name')!r}: unknown activation {name!r}")
        return self.acts[name]


def model(family, config: dict) -> Model:
    """The layers of ``family`` (a `reference/<family>.py` module) at
    ``config``'s sizes, with the common tables and the family's own."""
    return Model(family.layers(config), {**OPS, **getattr(family, "OPS", {})},
                 {**ACTS, **getattr(family, "ACTS", {})})


def read_weights(m: Model, path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The weights of ``m``'s layers from the stream at ``path``."""
    flat = np.fromfile(path, dtype="<f4")
    at = 0
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for layer in m.layers:
        for key, shape in m.op(layer).weights(layer).items():
            n = math.prod(shape)
            if at + n > flat.size:
                raise ValueError(f"{path}: the stream ends at {flat.size} floats, "
                                 f"wanted {at + n}")
            params.setdefault(layer["name"], {})[key] = flat[at:at + n].reshape(shape)
            at += n
    if at != flat.size:
        raise ValueError(f"{path}: {flat.size - at} floats left over after the last layer")
    return params


def to_device(params, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {name: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in p.items()} for name, p in params.items()}


def ingest(raw: torch.Tensor, means, norms) -> torch.Tensor:
    """uint8 NHWC frames -> float32 NHWC, y = (x - mean) * norm per channel."""
    c = raw.shape[-1]
    mean = torch.tensor((list(means) * c)[:c], dtype=torch.float32, device=raw.device)
    norm = torch.tensor((list(norms) * c)[:c], dtype=torch.float32, device=raw.device)
    return (raw.float() - mean) * norm


def forward(m: Model, params, x: torch.Tensor,
            quantize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """float32 NHWC in, float32 NHWC out. TF32 is off for the call."""
    q = quantize or (lambda t: t)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = x.permute(0, 3, 1, 2).float()
        outs = {}
        for layer in m.layers:
            y = m.op(layer).forward(layer, params.get(layer["name"]), y, outs, q)
            y = m.act(layer)(y)
            outs[layer["name"]] = y
        return y.permute(0, 2, 3, 1).contiguous()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def artifact_weights(root: str, config: dict) -> str:
    """The path of the configuration's weight stream (``*_weights.bin`` beside
    its ``*_layers.json``)."""
    layers_json = os.path.join(root, config["artifact"])
    return layers_json[: -len("_layers.json")] + "_weights.bin"
