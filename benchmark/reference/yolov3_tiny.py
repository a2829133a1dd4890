"""YOLOv3-tiny (darknet's cfg/yolov3-tiny.cfg; Redmon and Farhadi,
arXiv:1804.02767) in the layer order of the trained artifact's weight
stream.

The backbone: a 3x3 conv up each of ``widths``, each but the last followed
by a 2x2 max pool, at stride 2 except the last pool, at stride 1 with
"same" padding. Then a 1x1 conv to ``bottleneck``; the coarse head, a 3x3
conv to ``head_widths[0]`` and a 1x1 conv to the head's channels; the
route, a 1x1 conv to ``route_width`` from the bottleneck, a nearest upsample
by 2, and a concat with the backbone conv ``route_from``; the fine head, a
3x3 conv to ``head_widths[1]`` and a 1x1 conv. A head has len(mask) * (5 +
``classes``) channels, anchor by anchor [tx, ty, tw, th, objectness, class
logits]. Every conv but the heads ends with darknet's ``leaky`` (0.1 x
below 0). Then the YOLO layer: both heads decoded on their grids, and
class-aware greedy NMS.

Departures from darknet, all as the program under test defines its
output: a box gives one row, for its best class (the class taken by its
logit; score = objectness x that class's probability), where darknet gives
one for every class above the threshold; the ``max_detections`` best
candidates at or above ``score_threshold`` go into NMS, and darknet has no
such cap; a row is [class, score, x, y, w, h] with x, y the top-left
corner, normalized by the frame, and an empty row is all 0. Darknet's batch
norm is folded into the artifact's conv biases.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.plain import Op, _free, _none


def layers(cfg: dict) -> list:
    w, c = list(cfg["widths"]), cfg["channels"]
    head_c = [len(m) * (5 + cfg["classes"]) for m in cfg["masks"]]
    act = cfg["activation"]
    out = []

    def conv(name, k, ci, co, act=act, src=None):
        out.append({"name": name, "op": "conv", "k": k, "cin": ci, "cout": co, "stride": 1,
                    "act": act, **({"from": [src]} if src else {})})

    for i, co in enumerate(w):
        conv(f"l{i}_conv", 3, w[i - 1] if i else c, co)
        if i < len(w) - 2:
            out.append({"name": f"pool{i}", "op": "max_pool", "k": 2, "stride": 2,
                        "padding": "valid"})
        elif i == len(w) - 2:
            out.append({"name": f"pool{i}", "op": "max_pool", "k": 2, "stride": 1,
                        "padding": "same"})
    b, r = len(w), cfg["route_from"]
    conv(f"l{b}_conv", 1, w[-1], cfg["bottleneck"])
    conv("h1_conv", 3, cfg["bottleneck"], cfg["head_widths"][0])
    conv(f"l{b + 1}_conv", 1, cfg["bottleneck"], cfg["route_width"], src=f"l{b}_conv")
    conv("head1", 1, cfg["head_widths"][0], head_c[0], act="linear", src="h1_conv")
    out.append({"name": "up", "op": "upsample", "scale": 2, "from": [f"l{b + 1}_conv"]})
    out.append({"name": "route_concat", "op": "concat", "from": ["up", f"l{r}_conv"]})
    conv("h2_conv", 3, cfg["route_width"] + w[r], cfg["head_widths"][1])
    conv("head2", 1, cfg["head_widths"][1], head_c[1], act="linear")
    out.append({"name": "yolo", "op": "yolo", "from": ["head1", "head2"],
                "anchors": cfg["anchors"], "masks": cfg["masks"], "classes": cfg["classes"],
                "net_hw": cfg["net_hw"], "score_threshold": cfg["score_threshold"],
                "nms_iou": cfg["nms_iou"], "max_detections": cfg["max_detections"]})
    return out


def _pool_shape(layer, hwc):
    h, w, c = hwc
    k, s = layer["k"], layer["stride"]
    if layer["padding"] == "same":
        return math.ceil(h / s), math.ceil(w / s), c
    return (h - k) // s + 1, (w - k) // s + 1, c


def _pool_forward(layer, p, y, outs, q):
    """Max over each window; "same" pads as TensorFlow does, the extra row
    and column at the bottom and right, with -inf (for darknet's size-2,
    stride-1 pool: the window at each pixel reaches right and down)."""
    k, s = layer["k"], layer["stride"]
    if layer["padding"] == "same":
        h, w = y.shape[2:]
        ph = max((math.ceil(h / s) - 1) * s + k - h, 0)
        pw = max((math.ceil(w / s) - 1) * s + k - w, 0)
        y = F.pad(y, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=float("-inf"))
    return F.max_pool2d(y, k, s)


def _concat_shape(layer, shapes):
    h, w, _ = shapes[0]
    if any(s[:2] != (h, w) for s in shapes):
        raise ValueError(f"layer {layer['name']!r}: concat of frames of sizes {shapes}")
    return h, w, sum(s[2] for s in shapes)


def decode(feat: torch.Tensor, anchors, net_hw, classes: int):
    """One head (N, A * (5 + C), gh, gw) -> boxes (N, gh * gw * A, 4) [x, y, w,
    h] top-left, normalized, scores and classes (N, gh * gw * A), in the
    order row, column, anchor, in float32. Darknet's decode: centre ((col,
    row) + sigmoid(tx, ty)) / grid, size exp(tw, th) * anchor / net size; a
    box's class is its largest class logit (the first, where two tie), its
    score sigmoid(objectness) x sigmoid(that logit)."""
    n, _, gh, gw = feat.shape
    a = len(anchors)
    f = feat.float().view(n, a, 5 + classes, gh, gw).permute(0, 3, 4, 1, 2)
    col = torch.arange(gw, dtype=torch.float32, device=feat.device).view(1, 1, gw, 1)
    row = torch.arange(gh, dtype=torch.float32, device=feat.device).view(1, gh, 1, 1)
    anc = torch.tensor(anchors, dtype=torch.float32, device=feat.device)
    cx = (col + torch.sigmoid(f[..., 0])) / gw
    cy = (row + torch.sigmoid(f[..., 1])) / gh
    bw = torch.exp(f[..., 2]) * anc[:, 0] / net_hw[1]
    bh = torch.exp(f[..., 3]) * anc[:, 1] / net_hw[0]
    best, cls = f[..., 5:].max(dim=-1)
    scores = torch.sigmoid(f[..., 4]) * torch.sigmoid(best)
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, bw, bh], dim=-1)
    return boxes.reshape(n, -1, 4), scores.reshape(n, -1), cls.reshape(n, -1)


def nms(boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray, score_threshold: float,
        iou_threshold: float, max_det: int) -> list:
    """One image, in float64: the kept boxes' indices, in score order. The
    ``max_det`` best candidates at or above the threshold (a stable sort:
    ties keep the decode's order), then each in score order is kept unless
    a kept box of its class overlaps it by more than ``iou_threshold``."""
    cand = np.flatnonzero(scores >= score_threshold)
    kept = []
    for i in cand[np.argsort(-scores[cand], kind="stable")][:max_det]:
        x0, y0, w, h = boxes[i]
        for j in kept:
            if classes[j] != classes[i]:
                continue
            u0, v0, uw, vh = boxes[j]
            iw = max(min(x0 + w, u0 + uw) - max(x0, u0), 0.0)
            ih = max(min(y0 + h, v0 + vh) - max(y0, v0), 0.0)
            inter = iw * ih
            if inter / (w * h + uw * vh - inter) > iou_threshold:
                break
        else:
            kept.append(i)
    return kept


def _yolo_forward(layer, p, heads, outs, q):
    """The kept rows of each frame, (N, max_detections, 6): [class, score, x,
    y, w, h] in score order, then rows of 0."""
    parts = [decode(f, [layer["anchors"][m] for m in mask], layer["net_hw"], layer["classes"])
             for f, mask in zip(heads, layer["masks"])]
    boxes, scores, classes = (torch.cat(x, dim=1).cpu().numpy().astype(np.float64)
                              for x in zip(*parts))
    out = np.zeros((len(boxes), layer["max_detections"], 6))
    for n, (b, s, c) in enumerate(zip(boxes, scores, classes)):
        kept = nms(b, s, c, layer["score_threshold"], layer["nms_iou"], layer["max_detections"])
        out[n, :len(kept)] = np.concatenate([c[kept, None], s[kept, None], b[kept]], axis=1)
    return torch.tensor(out, dtype=torch.float32, device=heads[0].device)


OPS = {
    "max_pool": Op(_none, _pool_shape, _free, _pool_forward),
    "upsample": Op(_none, lambda l, i: (i[0] * l["scale"], i[1] * l["scale"], i[2]), _free,
                   lambda l, p, y, outs, q: y.repeat_interleave(l["scale"], dim=2)
                   .repeat_interleave(l["scale"], dim=3)),
    "concat": Op(_none, _concat_shape, _free, lambda l, p, ys, outs, q: torch.cat(ys, dim=1)),
    "yolo": Op(_none, lambda l, i: (1, l["max_detections"], 6), _free, _yolo_forward),
}
ACTS = {"leaky": lambda t: F.leaky_relu(t, 0.1)}
