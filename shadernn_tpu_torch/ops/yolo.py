"""YOLO detection head: grid decode and NMS on the device (counterpart of
shadernn_tpu/ops/yolo.py).

The decode is vectorized over every grid cell, the candidates are the
`max_detections` best scores by a stable descending sort (ties go to the
lower index, as `lax.top_k` breaks them), and the class-aware greedy
suppression is a loop of `max_detections` batched steps over the score-
sorted rows: static shapes, no host sync, no branch on device values.

Output: (N, max_detections, 6) rows [class_id, score, x, y, w, h] in
normalized [0, 1] image coordinates (x, y the top-left corner), suppressed
and below-threshold rows with score 0. Everything is float32 whatever the
activation dtype. Anchor and mask defaults are YOLOv3-tiny's.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from shadernn_tpu_torch.graph.ir import Node, TensorSpec
from shadernn_tpu_torch.ops.registry import OpDef, RunCtx, register

YOLOV3_TINY_ANCHORS = (
    (10.0, 14.0), (23.0, 27.0), (37.0, 58.0),
    (81.0, 82.0), (135.0, 169.0), (344.0, 319.0),
)
YOLOV3_TINY_MASKS = ((3, 4, 5), (1, 2, 3))  # per grid scale (32, 16)


@functools.lru_cache(maxsize=None)
def _anchors(anchors, device: torch.device) -> torch.Tensor:
    """The (A, 2) anchor tensor on `device`, made once: a copy from the host
    in every step would wait for the device's queue."""
    return torch.tensor(anchors, dtype=torch.float32, device=device)


def decode_grid(feat: torch.Tensor, anchors, net_hw, num_classes: int):
    """Decode one feature map (N, gh, gw, A*(5+C)) -> (boxes (N, gh*gw*A, 4)
    [x, y, w, h] top-left normalized, scores (N, gh*gw*A), classes
    (N, gh*gw*A)): cx = (grid x + sigmoid(t)) / gw, w = exp(t) * anchor /
    net width, score = sigmoid(obj) * sigmoid(max class logit)."""
    n, gh, gw, _ = feat.shape
    a = len(anchors)
    feat = feat.reshape(n, gh, gw, a, feat.shape[-1] // a)
    gx = torch.arange(gw, dtype=torch.float32, device=feat.device).view(1, 1, gw, 1)
    gy = torch.arange(gh, dtype=torch.float32, device=feat.device).view(1, gh, 1, 1)
    cx = (gx + torch.sigmoid(feat[..., 0])) / gw
    cy = (gy + torch.sigmoid(feat[..., 1])) / gh
    anc = _anchors(tuple(tuple(float(v) for v in a) for a in anchors), feat.device)
    net_h, net_w = net_hw
    bw = torch.exp(feat[..., 2]) * anc[:, 0] / net_w
    bh = torch.exp(feat[..., 3]) * anc[:, 1] / net_h
    best, cls_id = feat[..., 5:].max(dim=-1)  # the first maximum, as jnp.argmax
    scores = torch.sigmoid(feat[..., 4]) * torch.sigmoid(best)
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, bw, bh], dim=-1)
    m = gh * gw * a
    return boxes.reshape(n, m, 4), scores.reshape(n, m), cls_id.reshape(n, m)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
              iou_threshold: float, score_threshold: float, max_det: int) -> torch.Tensor:
    """Class-aware greedy NMS on the `max_det` best candidates of each of N
    samples: boxes (N, M, 4), scores and classes (N, M) -> (N, max_det, 6).
    Rows are score-sorted; a kept row suppresses every later row of its
    class with IoU above the threshold. With fewer than `max_det`
    candidates, empty ones are appended so that the shape stays static."""
    scores = torch.where(scores >= score_threshold, scores, torch.zeros_like(scores))
    pad = max_det - scores.shape[1]
    if pad > 0:
        scores = torch.nn.functional.pad(scores, (0, pad))
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        classes = torch.nn.functional.pad(classes, (0, pad))
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :max_det], idx[:, :max_det]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, idx)

    x0, y0 = top_boxes[..., 0], top_boxes[..., 1]
    x1, y1 = x0 + top_boxes[..., 2], y0 + top_boxes[..., 3]
    area = top_boxes[..., 2] * top_boxes[..., 3]
    iw = (torch.minimum(x1[:, :, None], x1[:, None, :])
          - torch.maximum(x0[:, :, None], x0[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y1[:, :, None], y1[:, None, :])
          - torch.maximum(y0[:, :, None], y0[:, None, :])).clamp_min(0.0)
    inter = iw * ih
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-9)
    later = torch.ones(max_det, max_det, dtype=torch.bool, device=scores.device).triu(1)
    # suppresses[n, i, j]: row i, if kept, removes the later row j.
    suppresses = (iou > iou_threshold) & (top_classes[:, :, None] == top_classes[:, None, :]) & later
    spared = ~suppresses
    keep = top_scores > 0
    for i in range(max_det):  # two launches a row, none waiting for the host
        keep = torch.where(keep[:, i:i + 1], keep & spared[:, i], keep)
    out_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    return torch.cat([top_classes[..., None].float(), out_scores[..., None], top_boxes], dim=-1)


@register("YOLO", "Yolo", "YoloDetection")
class YOLO(OpDef):
    """Multi-scale YOLO head. Inputs: one feature map per grid scale,
    coarse first (YOLOGridScale = {32, 16}), decoded in float32."""

    def infer(self, node: Node, in_specs: Sequence[TensorSpec]) -> TensorSpec:
        max_det = int(node.attr("max_detections", 100))
        return in_specs[0].with_shape((in_specs[0].n, max_det, 6))

    def run(self, node: Node, xs: List, ctx: RunCtx):
        anchors = node.attr("anchors", YOLOV3_TINY_ANCHORS)
        masks = node.attr("masks", YOLOV3_TINY_MASKS)
        num_classes = int(node.attr("num_classes", 1))
        net_hw = node.attr("net_hw", (416, 416))
        decoded = [decode_grid(feat.float(), [anchors[m] for m in mask], net_hw, num_classes)
                   for feat, mask in zip(xs, masks)]
        boxes, scores, classes = (torch.cat(parts, dim=1) for parts in zip(*decoded))
        return nms_fixed(boxes, scores, classes, float(node.attr("iou_threshold", 0.45)),
                         float(node.attr("score_threshold", 0.35)),
                         int(node.attr("max_detections", 100)))


def encode_grid(gts, gh: int, gw: int, anchors, net_hw, num_classes: int,
                obj_logit: float = 8.0, bg_logit: float = -12.0) -> np.ndarray:
    """Inverse of decode_grid (numpy), for end-to-end checks: a feature map
    whose decode yields exactly `gts`, per image a list of rows [class, x,
    y, w, h] (top-left, normalized: the mAP ground-truth format of
    utils/metrics.py). Each box goes into its centre cell with the best-
    matching anchor; every other cell carries obj = bg_logit (score ~ 0)."""
    a = len(anchors)
    no = 5 + num_classes
    n = len(gts)
    net_h, net_w = net_hw
    feat = np.zeros((n, gh, gw, a, no), np.float32)
    feat[..., 4] = bg_logit
    feat[..., 5:] = bg_logit

    def logit(p):
        p = np.clip(p, 1e-4, 1 - 1e-4)
        return float(np.log(p / (1 - p)))

    for i, rows in enumerate(gts):
        for cls, x, y, w, h in rows:
            cx, cy = x + w / 2, y + h / 2
            gx = min(int(cx * gw), gw - 1)
            gy = min(int(cy * gh), gh - 1)
            # best anchor by log-ratio distance in (w, h)
            d = [abs(np.log(w * net_w / aw)) + abs(np.log(h * net_h / ah)) for aw, ah in anchors]
            ai = int(np.argmin(d))
            aw, ah = anchors[ai]
            cell = feat[i, gy, gx, ai]
            cell[0] = logit(cx * gw - gx)
            cell[1] = logit(cy * gh - gy)
            cell[2] = float(np.log(w * net_w / aw))
            cell[3] = float(np.log(h * net_h / ah))
            cell[4] = obj_logit
            cell[5:] = -obj_logit
            cell[5 + int(cls)] = obj_logit
    return feat.reshape(n, gh, gw, a * no)
