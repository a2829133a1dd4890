"""Accuracy metrics (counterparts of shadernn_tpu/utils/metrics.py):
PSNR, the super-resolution and denoising gate; detection mAP (the YOLO
gate); and the precision-delta report that holds a low-precision engine
against an FP32 one on the same inputs. numpy throughout."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def top1_accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.argmax(logits, axis=-1) == labels))


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, k: int = 5) -> float:
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float(np.mean(np.any(topk == labels[:, None], axis=1)))


def psnr(a, b, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (super-resolution gate)."""
    mse = float(np.mean((_np(a).astype(np.float64) - _np(b).astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val**2 / mse))


def agreement_rate(logits_a, logits_b) -> float:
    """Fraction of identical argmax decisions between two precision modes."""
    return float(np.mean(np.argmax(_np(logits_a), -1) == np.argmax(_np(logits_b), -1)))


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix for [x, y, w, h] boxes (reference CalculateIoU,
    yololayer.cpp:56-76)."""
    ax0, ay0 = a[:, 0], a[:, 1]
    ax1, ay1 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx0, by0 = b[:, 0], b[:, 1]
    bx1, by1 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix0 = np.maximum(ax0[:, None], bx0[None, :])
    iy0 = np.maximum(ay0[:, None], by0[None, :])
    ix1 = np.minimum(ax1[:, None], bx1[None, :])
    iy1 = np.minimum(ay1[:, None], by1[None, :])
    iw = np.clip(ix1 - ix0, 0, None)
    ih = np.clip(iy1 - iy0, 0, None)
    inter = iw * ih
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    return inter / (area_a + area_b - inter + 1e-12)


def average_precision(
    pred: np.ndarray, gt: np.ndarray, iou_threshold: float = 0.5
) -> float:
    """AP for one image+class. pred rows [score, x, y, w, h] (score-sorted
    or not), gt rows [x, y, w, h]. 11-point-free (continuous) AP."""
    if len(gt) == 0:
        return 1.0 if len(pred) == 0 else 0.0
    if len(pred) == 0:
        return 0.0
    order = np.argsort(-pred[:, 0])
    pred = pred[order]
    iou = _box_iou(pred[:, 1:5], gt)
    matched = np.zeros(len(gt), bool)
    tp = np.zeros(len(pred))
    for i in range(len(pred)):
        j = int(np.argmax(iou[i]))
        if iou[i, j] >= iou_threshold and not matched[j]:
            matched[j] = True
            tp[i] = 1
    cum_tp = np.cumsum(tp)
    recall = cum_tp / len(gt)
    precision = cum_tp / (np.arange(len(pred)) + 1)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def mean_average_precision(
    detections: Sequence[np.ndarray],
    ground_truths: Sequence[np.ndarray],
    num_classes: int,
    iou_threshold: float = 0.5,
) -> float:
    """mAP over images; detections rows [class, score, x, y, w, h]
    (the YOLO op's output format), gt rows [class, x, y, w, h]."""
    aps: List[float] = []
    for c in range(num_classes):
        for det, gt in zip(detections, ground_truths):
            det_c = det[det[:, 0] == c][:, 1:6] if len(det) else np.zeros((0, 5))
            gt_c = gt[gt[:, 0] == c][:, 1:5] if len(gt) else np.zeros((0, 4))
            if len(gt_c) == 0 and len(det_c) == 0:
                continue
            aps.append(average_precision(det_c, gt_c, iou_threshold))
    return float(np.mean(aps)) if aps else 0.0


def match_detections(dets: np.ndarray, ref: np.ndarray) -> dict:
    """How far one detector output is from another, in the YOLO op's rows
    [class, score, x, y, w, h] with score 0 for empty rows: each kept row of
    `ref` (score > 0), by descending score, takes the unmatched kept row of
    its class in `dets` that overlaps it most. Returns the kept counts, the
    rows left unmatched on either side and the highest score among them,
    the least IoU of a match and the largest score difference of one; and
    under "lost", each unmatched row's (score, IoU with the row of its class
    that overlaps it most among the higher-scored rows of its own output).
    Unlike a row-by-row difference it does not depend on the order of
    near-equal scores."""
    dets, ref = (np.asarray(d, np.float32) for d in (dets, ref))
    a, b = dets[dets[:, 1] > 0], ref[ref[:, 1] > 0]
    b = b[np.argsort(-b[:, 1], kind="stable")]
    used = np.zeros(len(a), bool)
    lost, min_iou, max_dscore = [], 1.0, 0.0
    iou = _box_iou(b[:, 2:6], a[:, 2:6]) if len(a) and len(b) else np.zeros((len(b), len(a)))

    def overlap_above(rows, k):
        higher = rows[(rows[:, 0] == rows[k, 0]) & (rows[:, 1] > rows[k, 1])]
        return float(_box_iou(rows[k:k + 1, 2:6], higher[:, 2:6]).max()) if len(higher) else 0.0

    for i in range(len(b)):
        cand = np.where((a[:, 0] == b[i, 0]) & ~used)[0]
        if not len(cand):
            lost.append((float(b[i, 1]), overlap_above(b, i)))
            continue
        j = cand[np.argmax(iou[i, cand])]
        used[j] = True
        min_iou = min(min_iou, float(iou[i, j]))
        max_dscore = max(max_dscore, float(abs(a[j, 1] - b[i, 1])))
    lost += [(float(a[j, 1]), overlap_above(a, j)) for j in np.where(~used)[0]]
    return {"kept": len(a), "kept_ref": len(b), "unmatched": len(lost),
            "max_unmatched_score": max((s for s, _ in lost), default=0.0), "min_iou": min_iou,
            "max_score_diff": max_dscore, "lost": lost}


def detections_agree(dets, ref, tol: float, score_threshold: float = 0.35,
                     nms_iou: float = None) -> dict:
    """`match_detections` of each image of a batch, held to a precision's
    tolerance `tol`: matched rows within `tol` in score and at IoU >= 1 -
    tol; a row without a match only where its score is within `tol` of the
    cutoff (such a row may fall either side of it) or, given the NMS
    threshold `nms_iou`, where its overlap with a higher-scored row of its
    class is within `tol` of that threshold (one rounding may keep or
    suppress it). Returns the worst figures over the batch; raises
    AssertionError where they fail."""
    ms = [match_detections(d, r) for d, r in zip(np.asarray(dets), np.asarray(ref))]
    lost = [x for m in ms for x in m["lost"]]
    worst = {"kept": sum(m["kept"] for m in ms), "kept_ref": sum(m["kept_ref"] for m in ms),
             "unmatched": sum(m["unmatched"] for m in ms),
             "max_unmatched_score": max(m["max_unmatched_score"] for m in ms),
             "min_iou": min(m["min_iou"] for m in ms),
             "max_score_diff": max(m["max_score_diff"] for m in ms),
             "nms_ties": sum(1 for s, o in lost if s > score_threshold + tol)}
    allowed = all(s <= score_threshold + tol
                  or (nms_iou is not None and abs(o - nms_iou) <= tol) for s, o in lost)
    if not (worst["max_score_diff"] <= tol and worst["min_iou"] >= 1.0 - tol and allowed):
        raise AssertionError(f"detections disagree beyond tol {tol}: {worst}")
    return worst


def precision_delta_report(engine_fp32, engine_low, inputs: Dict[str, np.ndarray],
                           kind: str = "classification") -> dict:
    """Compare two precision modes on the same inputs: max-abs-diff, and
    top-1 agreement (classification) or PSNR (kind="sr")."""
    x = next(iter(inputs.values()))
    a = _np(engine_fp32.run_single(x))
    b = _np(engine_low.run_single(x))
    rep = {"max_abs_diff": float(np.max(np.abs(a - b)))}
    if kind == "classification":
        rep["top1_agreement"] = agreement_rate(a, b)
    elif kind == "sr":
        rep["psnr_db"] = psnr(a, b)
    return rep
