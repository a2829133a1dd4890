"""Detections compared row to row: a detector's kept rows [class, score, x,
y, w, h] (x, y the top-left corner, normalized; score 0: no row), the
program's against the reference's.

The reference's rows are its decode and NMS run on the program's own
inputs to them (`check.compare_outputs`), so both sides take every
decision from the same numbers: the same boxes are kept, under the same
class. Rows are paired in the reference's score order, each with the
unpaired program row of its class that overlaps it most, so that the order
of two rows whose scores tie does not matter. The IoU is the program's
`utils/metrics.py` `_box_iou`, copied so that the check does not import
the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU matrix of [x, y, w, h] boxes."""
    ax1, ay1 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.clip(np.minimum(ax1[:, None], bx1[None, :])
                 - np.maximum(a[:, 0][:, None], b[:, 0][None, :]), 0, None)
    ih = np.clip(np.minimum(ay1[:, None], by1[None, :])
                 - np.maximum(a[:, 1][:, None], b[:, 1][None, :]), 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def match(dets: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """One image: the program's rows against the reference's.

    - ``score_err``: the largest |score difference| of a pair;
    - ``box_err``: 1 - the least IoU of a pair;
    - ``unmatched``: rows of either side left without a pair (a reference
      row pairs only with a program row of its class that overlaps it).
    """
    p = np.asarray(dets, np.float64)
    p = p[p[:, 1] > 0, :6]
    r = np.asarray(want, np.float64)
    r = r[r[:, 1] > 0, :6]
    iou = box_iou(r[:, 2:6], p[:, 2:6]) if len(r) and len(p) else np.zeros((len(r), len(p)))
    iou = np.where(r[:, :1] == p[:, 0][None, :], iou, 0.0)
    free = np.ones(len(p), bool)
    out = {"score_err": 0.0, "box_err": 0.0, "unmatched": 0}
    for i in np.argsort(-r[:, 1], kind="stable"):
        o = np.where(free, iou[i], 0.0)
        j = int(np.argmax(o)) if len(p) else 0
        if not len(p) or o[j] <= 0:
            out["unmatched"] += 1
            continue
        free[j] = False
        out["score_err"] = max(out["score_err"], abs(float(p[j, 1] - r[i, 1])))
        out["box_err"] = max(out["box_err"], 1.0 - float(o[j]))
    out["unmatched"] += int(free.sum())
    return out


def compare(dets, want) -> Dict[str, float]:
    """`match` over a batch (N images of rows on each side), as the check's
    numbers: ``det_score_err`` and ``det_box_err`` the worst of an image,
    ``det_unmatched`` the sum; also ``det_rows``, the reference's kept rows."""
    numbers = {"det_score_err": 0.0, "det_box_err": 0.0, "det_unmatched": 0, "det_rows": 0}
    for d, r in zip(np.asarray(dets), np.asarray(want)):
        m = match(d, r)
        numbers["det_score_err"] = max(numbers["det_score_err"], m["score_err"])
        numbers["det_box_err"] = max(numbers["det_box_err"], m["box_err"])
        numbers["det_unmatched"] += m["unmatched"]
        numbers["det_rows"] += int((r[:, 1] > 0).sum())
    return numbers
