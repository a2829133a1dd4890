"""The check's row-to-row comparison of detections (`harness/detections.py`)
and the reference's decode and NMS run on the program's own heads: what
the order of tied rows and float32's rounding do passes, a fault fails."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import check, detections, spec
from benchmark.reference import plain
from conftest import ROOT, yolo_config


def rows(*r, n=8):
    out = np.zeros((n, 6))
    out[:len(r)] = r
    return out


def numbers(dets, want):
    return detections.compare(np.asarray([dets]), np.asarray([want]))


A = [1, 0.90, 0.10, 0.10, 0.20, 0.20]
B = [1, 0.66, 0.50, 0.50, 0.15, 0.15]
C = [0, 0.61, 0.43, 0.50, 0.16, 0.15]
D = [1, 0.66, 0.70, 0.20, 0.10, 0.10]  # B's score, another box


def moved(r, dx=0.0, score=None, cls=None):
    return [r[0] if cls is None else cls, r[1] if score is None else score, r[2] + dx, *r[3:]]


def test_the_same_rows_in_another_order_pass():
    n = numbers(rows(C, A, B), rows(A, B, C))
    assert n == {"det_score_err": 0.0, "det_box_err": 0.0, "det_unmatched": 0, "det_rows": 3}


def test_rows_whose_scores_tie_pair_whatever_their_order():
    n = numbers(rows(A, D, B), rows(A, B, D))
    assert n["det_unmatched"] == 0 and n["det_box_err"] == 0.0


def test_rounding_sized_errors_read_as_rounding():
    n = numbers(rows(moved(A, dx=1e-7, score=0.9000001), B, C), rows(A, B, C))
    assert n["det_unmatched"] == 0
    assert 0 < n["det_score_err"] < 1e-6 and 0 < n["det_box_err"] < 1e-5


def test_a_missing_row_or_one_too_many_is_unmatched():
    assert numbers(rows(A, C), rows(A, B, C))["det_unmatched"] == 1
    assert numbers(rows(A, B, C, D), rows(A, B, C))["det_unmatched"] == 1


def test_a_row_under_another_class_is_unmatched_on_both_sides():
    n = numbers(rows(moved(A, cls=2), B, C), rows(A, B, C))
    assert n["det_unmatched"] == 2


def test_a_score_or_a_box_off_reads_its_error():
    n = numbers(rows(moved(A, score=0.80), B, C), rows(A, B, C))
    assert n["det_score_err"] == pytest.approx(0.10) and n["det_unmatched"] == 0
    n = numbers(rows(moved(A, dx=0.05), B, C), rows(A, B, C))
    assert n["det_box_err"] == pytest.approx(1 - 0.15 / 0.25) and n["det_unmatched"] == 0


def test_rows_altered_where_they_are_made_are_unmatched():
    bad = rows(A, B, C)
    bad[:2, 0] += 0.25  # a class that is no class
    assert numbers(bad, rows(A, B, C))["det_unmatched"] == 4
    assert numbers(rows(A, A, B, C), rows(A, B, C))["det_unmatched"] == 1  # one box twice
    assert numbers(np.zeros((8, 6)), rows(A, B, C))["det_unmatched"] == 3  # none at all
    assert numbers(np.zeros((8, 6)), np.zeros((8, 6)))["det_unmatched"] == 0


# Heads with three boxes on a background that no threshold keeps. At the
# coarse grid's cell (3, 3), two boxes of class 1 with one centre: 100 and
# 146.6 pixels square at a net of 256, so they overlap by (100 / 146.6)^2 =
# 0.465, and NMS at 0.45 drops the second (score 0.907) under the first
# (0.986). At the fine grid's cell (12, 12) a box of class 0 that scores
# 0.365, just above a cutoff of 0.35.
def heads(config):
    anchors, masks, side = config["anchors"], config["masks"], config["net_hw"][0]
    h1 = torch.full((1, side // 32, side // 32, 24), -10.0)
    h2 = torch.full((1, side // 16, side // 16, 24), -10.0)

    def box(h, r, c, a, anchor, px, logit, cls):
        v = h[0, r, c, 8 * a:8 * a + 8]
        v[0:2] = 0.0
        v[2] = math.log(px / anchor[0])
        v[3] = math.log(px / anchor[1])
        v[4] = v[5 + cls] = logit

    box(h1, 3, 3, 0, anchors[masks[0][0]], 100.0, 5.0, 1)
    box(h1, 3, 3, 1, anchors[masks[0][1]], 100.0 / math.sqrt(0.4653), 3.0, 1)
    box(h2, 12, 12, 0, anchors[masks[1][0]], 20.0, 0.4231, 0)
    return h1, h2


def yolo_rows(config, **change):
    """The reference's YOLO layer on the heads above, with ``change`` made to
    the layer: what a program that decodes and suppresses so would return."""
    config = dict(config, **change)
    return plain.layer_forward(spec.model(config), "yolo", heads(yolo_config()))


@pytest.mark.parametrize("change", [{"score_threshold": 0.38}, {"nms_iou": 0.48},
                                    {"net_hw": [416, 416]}, {}])
def test_a_program_that_decides_otherwise_on_the_same_heads_fails(change):
    config = yolo_config()
    want = yolo_rows(config)
    assert (want[0, :, 1] > 0).sum().item() == 2  # the first box of each cell
    n = detections.compare(yolo_rows(config, **change).numpy(), want.numpy())
    if not change:
        assert n["det_unmatched"] == n["det_score_err"] == n["det_box_err"] == 0
    elif "net_hw" in change:  # every box 256 / 416 the size: the same decisions
        assert n["det_unmatched"] == 0
        assert n["det_box_err"] == pytest.approx(1 - (256 / 416) ** 2, rel=1e-5)
    else:
        assert n["det_unmatched"] == 1


def test_detections_are_compared_on_the_programs_own_inputs():
    """The check runs the reference's layer on the program's returned heads:
    its detections against those of the heads it returned, not against the
    reference's heads; inputs it does not return are an error."""
    config = yolo_config((64, 64))
    model = spec.model(config)
    ref = check.reference_model(ROOT, config, model, torch.device("cpu"))
    raw = torch.zeros(1, 64, 64, 3, dtype=torch.uint8)
    h1, h2 = torch.ones(1, 2, 2, 24), torch.ones(1, 4, 4, 24)
    out = {"head1": h1, "head2": h2,
           "yolo": plain.layer_forward(model, "yolo", [h1, h2])}
    n = check.compare(ref, [(raw, out)], torch.device("cpu"), config, model)
    assert n["det_unmatched"] == 0 and n["rel_rms_err"] > 0.5  # not the reference's heads
    bad = dict(config, outputs=[o for o in config["outputs"] if o["name"] != "head2"])
    with pytest.raises(ValueError, match="not all dense outputs"):
        check.compare(ref, [(raw, out)], torch.device("cpu"), bad, model)
