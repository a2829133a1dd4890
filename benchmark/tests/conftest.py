"""Tests of the benchmark. They run on the CPU at small sizes, with the
program's plain kernel versions; tests marked `card` need a CUDA device
and skip without one:

    python -m pytest benchmark/tests -q
"""

import copy
import logging
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# Small sizes of each cell for the CPU: the same traffic, fewer and smaller frames.
TINY = {
    "espcn-540p-b8": ((36, 64), dict(batch=2, pool_batches=3, warm_steps=2, profile_steps=3,
                                     probe_steps=3)),
    "styletransfer-candy-512-b4": ((32, 32), dict(batch=2, pool_batches=2, warm_steps=1,
                                                  profile_steps=2, probe_steps=2)),
    "espcn-540p-serve": ((36, 64), dict(batch=2, streams=40, preroll_s=0.3, profile_s=0.2,
                                        sample_frames=8)),
    "espcn-540p-b1": ((36, 64), dict(pool_batches=3, warm_steps=2, profile_steps=3,
                                     probe_steps=3)),
}


def yolo_config(hw=(256, 256), precision="bf16"):
    """YOLOv3-tiny (darknet's cfg/yolov3-tiny.cfg at its published widths) on
    the repo's trained 3-class artifact, at the size it was trained at by
    default: a branched family with a detector's outputs, for the tests. No
    cell runs it."""
    return {
        "name": "yolov3-tiny-256-" + precision, "family": "yolov3_tiny", "precision": precision,
        "artifact": "shadernn_tpu/models/artifacts/yolov3_tiny_trained_layers.json",
        "input": {"height": hw[0], "width": hw[1], "channels": 3},
        "ingest": {"means": [0.0], "norms": [1 / 255]}, "channels": 3,
        "widths": [16, 32, 64, 128, 256, 512, 1024], "bottleneck": 256, "head_widths": [512, 256],
        "route_width": 128, "route_from": 4, "activation": "leaky", "classes": 3,
        "anchors": [[10, 14], [23, 27], [37, 58], [81, 82], [135, 169], [344, 319]],
        "masks": [[3, 4, 5], [1, 2, 3]], "net_hw": [256, 256], "score_threshold": 0.35,
        "nms_iou": 0.45, "max_detections": 100,
        "outputs": [{"name": "head1", "compare": "dense"}, {"name": "head2", "compare": "dense"},
                    {"name": "yolo", "compare": "detections"}]}


def tiny_cell(name, root=ROOT, bench=None):
    from benchmark.harness import spec

    (h, w), traffic = TINY.get(name, TINY["espcn-540p-b8"])
    cell = spec.load_cell(name, bench=bench, root=root)
    cell.config = dict(copy.deepcopy(cell.config), input=dict(cell.config["input"], height=h,
                                                              width=w))
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def run_tiny(cell, seed=20261018, seconds=0.3, trace=False, **kw):
    from benchmark.harness import core

    logging.disable(logging.INFO)
    try:
        return core.run_cell(cell, seed, seconds, trace, time.monotonic(), device="cpu", **kw)
    finally:
        logging.disable(logging.NOTSET)
