"""The cell `yolov3-tiny-416-b8`: darknet's YOLOv3-tiny at its published
widths (80 classes, 416x416) on the seeded artifact, and the two readers of
its NMS kernel. On the CPU at a small frame, with the program's plain
versions: the cell's files load, a run is correct and its traced line
leaves the kernel's metrics out (no kernel event on the CPU); the readers
on records that hold the kernel's events."""

import copy
import math
import types

import pytest

from benchmark.harness import spec
from conftest import run_tiny

CELL = "yolov3-tiny-416-b8"


def small_cell(hw=(64, 96)):
    cell = spec.load_cell(CELL)
    cell.config = dict(copy.deepcopy(cell.config), input=dict(cell.config["input"], height=hw[0],
                                                              width=hw[1]), net_hw=list(hw))
    cell.traffic = dict(cell.traffic, batch=2, pool_batches=2, warm_steps=1, profile_steps=2,
                        probe_steps=2)
    return cell


def test_the_cell_reads_its_files():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.traffic["loop"] == "closed" and cell.traffic["batch"] == 8
    c = cell.config
    assert c["classes"] == 80 and c["net_hw"] == [416, 416] and c["reduced"] == []
    assert (c["input"]["height"], c["input"]["width"]) == (416, 416)
    assert [m["name"] for m in cell.end_to_end] == ["frames_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names[-2:] == ["kernels.nms_ms", "kernels_roofline.nms"]
    assert {"engine.dispatch_ms.offline", "step_mfu.offline", "ops.library_ms",
            "kernels.hand_written_ms", "kernels_roofline.offline",
            "device.idle_share.offline"} <= set(names)
    assert cell.limits["det_unmatched"] == 0


@pytest.mark.parametrize("trace", [False, True])
def test_a_small_run_is_correct(trace):
    r = run_tiny(small_cell(), seed=3190000037, seconds=0.3, trace=trace)
    assert r["correct"], r["check"]
    assert r["_numbers"]["det_rows"] > 0 and r["_numbers"]["det_unmatched"] == 0
    if trace:  # no NMS kernel runs on the CPU: its metrics are left out
        assert "ops.library_ms" in r["metrics"]
        assert not {"kernels.nms_ms", "kernels_roofline.nms"} & set(r["metrics"])


def record(rows, steps=30, batch=8, max_det=100):
    trace = {"rows": rows, "steps": steps} if rows is not None else None
    return types.SimpleNamespace(trace=trace, batch=batch, config={"max_detections": max_det})


KERNEL = ("void (anonymous namespace)::yolo_nms_kernel(float const*, long const*, float const*, "
          "long const*, float*, int, int, float)")


def test_the_nms_readers():
    nms_ms, roofline = spec.reader("kernels.nms_ms"), spec.reader("kernels_roofline.nms")
    rows = {KERNEL: {"category": "library", "us": 300.0, "count": 30},
            "void at::native::sort_kernel(...)": {"category": "library", "us": 900.0,
                                                 "count": 30}}
    assert nms_ms(record(rows)) == pytest.approx(0.01)
    # 8 x 100 rows x 60 bytes at 3.35 TB/s outweigh 8 x (300 + 11 x 4,950) ops at 67 TFLOP/s
    least = max(8 * 100 * 60 / 3.35e12, 8 * (300 + 11 * 4950) / 67e12)
    assert roofline(record(rows)) == pytest.approx(100 * least / 10e-6)
    assert math.isclose(least, 48000 / 3.35e12)
    for rec in (record(None), record({}), record({"other_kernel": rows[KERNEL]}),
                record(rows, steps=0)):
        assert nms_ms(rec) is None and roofline(rec) is None
