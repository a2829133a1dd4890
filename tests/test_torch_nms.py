"""The YOLO head's suppression in one launch (kernels/nms.py,
csrc/yolo_nms.cu) against `ops/yolo.py` `nms_fixed`, its oracle.

On the CPU: the kernel's mask-and-sweep written out (`sweep_model`) keeps
exactly the rows `nms_fixed` keeps, over one and several 32-bit words of
the kept set, with tied scores and boxes, and with no candidate at all; the
route of `nms` (the loop off the card); a YOLO node of more than `MAX_ROWS`
detections refused when the graph is built. On the card
(tests marked `card`): the kernel's rows equal `nms_fixed`'s bit for bit on
seeded, tied and empty inputs at N 1 and 8, and one launch is counted a
call. This file imports no JAX:

    python -m pytest tests/test_torch_nms.py -q --noconftest -p no:cacheprovider
"""

import pytest
import torch

from shadernn_tpu_torch.kernels import launch_counts, nms as nms_kernel
from shadernn_tpu_torch.ops.yolo import nms, nms_fixed, suppression, top_candidates
from shadernn_tpu_torch.utils import timer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def candidates(kind: str, n: int, m: int, seed: int = 0, device="cpu"):
    """(boxes (n, m, 4), scores (n, m), classes (n, m)) of one kind:
    "seeded" boxes crowded into the frame so that many overlap, 3 classes;
    "tied" scores on a grid of 0.05 and boxes repeated, so that sort order
    and IoU ties both arise; "empty" every score below the threshold."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((n, m, 2), generator=g) * 0.6
    wh = 0.05 + torch.rand((n, m, 2), generator=g) * 0.3
    boxes = torch.cat([xy, wh], dim=-1)
    scores = torch.rand((n, m), generator=g)
    classes = torch.randint(0, 3, (n, m), generator=g)
    if kind == "tied":
        scores = (scores * 20).floor() / 20
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, : boxes[:, 1::3].shape[1]]
        classes[:, 1::3] = classes[:, 0:-1:3][:, : classes[:, 1::3].shape[1]]
    elif kind == "empty":
        scores = scores * 0.3
    return boxes.to(device), scores.to(device), classes.to(device)


@pytest.mark.parametrize("kind", ["seeded", "tied", "empty"])
@pytest.mark.parametrize("m,k", [(2535, 100), (400, 333), (1500, 1024), (60, 100)])
def test_the_kernels_sweep_keeps_the_rows_nms_fixed_keeps(kind, m, k):
    boxes, scores, classes = candidates(kind, 2, m, seed=m + k)
    want = nms_fixed(boxes, scores, classes, 0.45, 0.35, k)
    b, c, top, idx = top_candidates(boxes, scores, classes, 0.35, k)
    top_boxes = torch.gather(b, 1, idx[..., None].expand(-1, -1, 4))
    sup = suppression(top_boxes, torch.gather(c, 1, idx), 0.45)
    for i in range(2):
        kept = nms_kernel.sweep_model(sup[i].numpy(), (top[i] > 0).numpy())
        assert kept.tolist() == (want[i, :, 1] > 0).tolist()
    if kind == "empty":
        assert not (want[..., 1] > 0).any()
    else:
        assert 0 < int((want[..., 1] > 0).sum()) < int((top > 0).sum())  # some suppressed


def test_nms_takes_the_loop_off_the_card():
    boxes, scores, classes = candidates("seeded", 2, 300)
    assert torch.equal(nms(boxes, scores, classes, 0.45, 0.35, 100),
                       nms_fixed(boxes, scores, classes, 0.45, 0.35, 100))
    with pytest.raises(ValueError, match="no NMS kernel"):
        nms_kernel.suppress(boxes, classes, scores[:, :100], torch.zeros(2, 100, dtype=torch.long),
                            0.45)


@pytest.mark.parametrize("max_det,ok", [(nms_kernel.MAX_ROWS, True),
                                         (nms_kernel.MAX_ROWS + 1, False)])
def test_a_yolo_node_holds_at_most_the_kernels_rows(max_det, ok):
    from shadernn_tpu_torch.graph.builder import GraphBuilder

    b = GraphBuilder("det")
    x = b.input(32, 32, 3)
    h1 = b.conv2d(b.maxpool(x, 2, 2, name="p"), 3 * (5 + 2), 1, name="h1")
    h2 = b.conv2d(x, 3 * (5 + 2), 1, name="h2")
    if ok:
        b.yolo([h1, h2], num_classes=2, net_hw=(32, 32), max_detections=max_det)
    else:
        with pytest.raises(ValueError, match="the rows the NMS kernel's sweep holds"):
            b.yolo([h1, h2], num_classes=2, net_hw=(32, 32), max_detections=max_det)


# --- on the card -------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("kind", ["seeded", "tied", "empty"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("m,k", [(2535, 100), (400, 333), (1500, 1024), (60, 100)])
def test_the_kernel_equals_nms_fixed_bit_for_bit(card, kind, n, m, k):
    boxes, scores, classes = candidates(kind, n, m, seed=7 * m + k + n, device="cuda")
    timer.reset()
    got = nms(boxes, scores, classes, 0.45, 0.35, k)
    assert launch_counts("kernel") == {"yolo_nms_kernel": 1}
    want = nms_fixed(boxes, scores, classes, 0.45, 0.35, k)
    assert got.shape == want.shape == (n, k, 6) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.card
def test_the_kernel_sees_a_planted_threshold(card):
    """Suppression at another IoU moves the kept set: the equality above is
    not vacuous."""
    boxes, scores, classes = candidates("seeded", 8, 2535, seed=11, device="cuda")
    want = nms_fixed(boxes, scores, classes, 0.45, 0.35, 100)
    assert not torch.equal(nms(boxes, scores, classes, 0.55, 0.35, 100), want)
    assert torch.equal(nms(boxes, scores, classes, 0.45, 0.35, 100), want)
