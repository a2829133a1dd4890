"""The ops, builder methods, data and metrics that the rest of the model zoo
brings into the port (shadernn_tpu_torch.ops, graph.builder, tools,
utils.metrics), each against the JAX package's on the same numpy inputs:
Concatenate, Unary, Calculate, UpSampling2D, InstanceNormalization,
Conv2DTranspose and the YOLO head."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from shadernn_tpu.graph.builder import GraphBuilder as JBuilder
from shadernn_tpu.graph.ir import Node as JNode
from shadernn_tpu.ops import get_op as jget_op
from shadernn_tpu.ops.registry import RunCtx as JCtx
from shadernn_tpu.ops.yolo import decode_grid as jdecode
from shadernn_tpu.ops.yolo import encode_grid as jencode

from shadernn_tpu_torch.graph.builder import GraphBuilder as PBuilder
from shadernn_tpu_torch.graph.ir import Node as PNode, TensorSpec as PSpec
from shadernn_tpu_torch.ops import get_op as pget_op
from shadernn_tpu_torch.ops.registry import RunCtx as PCtx
from shadernn_tpu_torch.ops.yolo import (
    YOLOV3_TINY_ANCHORS, YOLOV3_TINY_MASKS, decode_grid, encode_grid, nms_fixed,
)

TOL = {"fp32": 0.01, "bf16": 0.1}  # tests/conftest.py thresholds
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def run_both(op, attrs, arrays, prec="fp32", params=None):
    """(port output, JAX output) as float32 numpy arrays of one op on the
    same inputs, cast to the precision's activation dtype."""
    jdt, pdt = DTYPES[prec]
    params = params or {}
    jnode = JNode("n", op, [f"x{i}" for i in range(len(arrays))], dict(attrs),
                  {k: np.array(v) for k, v in params.items()})
    pnode = PNode("n", op, [f"x{i}" for i in range(len(arrays))], dict(attrs),
                  {k: np.array(v) for k, v in params.items()})
    want = jget_op(op).run(jnode, [jnp.asarray(a).astype(jdt) for a in arrays], JCtx())
    got = pget_op(op).run(pnode, [torch.from_numpy(a).to(pdt) for a in arrays], PCtx())
    # Shape inference agrees with the computed shape.
    spec = pget_op(op).infer(pnode, [PSpec(a.shape) for a in arrays])
    assert tuple(spec.shape) == tuple(got.shape)
    assert got.dtype == pdt if op != "YOLO" else got.dtype == torch.float32
    return got.float().numpy(), np.asarray(want, np.float32)


def close(got, want, prec):
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL[prec] * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_concatenate(rng, prec):
    xs = [rng.standard_normal((2, 5, 7, c)).astype(np.float32) for c in (3, 1, 8)]
    got, want = run_both("Concatenate", {}, xs, prec)
    assert got.shape == (2, 5, 7, 12)
    np.testing.assert_array_equal(got, want)


UNARY = ["abs", "neg", "sqrt", "rsqrt", "square", "exp", "log", "sin", "cos", "floor", "ceil",
         "reciprocal", "mul", "scale", "add", "shift", "pow", "clip"]


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("op_type", UNARY)
def test_unary(rng, op_type, prec):
    positive = op_type in ("sqrt", "rsqrt", "log", "reciprocal", "pow")
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32) * 2
    x = np.abs(x) + 0.1 if positive else x
    attrs = {"op_type": op_type, "op_value": 1.7}
    if op_type == "clip":
        attrs["clip_range"] = (-0.5, 0.8)
    got, want = run_both("Unary", attrs, [x], prec)
    close(got, want, prec)
    if prec == "fp32" and op_type not in ("pow", "exp", "log", "sin", "cos"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unary_unknown_op_type(rng):
    node = PNode("n", "Unary", ["x"], {"op_type": "erf"})
    with pytest.raises(ValueError, match="erf"):
        pget_op("Unary").run(node, [torch.zeros(1, 2, 2, 1)], PCtx())


@pytest.mark.parametrize("expr", ["merge_y_uv", "add", "mul"])
def test_calculate(rng, expr):
    y = rng.random((2, 6, 8, 1 if expr == "merge_y_uv" else 4)).astype(np.float32)
    src = rng.random((2, 6, 8, 4)).astype(np.float32)
    for prec in ("fp32", "bf16"):
        got, want = run_both("Calculate", {"expr": expr}, [y, src], prec)
        assert got.shape == (2, 6, 8, 4)
        close(got, want, prec)
        if expr == "merge_y_uv":
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("scale,hw", [(2, (5, 7)), (2, (6, 4)), (3, (5, 6)), (4, (3, 5))],
                         ids=["x2_odd", "x2_even", "x3", "x4"])
def test_upsampling2d(rng, interp, scale, hw):
    """jax.image.resize's bilinear (half-pixel centres) at odd and even
    sizes; the borders included."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    attrs = {"scale": scale, "interpolation": interp}
    got, want = run_both("UpSampling2D", attrs, [x])
    assert got.shape == (2, hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()
    got, want = run_both("UpSampling2D", attrs, [x], "bf16")
    close(got, want, "bf16")


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["relu", "linear"])
def test_instance_normalization(rng, prec, activation):
    x = (3 * rng.standard_normal((2, 9, 7, 5)) + 1).astype(np.float32)
    params = {"gamma": (1 + 0.3 * rng.standard_normal(5)).astype(np.float32),
              "beta": (0.2 * rng.standard_normal(5)).astype(np.float32)}
    attrs = {"epsilon": 1e-5, "activation": activation}
    got, want = run_both("InstanceNormalization", attrs, [x], prec, params)
    close(got, want, prec)
    if prec == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if activation == "relu":
        assert got.min() == 0.0


def deconv_params(rng, k, c, o, int8=False):
    w = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(np.float32)
    params = {"bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}
    if int8:
        scale = (np.abs(w).max(axis=(0, 1, 2)) / 127).astype(np.float32)
        params.update(weight_q=np.clip(np.round(w / scale), -127, 127).astype(np.int8),
                      weight_scale=scale)
    else:
        params["weight"] = w
    return params


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_conv2d_transpose(rng, k, stride, padding):
    """lax.conv_transpose's SAME (its own asymmetric split) and VALID on
    the flipped kernel, at odd and even sizes."""
    attrs = {"kernel_size": k, "stride": stride, "padding": padding, "out_channels": 4,
             "activation": "relu", "use_bias": True}
    for hw in ((5, 6), (7, 4)):
        x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        params = deconv_params(rng, k, 3, 4)
        got, want = run_both("Conv2DTranspose", attrs, [x], "fp32", params)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if padding == "same":
            assert got.shape[1:3] == (stride * hw[0], stride * hw[1])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8_weights"])
def test_conv2d_transpose_bf16(rng, int8):
    """bf16 operands, float32 sums rounded once; int8 weights dequantized
    as get_weight does (both factors in the compute dtype)."""
    attrs = {"kernel_size": 3, "stride": 2, "padding": "same", "out_channels": 6,
             "activation": "linear", "use_bias": True}
    x = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    params = deconv_params(rng, 3, 8, 6, int8)
    for prec in ("fp32", "bf16"):
        got, want = run_both("Conv2DTranspose", attrs, [x], prec, params)
        close(got, want, prec)


def test_conv2d_transpose_kernel_flip_matters(rng):
    """The check above catches a kernel left unflipped."""
    attrs = {"kernel_size": 2, "stride": 2, "padding": "same", "out_channels": 4}
    x = rng.standard_normal((1, 4, 4, 3)).astype(np.float32)
    params = deconv_params(rng, 2, 3, 4)
    _, want = run_both("Conv2DTranspose", attrs, [x], "fp32", params)
    flipped = dict(params, weight=np.ascontiguousarray(params["weight"][::-1, ::-1]))
    got, _ = run_both("Conv2DTranspose", attrs, [x], "fp32", flipped)
    assert np.max(np.abs(got - want)) > 0.1


# --- YOLO ------------------------------------------------------------------

NET = (256, 256)


def yolo_attrs(max_det=100, num_classes=3):
    return {"num_classes": num_classes, "net_hw": NET, "max_detections": max_det,
            "anchors": YOLOV3_TINY_ANCHORS, "masks": YOLOV3_TINY_MASKS}


def random_boxes(rng, n):
    rows = []
    for _ in range(n):
        w, h = rng.uniform(0.08, 0.3, 2)
        x, y = rng.uniform(0.02, 0.95 - w), rng.uniform(0.02, 0.95 - h)
        rows.append([int(rng.integers(0, 3)), x, y, w, h])
    return rows


def test_encode_decode_round_trip(rng):
    gts = [random_boxes(rng, 3), random_boxes(rng, 1)]
    anchors = [YOLOV3_TINY_ANCHORS[m] for m in YOLOV3_TINY_MASKS[1]]
    feat = encode_grid(gts, 16, 16, anchors, NET, 3)
    np.testing.assert_array_equal(feat, jencode(gts, 16, 16, anchors, NET, 3))
    boxes, scores, classes = decode_grid(torch.from_numpy(feat), anchors, NET, 3)
    jb, js, jc = jdecode(jnp.asarray(feat), anchors, NET, 3)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(classes.numpy(), np.asarray(jc))
    for i, rows in enumerate(gts):
        hits = scores[i].numpy() > 0.9
        assert hits.sum() == len(rows)
        got = sorted(map(tuple, np.round(boxes[i].numpy()[hits], 4)))
        want = sorted(tuple(np.round(r[1:], 4)) for r in rows)
        np.testing.assert_allclose(got, want, atol=1e-3)
        assert sorted(classes[i].numpy()[hits]) == sorted(r[0] for r in rows)


def yolo_inputs(rng, n, grids=((4, 4), (8, 8))):
    return [(rng.standard_normal((n, gh, gw, 24)) * 2).astype(np.float32) for gh, gw in grids]


@pytest.mark.parametrize("case", ["random", "planted_ties", "max_det_above_candidates",
                                  "batch4_encoded"])
def test_yolo_head_matches_jax(rng, case):
    """Detections (N, max_det, 6) equal to the JAX op's: rows in the same
    order (ties of score broken by the lower index, as lax.top_k does),
    the same suppression, the same padding."""
    max_det = 100
    if case == "random":
        xs = yolo_inputs(rng, 2)
    elif case == "planted_ties":
        # Equal logits in blocks: many candidates share a score exactly, and
        # equal boxes of one class overlap completely.
        xs = yolo_inputs(rng, 2)
        for x in xs:
            x[..., 4::8] = 3.0
            x[:, ::2, ::2, 5::8] = 5.0
            x[:, 1::2, :, :4] = x[:, :1, :, :4]
    elif case == "max_det_above_candidates":
        xs = yolo_inputs(rng, 3, grids=((2, 2), (3, 3)))  # 39 candidates
        max_det = 64
    else:
        gts = [random_boxes(rng, k) for k in (1, 2, 3, 4)]
        xs = [encode_grid(gts, g, g, [YOLOV3_TINY_ANCHORS[m] for m in mask], NET, 3)
              for g, mask in ((8, YOLOV3_TINY_MASKS[0]), (16, YOLOV3_TINY_MASKS[1]))]
    got, want = run_both("YOLO", yolo_attrs(max_det), xs)
    assert got.shape == (xs[0].shape[0], max_det, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1] > 0, want[..., 1] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if case == "max_det_above_candidates":
        assert (got[:, 39:, 1] == 0).all()
    if case == "batch4_encoded":
        assert [(g[:, 1] > 0.5).sum() for g in got] == [1, 2, 3, 4]


def test_nms_tie_order_is_stable(rng):
    """Equal scores keep their index order, and a kept row suppresses a
    later overlapping row of its class only."""
    boxes = torch.tensor([[[0.1, 0.1, 0.2, 0.2]] * 4 + [[0.6, 0.6, 0.2, 0.2]]])
    scores = torch.tensor([[0.5, 0.9, 0.9, 0.9, 0.9]])
    classes = torch.tensor([[0, 1, 0, 1, 0]])
    out = nms_fixed(boxes, scores, classes, 0.45, 0.35, 5)[0].numpy()
    # sorted: rows 1, 2, 3, 4 (0.9, by index), then 0; row 3 repeats row 1's
    # box and class, row 0 row 2's.
    np.testing.assert_array_equal(out[:, 0], [1, 0, 1, 0, 0])
    np.testing.assert_allclose(out[:, 1], [0.9, 0.9, 0.0, 0.9, 0.0])


# --- builders, data, metrics -----------------------------------------------


def zoo_ops_graph(builder_cls, seed):
    b = builder_cls("zoo_ops", seed=seed)
    x = b.input(16, 16, 3, name="input")
    y = b.conv2d(x, 8, 3, activation="relu", name="c")
    y = b.instancenorm(y, activation="relu", name="in")
    y = b.deconv(y, 6, 3, stride=2, name="up")
    z = b.upsample(x, 2, "bilinear", name="ups")
    y = b.concat([y, z], name="cat")
    y = b.unary(y, "square", name="sq")
    h1 = b.conv2d(y, 24, 1, name="h1")
    h2 = b.conv2d(b.maxpool(y, 2, 2, name="p"), 24, 1, name="h2")
    b.yolo([h2, h1], num_classes=3, net_hw=(32, 32), max_detections=20, name="det")
    return b.build()


@pytest.mark.parametrize("seed", [7767517, 5])
def test_new_builder_methods_give_jax_weights(seed):
    from test_torch_graph import assert_same_graph

    assert_same_graph(zoo_ops_graph(PBuilder, seed), zoo_ops_graph(JBuilder, seed))


def test_new_builder_graph_runs_like_jax(rng):
    import shadernn_tpu as J

    import shadernn_tpu_torch as P

    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    want = np.asarray(J.Engine.from_graph(zoo_ops_graph(JBuilder, 3), J.EngineOptions(
        batch_size=2)).run_single(x), np.float32)
    got = P.Engine.from_graph(zoo_ops_graph(PBuilder, 3), P.EngineOptions(
        batch_size=2, device="cpu")).run_single(x).numpy()
    assert got.shape == want.shape == (2, 20, 6)
    close(got, want, "fp32")


def test_data_generators_match_jax():
    from shadernn_tpu.tools import train_denoiser as jd
    from shadernn_tpu.tools import train_styletransfer as js
    from shadernn_tpu.tools import train_yolo as jy

    from shadernn_tpu_torch.tools import train_denoiser as pd
    from shadernn_tpu_torch.tools import train_styletransfer as ps
    from shadernn_tpu_torch.tools import train_yolo as py

    assert pd.NOISE == jd.NOISE and py.NUM_CLASSES == jy.NUM_CLASSES and py.HW == jy.HW
    for a, b in zip(pd.noisy_pairs(np.random.default_rng(20260820), 3, 24),
                    jd.noisy_pairs(np.random.default_rng(20260820), 3, 24)):
        np.testing.assert_array_equal(a, b)
    x = ps.synth_imgs(np.random.default_rng(424242), 3, s=32)
    np.testing.assert_array_equal(x, js.synth_imgs(np.random.default_rng(424242), 3, s=32))
    assert sorted(ps.STYLES) == sorted(js.STYLES)
    for style in ps.STYLES:
        np.testing.assert_array_equal(ps.style_target(x, style), js.style_target(x, style))
    (pi, pg), (ji, jg) = (m.synth_scenes(np.random.default_rng(7), 3, s=64) for m in (py, jy))
    np.testing.assert_array_equal(pi, ji)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)


def test_detection_metrics_match_jax(rng):
    from shadernn_tpu.utils import metrics as jm

    from shadernn_tpu_torch.utils import metrics as pm

    _, gts = __import__("shadernn_tpu_torch.tools.train_yolo", fromlist=["x"]).synth_scenes(
        np.random.default_rng(11), 6, s=32)
    dets = []
    for gt in gts:  # jittered true boxes, misses and false positives
        d = np.concatenate([gt[:, :1], rng.uniform(0.3, 1.0, (len(gt), 1)),
                            gt[:, 1:] + rng.normal(0, 0.03, gt[:, 1:].shape)], axis=1)
        fp = np.concatenate([rng.integers(0, 3, (2, 1)), rng.uniform(0, 1, (2, 5))], axis=1)
        dets.append(np.concatenate([d[: max(1, len(d) - 1)], fp]).astype(np.float32))
    a, b = dets[0][:, 2:6], gts[0][:, 1:5]
    np.testing.assert_array_equal(pm._box_iou(a, b), jm._box_iou(a, b))
    assert pm.average_precision(dets[1][:, 1:6], gts[1][:, 1:5]) == jm.average_precision(
        dets[1][:, 1:6], gts[1][:, 1:5])
    m = pm.mean_average_precision(dets, gts, 3)
    assert m == jm.mean_average_precision(dets, gts, 3) and 0.0 < m < 1.0


def test_detections_agree_holds_boxes_not_row_order(rng):
    """The detection check: rows of near-equal score may swap; a box may
    only go missing where its score is within the tolerance of the cutoff."""
    from shadernn_tpu_torch.utils.metrics import detections_agree, match_detections

    ref = np.zeros((1, 8, 6), np.float32)
    ref[0, :4] = [[0, 0.9, 0.1, 0.1, 0.2, 0.2], [1, 0.9, 0.5, 0.5, 0.2, 0.2],
                  [0, 0.6, 0.6, 0.1, 0.3, 0.2], [2, 0.38, 0.2, 0.6, 0.1, 0.1]]
    swapped = ref.copy()
    swapped[0, [0, 1]] = ref[0, [1, 0]]
    swapped[0, :3, 1] += 0.004
    m = detections_agree(swapped, ref, 0.01)
    assert m["unmatched"] == 0 and m["max_score_diff"] == pytest.approx(0.004, abs=1e-6)
    near_cutoff = ref.copy()
    near_cutoff[0, 3] = 0
    assert detections_agree(near_cutoff, ref, 0.1)["unmatched"] == 1
    with pytest.raises(AssertionError):
        detections_agree(near_cutoff, ref, 0.01)
    lost = ref.copy()
    lost[0, 2] = 0
    with pytest.raises(AssertionError):
        detections_agree(lost, ref, 0.1)
    moved = ref.copy()
    moved[0, 0, 2] += 0.05
    assert match_detections(moved[0], ref[0])["min_iou"] < 0.9
    with pytest.raises(AssertionError):
        detections_agree(moved, ref, 0.01)
