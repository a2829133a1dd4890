"""The cost model: operations from the layer equations, bytes of inputs,
outputs and parameters only."""

import pytest

from benchmark.harness import cost, spec
from conftest import yolo_config


def cfg(name):
    cell = spec.load_cell(name)
    return cell.config, spec.model(cell.config)


def test_espcn_ops_per_input_pixel():
    config, model = cfg("espcn-540p-b8")
    f = cost.frame_cost(model, 540, 960, 1)
    # 2 * (25*1*16 + 9*16*16 + 9*16*4) = 6,560 per input pixel
    assert f["ops"] == 6560 * 540 * 960
    assert f["out_values"] == 1080 * 1920
    assert f["params"] == (25 * 16 + 16) + (9 * 16 * 16 + 16) + (9 * 16 * 4 + 4)


def test_styletransfer_ops_are_the_conv_sum():
    config, model = cfg("styletransfer-candy-512-b4")
    s = 512
    convs = [  # (kh*kw, cin, cout, pixels counted)
        (81, 3, 32, s * s),  # stem, per output pixel
        (9, 32, 64, (s // 2) ** 2), (9, 64, 128, (s // 4) ** 2),  # stride-2 convs
        *[(9, 128, 128, (s // 4) ** 2)] * 10,  # five residual blocks of two
        (9, 128, 64, (s // 4) ** 2), (9, 64, 32, (s // 2) ** 2),  # transposed: per input pixel
        (81, 32, 3, s * s),  # head
    ]
    want = sum(2 * k * ci * co * px for k, ci, co, px in convs)
    f = cost.frame_cost(model, s, s, 3)
    assert f["ops"] == want
    assert 4 * f["ops"] == pytest.approx(264.5e9, rel=1e-3)
    assert f["out_values"] == s * s * 3


def test_bytes_are_inputs_outputs_and_parameters_only():
    config, model = cfg("espcn-540p-b8")
    c = cost.step_cost(model, config, 8)
    params = cost.frame_cost(model, 540, 960, 1)["params"]
    assert c["bytes"] == 8 * 540 * 960 + 8 * 1080 * 1920 * 4 + 2 * params
    assert c["ops"] == 8 * 6560 * 540 * 960


def test_least_time_and_peaks():
    config, model = cfg("espcn-540p-b8")
    c = cost.step_cost(model, config, 8)
    _, peaks = cost.peaks_for("NVIDIA H100 80GB HBM3")
    t, bound = cost.least_time_s(c, "bf16", peaks)
    assert bound == "ops" and t == pytest.approx(c["ops"] / 989e12)
    # an f32 path is held to the TF32 tensor rate, int8 to the int8 rate
    assert cost.peak_ops("fp32", peaks) == 495e12
    assert cost.peak_ops("int8", peaks) == 1979e12
    assert cost.peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"


def test_groups_divide_a_conv_and_every_op_sets_the_shape():
    from benchmark.reference import plain

    layers = [{"name": "dw", "op": "conv", "k": 3, "cin": 32, "cout": 32, "stride": 2,
               "groups": 32},
              {"name": "pw", "op": "conv", "k": 1, "cin": 32, "cout": 64, "stride": 1},
              {"name": "up", "op": "conv_transpose", "k": 3, "cin": 64, "cout": 8, "stride": 2},
              {"name": "d2s", "op": "depth_to_space", "scale": 2}]
    f = cost.frame_cost(plain.Model(layers, plain.OPS, plain.ACTS), 16, 16, 32)
    assert f["ops"] == (2 * 9 * 1 * 32 * 8 * 8  # depthwise: one input channel per output
                        + 2 * 1 * 32 * 64 * 8 * 8 + 2 * 9 * 64 * 8 * 8 * 8)
    assert f["params"] == (9 * 32 + 32) + (32 * 64 + 64) + (9 * 64 * 8 + 8)
    assert f["out_values"] == 32 * 32 * 2


@pytest.mark.parametrize("where", ["cost", "weights", "forward"])
def test_an_op_that_no_table_holds_is_an_error(where, tmp_path):
    import numpy as np
    import torch

    from benchmark.reference import plain

    layers = [{"name": "c", "op": "conv", "k": 1, "cin": 1, "cout": 1, "stride": 1},
              {"name": "p", "op": "max_pool", "k": 2}]
    m = plain.Model(layers, plain.OPS, plain.ACTS)
    path = tmp_path / "w.bin"
    np.zeros(2, "<f4").tofile(path)
    with pytest.raises(ValueError, match="unknown op 'max_pool'"):
        if where == "cost":
            cost.frame_cost(m, 4, 4, 1)
        elif where == "weights":
            plain.read_weights(m, str(path))
        else:
            plain.forward(m, {"c": {"w": torch.ones(1, 1, 1, 1), "b": torch.zeros(1)}},
                          torch.ones(1, 4, 4, 1))


@pytest.mark.parametrize("cell,frame,step", [
    ("espcn-540p-b8", {"ops": 3400704000, "params": 3316, "out_values": 2073600},
     {"ops": 27205632000, "bytes": 70509032}),
    ("styletransfer-candy-512-b4", {"ops": 66135785472, "params": 1679235, "out_values": 786432},
     {"ops": 264543141888, "bytes": 19087110})])
def test_the_cost_of_a_chain_is_as_it_was(cell, frame, step):
    """The numbers the cost model gave before layers could branch."""
    c = spec.load_cell(cell)
    config, model = c.config, spec.model(c.config)
    inp = config["input"]
    assert cost.frame_cost(model, inp["height"], inp["width"], inp["channels"]) == frame
    assert cost.step_cost(model, config, int(c.traffic["batch"])) == step


def test_yolo_ops_are_the_conv_sum_of_both_branches():
    config = yolo_config((416, 416))
    model = spec.model(config)
    convs = [  # (k*k, cin, cout, output side)
        (9, 3, 16, 416), (9, 16, 32, 208), (9, 32, 64, 104), (9, 64, 128, 52),
        (9, 128, 256, 26), (9, 256, 512, 13), (9, 512, 1024, 13),  # the stride-1 pool keeps 13
        (1, 1024, 256, 13), (9, 256, 512, 13), (1, 256, 128, 13), (1, 512, 24, 13),
        (9, 128 + 256, 256, 26), (1, 256, 24, 26)]  # after the upsample and the concat
    f = cost.frame_cost(model, 416, 416, 3)
    assert f["ops"] == sum(2 * k * ci * co * s * s for k, ci, co, s in convs)
    assert f["ops"] == pytest.approx(5.445e9, rel=1e-3)
    assert f["params"] == sum(k * ci * co + co for k, ci, co, _ in convs) == 8671312
    # the compared outputs: both heads and the detector's 100 rows of 6
    assert f["out_values"] == 13 * 13 * 24 + 26 * 26 * 24 + 100 * 6
    c = cost.step_cost(model, config, 8)
    assert c["bytes"] == 8 * 416 * 416 * 3 + 8 * f["out_values"] * 4 + 2 * f["params"]
