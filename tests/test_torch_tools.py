"""The port's tools against the JAX package's: the Keras converter
(tools/convert.py convert_keras, convert_h5, the CLI), the layer dumps
(tools/dump_reader.py) and the compare tool (tools/compare.py). Dumps are
read across packages (.npy and raw .bin), and every layer of the six
models of tests/test_layer_dump_validation.py is held to the JAX package's
dump of the same layer: 0.01 at fp32 (times the growth that file allows
its deep nets) and 0.1 at bf16, times max(1, max|JAX|)."""

import os

import numpy as np
import pytest
import torch

import shadernn_tpu as J
from shadernn_tpu.engine.compile import compile_graph as j_compile
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.tools import compare as j_compare
from shadernn_tpu.tools import dump_reader as j_dump

import shadernn_tpu_torch as P
from shadernn_tpu_torch.engine.compile import compile_graph as p_compile
from shadernn_tpu_torch.models import zoo
from shadernn_tpu_torch.models.runners import run_model
from shadernn_tpu_torch.tools import compare as p_compare
from shadernn_tpu_torch.tools import dump_reader as p_dump

from test_torch_graph import assert_same_graph
from test_torch_zoo import TOL, close, options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ESPCN_H5 = os.path.join(REPO, "shadernn_tpu", "models", "artifacts", "espcn_2x_trained.h5")


# --- the Keras converter -----------------------------------------------------


def _keras():
    return pytest.importorskip("keras")


def reference_espcn(scale=2):
    """The reference's Keras ESPCN (tests/test_tools.py's)."""
    import tensorflow as tf
    from keras.layers import Activation, Conv2D, Input, Lambda
    from keras.models import Model

    inputs = Input(shape=(32, 48, 1), name="input")
    x = Conv2D(16, (5, 5), padding="same", activation="relu", name="conv_1")(inputs)
    x = Conv2D(16, (3, 3), padding="same", activation="relu", name="conv_2")(x)
    x = Conv2D(scale**2, (3, 3), padding="same", name="conv_3")(x)
    x = Lambda(lambda t: tf.nn.depth_to_space(t, scale), name="subpixel")(x)
    x = Activation("tanh")(x)
    return Model(inputs=inputs, outputs=x)


def bn_classifier(rng):
    """tests/test_tools.py's BN classifier, its BatchNorm given statistics."""
    from keras.layers import (
        Add, BatchNormalization, Conv2D, Dense, Flatten, Input, MaxPooling2D, ReLU,
    )
    from keras.models import Model

    inputs = Input(shape=(16, 16, 3), name="input")
    c1 = Conv2D(8, 3, padding="same", use_bias=False, name="c1")(inputs)
    b1 = BatchNormalization(name="b1")(c1)
    r1 = ReLU(name="r1")(b1)
    c2 = Conv2D(8, 3, padding="same", name="c2")(r1)
    a = Add(name="a")([r1, c2])
    p = MaxPooling2D(2, name="p")(a)
    f = Flatten(name="f")(p)
    out = Dense(10, activation="softmax", name="d")(f)
    km = Model(inputs=inputs, outputs=out)
    km.get_layer("b1").set_weights([
        rng.random(8).astype(np.float32) + 0.5,
        rng.standard_normal(8).astype(np.float32),
        rng.standard_normal(8).astype(np.float32) * 0.1,
        rng.random(8).astype(np.float32) + 0.5,
    ])
    return km


@pytest.mark.parametrize("which", ["espcn", "bn_classifier"])
def test_convert_keras_matches_jax_and_keras(rng, which):
    """The same graph as the JAX converter's; the port's engine at FP32
    against Keras' predict and the JAX engine."""
    _keras()
    from shadernn_tpu.tools.convert import convert_keras as j_convert_keras

    from shadernn_tpu_torch.tools.convert import convert_keras

    km = reference_espcn() if which == "espcn" else bn_classifier(rng)
    pg, jg = convert_keras(km), j_convert_keras(km)
    assert_same_graph(pg, jg)
    shape = (1, 32, 48, 1) if which == "espcn" else (2, 16, 16, 3)
    x = rng.random(shape, dtype=np.float32)
    got = P.Engine.from_graph(pg, options(P, "fp32", batch_size=shape[0], device="cpu"))
    got = got.run_single(x).numpy()
    close(got, km.predict(x, verbose=0), "fp32", "keras")
    close(got, np.asarray(j_compile(jg, J.EngineOptions(batch_size=shape[0])).run_single(x)),
          "fp32", "jax")


def test_convert_keras_trained_espcn_h5_matches_jax(rng):
    """The repo's trained ESPCN .h5 (its Lambda names the training script's
    depth_to_space function, which Keras must be given), converted by both
    packages: the same graph, the trained JSON artifact's weights, and the
    port's engine within the bf16 limit of the JAX engine's."""
    keras = _keras()
    from shadernn_tpu.tools.convert import convert_keras as j_convert_keras
    from shadernn_tpu.tools.train_espcn import _depth_to_space_2x

    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.tools.convert import convert_keras

    km = keras.models.load_model(ESPCN_H5, safe_mode=False, compile=False,
                                 custom_objects={"_depth_to_space_2x": _depth_to_space_2x})
    pg, jg = convert_keras(km, input_hw=(20, 28)), j_convert_keras(km, input_hw=(20, 28))
    assert_same_graph(pg, jg)
    art = parse_model_file(zoo.ESPCN_TRAINED)
    for n in ("conv_1", "conv_2", "conv_3"):
        np.testing.assert_array_equal(pg.nodes[n].params["weight"], art.nodes[n].params["weight"])
    x = rng.random((2, 20, 28, 1), dtype=np.float32)
    got = P.Engine.from_graph(pg, options(P, "bf16", batch_size=2, device="cpu")).run_single(x)
    want = J.Engine.from_graph(jg, options(J, "bf16", batch_size=2)).run_single(x)
    close(got.float().numpy(), np.asarray(want), "bf16", "espcn h5")


def test_convert_h5_cli(tmp_path, rng):
    """convertTool's flag surface: keras save -> the port's CLI (convert_h5)
    -> Engine.from_json; the file is the JAX CLI's, byte for byte."""
    _keras()
    from keras.layers import Conv2D, Input
    from keras.models import Model

    from shadernn_tpu.tools.convert import main as j_main

    from shadernn_tpu_torch.tools.convert import main

    inputs = Input(shape=(12, 18, 1), name="input")
    x = Conv2D(8, 3, padding="same", activation="relu", name="c1")(inputs)
    x = Conv2D(4, 3, padding="same", activation="tanh", name="c2")(x)
    km = Model(inputs=inputs, outputs=x)
    h5 = tmp_path / "m.h5"
    km.save(str(h5))
    main(["-f", str(h5), "-o", str(tmp_path / "port.json")])
    j_main(["-f", str(h5), "-o", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    x_in = rng.random((1, 12, 18, 1), dtype=np.float32)
    got = P.Engine.from_json(str(tmp_path / "port.json"), P.EngineOptions(device="cpu"))
    close(got.run_single(x_in).numpy(), km.predict(x_in, verbose=0), "fp32", "h5 cli")


# --- layer dumps and the dump reader ------------------------------------------


@pytest.mark.parametrize("raw_bin", [False, True], ids=["npy", "bin"])
def test_dumps_are_read_across_packages(tmp_path, rng, raw_bin):
    """dump_layers writes <out_dir>/<model>/<layer>.npy (or .bin with its
    .meta.json) as the JAX package does; each package's read_dump reads
    the other's files, and every layer is within the fp32 limit of the JAX
    engine's. to_png writes a viewable frame."""
    x = rng.random((1, 16, 24, 1), dtype=np.float32)
    pe = P.Engine.from_graph(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"))
    je = J.Engine.from_graph(jbuild("espcn", h=16, w=24), J.EngineOptions())
    ppaths = p_dump.dump_layers(pe, {"input": x}, str(tmp_path / "port"), raw_bin=raw_bin)
    jpaths = j_dump.dump_layers(je, {"input": x}, str(tmp_path / "jax"), raw_bin=raw_bin)
    assert sorted(ppaths) == sorted(jpaths) == ["conv_1", "conv_2", "conv_3", "subpixel"]
    ext = ".bin" if raw_bin else ".npy"
    for name, path in ppaths.items():
        assert path == str(tmp_path / "port" / pe.graph.name / f"{name}{ext}")
        assert os.path.relpath(jpaths[name], tmp_path / "jax") == os.path.relpath(
            path, tmp_path / "port")
        mine, theirs = j_dump.read_dump(path), p_dump.read_dump(jpaths[name])
        assert mine.dtype == theirs.dtype == np.float32 and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, p_dump.read_dump(path))
        close(mine, theirs, "fp32", name)
    assert p_dump.read_dump(ppaths["conv_1"]).shape == (1, 16, 24, 16)
    png = tmp_path / "c1.png"
    p_dump.to_png(p_dump.read_dump(ppaths["conv_1"]), str(png), channel=0)
    assert png.exists()
    w = p_dump.dump_weights(pe.graph, str(tmp_path / "w"))
    np.testing.assert_array_equal(np.load(w["conv_1.weight"]), pe.graph.nodes["conv_1"].params["weight"])


def test_dump_reader_cli(tmp_path, rng, capsys):
    arr = rng.random((1, 8, 8, 3), dtype=np.float32)
    np.save(tmp_path / "d.npy", arr)
    p_dump.main([str(tmp_path / "d.npy"), "-o", str(tmp_path / "d.png"), "--channel", "1"])
    assert (tmp_path / "d.png").exists() and "shape=(1, 8, 8, 3)" in capsys.readouterr().out


def test_run_model_dump_dir(tmp_path):
    """run_model(dump_dir=) writes the dumps of its seeded frame; they read
    back equal to an in-memory dump of the same frame."""
    res = run_model("resnet18", precision=P.Precision.FP32, inner_loops=1,
                    dump_dir=str(tmp_path), device="cpu")
    eng = P.Engine.from_graph(P.build_model("resnet18"), P.EngineOptions(device="cpu"))
    x = np.random.default_rng(7767517).random((1, 32, 32, 3), dtype=np.float32)
    mem = p_dump.to_host(p_dump.layer_outputs(eng, {"input": x}))
    assert sorted(res["dumps"]) == sorted(mem)
    for name, path in res["dumps"].items():
        assert path.startswith(str(tmp_path / "resnet18_cifar10"))
        np.testing.assert_array_equal(p_dump.read_dump(path), mem[name])


# --- every layer against the JAX package's dumps --------------------------------

# tests/test_layer_dump_validation.py's models and tolerance growth.
DUMP_MODELS = [
    ("espcn", {"h": 24, "w": 32}, 1),
    ("resnet18", {}, 3),
    ("mobilenetv2", {"h": 32, "w": 32, "num_classes": 10}, 3),
    ("unet", {"h": 32, "w": 32, "base_filters": 8, "depth": 2}, 2),
    ("styletransfer", {"h": 32, "w": 32, "num_res_blocks": 1}, 2),
    ("spatialdenoise", {"h": 24, "w": 32, "features": 8, "depth": 3}, 1),
]


def dumps_of(pkg, graph, x, prec, backend):
    """Every layer's output (numpy) of one dump-mode forward of the graph
    as built (no fusion pass), as tests/test_layer_dump_validation.py
    compiles it."""
    kw = dict(backend=backend, dump_outputs=True, batch_size=x.shape[0])
    if pkg is P:
        model = p_compile(graph, options(P, prec, device="cpu", **kw))
        return p_dump.to_host(model({graph.input_names[0]: torch.from_numpy(x)})["__dumps__"])
    model = j_compile(graph, options(J, prec, **kw))
    return {k: np.asarray(v, np.float32)
            for k, v in model({graph.input_names[0]: x})["__dumps__"].items()}


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("name,kw,growth", DUMP_MODELS, ids=[m[0] for m in DUMP_MODELS])
def test_every_layer_matches_the_jax_dumps(rng, name, kw, growth, prec):
    """Dumps of the port (AUTO: no chains and no blocks under dump_outputs,
    each eligible conv alone on the single-conv kernel's plain version)
    against the JAX package's dumps (XLA), layer by layer."""
    jg, pg = jbuild(name, **kw), P.build_model(name, **kw)
    jg.infer_shapes()
    x = rng.random((1, *jg.nodes[jg.input_names[0]].out_spec.shape[1:]), dtype=np.float32)
    want = dumps_of(J, jg, x, prec, J.BackendKind.XLA)
    got = dumps_of(P, pg, x, prec, P.BackendKind.AUTO)
    assert sorted(got) == sorted(want)
    for layer, arr in got.items():
        err = float(np.max(np.abs(arr - want[layer])))
        assert err <= TOL[prec] * growth * max(1.0, float(np.abs(want[layer]).max())), (layer, err)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_espcn_dumps_under_kernel_match_jax_pallas(rng, prec):
    """ESPCN's dumps with every node forced to KERNEL against the JAX
    PALLAS dumps (Pallas in interpret mode, tests/test_layer_dump_validation
    .py:48-57): the port plans each conv alone on the single-conv kernel,
    the JAX package on _haloed_kernel; a layer perturbed by 0.05 must fail
    the fp32 limit."""
    jg, pg = jbuild("espcn", h=24, w=32), P.build_model("espcn", h=24, w=32)
    x = rng.random((1, 24, 32, 1), dtype=np.float32)
    fwd = p_compile(pg, options(P, prec, backend=P.BackendKind.KERNEL, device="cpu",
                                dump_outputs=True)).forward
    assert fwd.single_conv_plan == ["conv_1", "conv_2", "conv_3"] and fwd.chain_plan == {}
    got = dumps_of(P, pg, x, prec, P.BackendKind.KERNEL)
    want = dumps_of(J, jg, x, prec, J.BackendKind.PALLAS)
    for layer, arr in got.items():
        close(arr, want[layer], prec, layer)
    bad = got["conv_2"].copy()
    bad[0, 3, 5, 7] += 0.05 + TOL[prec]
    with pytest.raises(AssertionError):
        close(bad, want["conv_2"], prec, "planted fault")


# --- the compare tool -------------------------------------------------------------


def test_compare_arrays_and_cli_match_jax(tmp_path, rng, capsys):
    a = rng.random((8, 8), dtype=np.float32)
    b = a + 0.005
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    a.astype("<f4").tofile(tmp_path / "a.bin")
    for x, y in ((a, b), (a, a), (a, np.zeros_like(a))):
        assert p_compare.compare_arrays(x, y) == j_compare.compare_arrays(x, y)
    assert p_compare.compare_arrays(a, a)["psnr_db"] == float("inf")
    for threshold, rc in (("0.01", 0), ("0.001", 1)):
        argv = [str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), "--threshold", threshold]
        assert p_compare.main(argv) == rc
        mine = capsys.readouterr().out
        assert j_compare.main(argv) == rc
        assert mine == capsys.readouterr().out
    np.testing.assert_array_equal(p_compare.load_any(str(tmp_path / "a.bin")), a.reshape(-1))
    with pytest.raises(ValueError, match="shape mismatch"):  # the JAX tool asserts
        p_compare.compare_arrays(a, a[:4])


def test_compare_reports_the_dumps_equal(tmp_path, rng):
    """Two dumps of the same frame through compare.main: PASS at a zero
    threshold."""
    eng = P.Engine.from_graph(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"))
    x = {"input": rng.random((1, 16, 24, 1), dtype=np.float32)}
    a = p_dump.dump_layers(eng, x, str(tmp_path / "a"))
    b = p_dump.dump_layers(eng, x, str(tmp_path / "b"))
    for name in a:
        assert p_compare.main([a[name], b[name], "--threshold", "0"]) == 0
    close(np.load(a["subpixel"]), eng.run_single(x["input"]).numpy(), "fp32", "subpixel")


# --- the small public functions the tools need -----------------------------------


def test_registry_and_shape_helpers_match_jax():
    from shadernn_tpu.ops.common import conv_output_hw as j_conv_output_hw
    from shadernn_tpu.ops.registry import _ALIASES as J_ALIASES
    from shadernn_tpu.ops.registry import all_ops as j_all_ops

    from shadernn_tpu_torch.ops.common import conv_output_hw
    from shadernn_tpu_torch.ops.registry import all_ops, canonical_op

    assert all_ops() == j_all_ops() and "Conv2D" in all_ops()
    for alias, name in J_ALIASES.items():
        assert canonical_op(alias) == name, alias
    assert canonical_op("Conv2D") == "Conv2D" and canonical_op("NoSuchOp") == "NoSuchOp"
    for h, w, k, stride, pads in ((16, 24, 3, 1, (1, 1, 1, 1)), (15, 9, 4, 2, (1, 2, 1, 2)),
                                  (32, 32, 9, 1, (4, 4, 4, 4)), (7, 7, 3, 2, (0, 0, 0, 0))):
        assert conv_output_hw(h, w, k, stride, pads) == j_conv_output_hw(h, w, k, stride, pads)


def test_register_model_adds_a_builder():
    from shadernn_tpu_torch.models import zoo

    @zoo.register_model("espcn-small-test")
    def build(h=8, w=8):
        return zoo.build_model("espcn", h=h, w=w)

    try:
        assert "espcn-small-test" in P.list_models()
        g = P.build_model("espcn-small-test", h=4, w=6)
        assert g.nodes["input"].attrs["height"] == 4
    finally:
        del zoo._BUILDERS["espcn-small-test"]


def test_rate_limited_logging(caplog):
    import logging

    from shadernn_tpu_torch.utils import get_logger, log_every_n_sec, log_first_n

    log = get_logger("snn_torch.test_rate_limited")
    with caplog.at_level(logging.INFO, logger=log.name):
        for i in range(5):
            log_first_n(log, 2, "first two %d", i)
            log_every_n_sec(log, 3600.0, "once an hour %d", i)
    msgs = [r.getMessage() for r in caplog.records if r.name == log.name]
    assert msgs == ["first two 0", "once an hour 0", "first two 1"]
