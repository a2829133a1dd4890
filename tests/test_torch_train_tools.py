"""The trainers' pieces against the JAX package's and their libraries', on
the CPU: the schedules against optax's and Keras's at every count of short
runs (optax and Keras compute in float32: 1e-6 relative, or 1e-9
absolute where optax's warm-up cancels, 2e-3 - 1.96e-3); one to three Adam
updates of tools/optim.py `TrainState` on given gradients against optax's
chain (clip, adam) and against Keras's Adam (its eps added to sqrt(v)),
1e-6 relative; `bilinear_up2` bit-equal to PIL; `export` of the same
parameters byte-equal to the JAX trainers' `export` (ESPCN's through the
JAX trainer's Keras model and converter; its export of the committed
artifact's weights byte-equal to the artifact); each `evaluate` equal to
the JAX one on the same parameters (PSNR within 0.01 dB: float32 sums in
another order; top-1 and mAP exact); a trainer's CLI writes only into
its `--out`.
"""

import filecmp
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shadernn_tpu.tools import train_denoiser as JD
from shadernn_tpu.tools import train_espcn as JE
from shadernn_tpu.tools import train_mobilenetv2 as JM
from shadernn_tpu.tools import train_resnet18 as JR
from shadernn_tpu.tools import train_styletransfer as JS
from shadernn_tpu.tools import train_yolo as JY

from shadernn_tpu_torch.models.zoo import ARTIFACTS, ESPCN_TRAINED
from shadernn_tpu_torch.tools import (
    optim, train_denoiser, train_espcn, train_mobilenetv2, train_resnet18, train_styletransfer,
    train_yolo,
)
from shadernn_tpu_torch.weights import params_from_numpy

RTOL = 1e-6


@pytest.mark.parametrize("peak,warmup,steps", [(2e-3, 50, 600), (1e-3, 30, 500),
                                               (1e-3, 5, 20), (1e-3, 0, 3)])
def test_warmup_cosine_matches_optax(peak, warmup, steps):
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)
    got = optim.warmup_cosine(peak, warmup, steps)
    counts = list(range(0, min(steps, 80))) + list(range(max(steps - 5, 0), steps + 3))
    if warmup:  # the first update's value
        assert got(0) == 0.0
    for c in counts:
        assert math.isclose(got(c), float(want(c)), rel_tol=RTOL, abs_tol=1e-9), c


@pytest.mark.parametrize("steps", [6000, 3000, 7])
def test_cosine_decay_matches_keras(steps):
    import keras

    want = keras.optimizers.schedules.CosineDecay(2e-3, steps)
    got = optim.cosine_decay(2e-3, steps)
    for c in list(range(0, min(steps, 40))) + [steps // 2, steps - 1, steps, steps + 5]:
        assert math.isclose(got(c), float(want(c)), rel_tol=RTOL, abs_tol=1e-9), c


def _linear_loss(grads):
    """A loss whose gradient at any parameters is `grads`."""
    def loss(p):
        return sum((p[n][k] * torch.from_numpy(grads[n][k])).sum()
                   for n in grads for k in grads[n])
    return loss


def _params(rng):
    return {"a": {"weight": rng.standard_normal((3, 4)).astype(np.float32),
                  "mean": rng.standard_normal(4).astype(np.float32)},
            "b": {"bias": rng.standard_normal(5).astype(np.float32)}}


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_train_state_matches_optax(scale):
    """Three updates of clip(1.0) + adam(warmup_cosine) with one frozen leaf
    against optax's multi_transform on the same gradients."""
    rng = np.random.default_rng(3)
    p0 = _params(rng)
    grads = [{n: {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                  for k, v in d.items()} for n, d in p0.items()} for _ in range(3)]
    sched = (1e-2, 1, 10)
    params = params_from_numpy(p0, "cpu")
    state = optim.TrainState(params, optim.warmup_cosine(*sched), clip=1.0,
                             frozen=optim.FROZEN_BN)
    labels = {n: {k: "freeze" if k == "mean" else "train" for k in d} for n, d in p0.items()}
    tx = optax.multi_transform({
        "train": optax.chain(optax.clip_by_global_norm(1.0),
                             optax.adam(optax.warmup_cosine_decay_schedule(0.0, *sched))),
        "freeze": optax.set_to_zero()}, labels)
    jp = jax.tree.map(jnp.asarray, p0)
    opt = tx.init(jp)
    for g in grads:
        state.step(lambda p, g=g: _linear_loss(g)(p))
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, updates)
        for n, d in params.items():
            for k, t in d.items():
                want = np.asarray(jp[n][k])
                # torch's clip divides by the norm + 1e-6 (a clipped step:
                # 1e-6 / norm relative)
                np.testing.assert_allclose(t.detach().numpy(), want, rtol=RTOL, atol=1e-7)
    assert np.array_equal(params["a"]["mean"].numpy(), p0["a"]["mean"])
    assert not params["a"]["mean"].requires_grad and state.count == 3


def test_keras_eps_matches_keras_adam():
    """Gradients of 1e-7, where eps 1e-7 decides the step: Keras adds it to
    sqrt(v), optax and torch to sqrt(v-hat); keras_eps=True is Keras's."""
    import keras

    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((6,)).astype(np.float32)
    grads = [(rng.standard_normal(6) * 1e-7).astype(np.float32) for _ in range(4)]
    var = keras.Variable(w0.copy())
    kopt = keras.optimizers.Adam(keras.optimizers.schedules.CosineDecay(2e-3, 10))
    params = {"x": {"weight": torch.from_numpy(w0.copy())}}
    state = optim.TrainState(params, optim.cosine_decay(2e-3, 10), eps=1e-7, keras_eps=True)
    plain = {"x": {"weight": torch.from_numpy(w0.copy())}}
    torch_eps = optim.TrainState(plain, optim.cosine_decay(2e-3, 10), eps=1e-7)
    for g in grads:
        kopt.apply_gradients([(keras.ops.convert_to_tensor(g), var)])
        for st in (state, torch_eps):
            st.step(lambda p, g=g: _linear_loss({"x": {"weight": g}})(p))
        np.testing.assert_allclose(params["x"]["weight"].detach().numpy(), np.asarray(var.numpy()),
                                   rtol=RTOL, atol=1e-8)
    # the eps placement matters at this scale: torch's own form is off
    assert np.abs(plain["x"]["weight"].detach().numpy() - np.asarray(var.numpy())).max() > 1e-5


@pytest.mark.parametrize("shape", [(4, 64, 64, 1), (2, 17, 31, 1), (1, 1, 5, 1),
                                   (3, 135, 240, 1)])
def test_bilinear_up2_matches_pil(shape):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    x.flat[:2] = (0.0, 1.0)  # the ends of the quantization
    # the JAX trainer's bilinear_up2 (train_espcn.py:65-74) is PIL's, per image
    assert np.array_equal(train_espcn.bilinear_up2(x), JE.bilinear_up2(x))


def _perturbed(params, seed=9):
    """The JAX initial parameters moved by a seeded amount, as numpy."""
    rng = np.random.default_rng(seed)
    return {n: {k: (np.asarray(v) + rng.standard_normal(np.shape(v)).astype(np.float32) * 0.01)
                .astype(np.float32) for k, v in d.items()} for n, d in params.items()}


def _same_files(a_dir, b_dir, stem):
    for suffix in ("_layers.json", "_weights.bin"):
        a, b = os.path.join(a_dir, stem + suffix), os.path.join(b_dir, stem + suffix)
        assert filecmp.cmp(a, b, shallow=False), f"{stem}{suffix} differs"


@pytest.mark.parametrize("name", ["resnet18", "mobilenetv2", "spatialdenoise", "unet",
                                  "aidenoise", "styletransfer", "yolo", "espcn"])
def test_export_matches_jax_bytes(name, tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    quiet = lambda *_: None  # noqa: E731
    if name == "resnet18":
        g, m = JR.build_trainable(4, 2)
        p = _perturbed(m.params)
        JR.export(g, p, jdir, log=quiet)
        pg, _ = train_resnet18.build_trainable(4, 2, device="cpu")
        train_resnet18.export(pg, params_from_numpy(p, "cpu"), pdir, log=quiet)
        stem = "resnet18_cls10_trained"
    elif name == "mobilenetv2":
        g, m = JM.build_trainable(0.25, 2)
        p = _perturbed(m.params)
        JM.export(g, p, jdir, log=quiet)
        pg, _ = train_mobilenetv2.build_trainable(0.25, 2, device="cpu")
        train_mobilenetv2.export(pg, params_from_numpy(p, "cpu"), pdir, log=quiet)
        stem = "mobilenetv2_cls10_trained"
    elif name in ("spatialdenoise", "unet", "aidenoise"):
        pg = train_denoiser.build_graph(name, 32)
        from shadernn_tpu.engine.compile import extract_params
        from shadernn_tpu.models import build_model

        kw = {"unet": dict(base_filters=8, depth=3), "aidenoise": dict(features=16, depth=3)}
        g = build_model(name, h=32, w=32, **kw.get(name, dict(features=16, depth=4)))
        p = _perturbed(extract_params(g))
        JD.export(g, p, jdir, model=name, log=quiet)
        train_denoiser.export(pg, params_from_numpy(p, "cpu"), pdir, model=name, log=quiet)
        stem = f"{name}_trained"
    elif name == "styletransfer":
        g, m = JS.build_trainable(2, hw=16)
        p = _perturbed(m.params)
        JS.export(g, p, jdir, hw=32, log=quiet)
        pg, _ = train_styletransfer.build_trainable(2, 16, device="cpu")
        train_styletransfer.export(pg, params_from_numpy(p, "cpu"), pdir, hw=32, log=quiet)
        stem = "styletransfer_trained"
    elif name == "yolo":
        full, _g, m = JY.build_trainable(2, hw=64)
        p = _perturbed(m.params)
        for n, d in p.items():
            full.nodes[n].params.update(d)
        JY.export(full, jdir, log=quiet)
        pfull, _pg, _pm = train_yolo.build_trainable(2, hw=64, device="cpu")
        from shadernn_tpu_torch.tools.optim import write_back

        write_back(pfull, params_from_numpy(p, "cpu"))
        train_yolo.export(pfull, pdir, log=quiet)
        stem = "yolov3_tiny_trained"
    else:
        weights = train_espcn.glorot_init(4)
        model = JE.build_keras_espcn()
        for n, d in weights.items():
            model.get_layer(n).set_weights([d["weight"], d["bias"]])
        JE.export(model, jdir, log=quiet)
        train_espcn.export(params_from_numpy(weights, "cpu"), pdir, log=quiet)
        stem = "espcn_2x_trained"
        assert not os.path.exists(os.path.join(pdir, "espcn_2x_trained.h5"))
    _same_files(jdir, pdir, stem)


def test_espcn_export_reproduces_the_artifact(tmp_path):
    """The committed ESPCN artifact's weights through the port's export:
    the artifact's bytes, names, ops, attributes and weights."""
    from shadernn_tpu_torch.graph.parser import parse_model_file

    g = parse_model_file(ESPCN_TRAINED)
    weights = {n: {k: np.asarray(v) for k, v in node.params.items()}
               for n, node in g.nodes.items() if node.params}
    train_espcn.export(params_from_numpy(weights, "cpu"), str(tmp_path), log=lambda *_: None)
    _same_files(ARTIFACTS, str(tmp_path), "espcn_2x_trained")


@pytest.mark.parametrize("name", ["resnet18", "mobilenetv2", "spatialdenoise", "unet",
                                  "styletransfer", "yolo", "espcn"])
def test_evaluate_matches_jax(name):
    """Each trainer's held-out metric on the same parameters (the JAX
    trainer's initial ones, moved by a seeded amount): the JAX trainer's
    `evaluate` and the port's."""
    if name in ("resnet18", "mobilenetv2"):
        J, P = (JR, train_resnet18) if name == "resnet18" else (JM, train_mobilenetv2)
        args = (4, 8) if name == "resnet18" else (0.25, 8)
        g, m = J.build_trainable(*args)
        p = _perturbed(m.params)
        pg, pm = P.build_trainable(*args, device="cpu")
        want = J.evaluate(g, m, jax.tree.map(jnp.asarray, p), n=16, batch=8)
        got = P.evaluate(pg, pm, params_from_numpy(p, "cpu"), n=16, batch=8)
        assert got == want
    elif name in ("spatialdenoise", "unet"):
        from shadernn_tpu.engine.compile import compile_graph, extract_params
        from shadernn_tpu.models import build_model
        import shadernn_tpu as snn

        kw = {"unet": dict(base_filters=8, depth=3)}.get(name, dict(features=16, depth=4))
        g = build_model(name, h=32, w=32, **kw)
        m = compile_graph(g, snn.EngineOptions(backend=snn.BackendKind.XLA, batch_size=2))
        p = _perturbed(extract_params(g))
        s = train_denoiser.setup(model=name, batch=2, size=32, device="cpu")
        want = JD.evaluate(g, m, jax.tree.map(jnp.asarray, p), n=2, size=64)
        got = train_denoiser.evaluate(s.graph, s.model, params_from_numpy(p, "cpu"), n=2,
                                      size=64)
        np.testing.assert_allclose(got, want, atol=0.01)
    elif name == "styletransfer":
        g, m = JS.build_trainable(2, hw=16)
        p = _perturbed(m.params)
        pg, pm = train_styletransfer.build_trainable(2, 16, device="cpu")
        want = JS.evaluate(g, m, jax.tree.map(jnp.asarray, p), n=4, batch=2, hw=16)
        got = train_styletransfer.evaluate(pg, pm, params_from_numpy(p, "cpu"), n=4, batch=2,
                                           hw=16)
        np.testing.assert_allclose(got, want, atol=0.01)
    elif name == "yolo":
        full, _g, m = JY.build_trainable(2, hw=256)
        p = _perturbed(m.params)
        want = JY.evaluate_map(full, p, n=4, batch=2, log=lambda *_: None)
        pfull = train_yolo.build_trainable(2, hw=256, device="cpu")[0]
        got = train_yolo.evaluate_map(pfull, params_from_numpy(p, "cpu"), n=4, batch=2,
                                      log=lambda *_: None, device="cpu")
        assert got == pytest.approx(want, abs=1e-9)
    else:
        weights = train_espcn.glorot_init(6)
        model = JE.build_keras_espcn()
        for n, d in weights.items():
            model.get_layer(n).set_weights([d["weight"], d["bias"]])
        want = JE.evaluate(model, n=2, size=64, log=lambda *_: None)
        s = train_espcn.setup(batch=2, patch=16, device="cpu")
        got = train_espcn.evaluate(s.graph, s.model, params_from_numpy(weights, "cpu"), n=2,
                                   size=64, log=lambda *_: None)
        np.testing.assert_allclose(got, want, atol=0.01)
        assert got[1] == want[1]  # the bilinear baseline: PIL's, bit for bit


def test_cli_writes_only_into_out(tmp_path):
    """A short run of a trainer's CLI on the CPU: the artifact lands in
    --out, nothing in the JAX package's artifacts; the default --out is the
    git-ignored build/trained/."""
    before = sorted(os.listdir(ARTIFACTS))
    train_denoiser.main(["--steps", "2", "--out", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["spatialdenoise_trained_layers.json",
                                            "spatialdenoise_trained_weights.bin"]
    assert sorted(os.listdir(ARTIFACTS)) == before
    assert train_resnet18.OUT_DIR.endswith(os.path.join("build", "trained"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            train_denoiser.setup(steps=2, batch=1, size=16)
