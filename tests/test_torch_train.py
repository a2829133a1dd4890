"""The port's trainers against the JAX package's, at small sizes on the CPU:
for each trainer, from the JAX trainer's initial parameters carried across
(`weights.params_from_numpy`), the loss and every gradient of one batch
against `jax.value_and_grad` of the JAX forward (XLA backend), and three
optimizer steps of the port (tools/optim.py: torch Adam, LambdaLR,
clip_grad_norm_, frozen BatchNorm statistics) against three steps of the
JAX trainer's optax transform on the same batches. The JAX losses and
transforms below are the JAX trainers' own expressions
(shadernn_tpu/tools/train_*.py), which build them inside `train`.

ESPCN's JAX trainer trains a Keras model: its three steps are held against
Keras's `fit` (Adam, CosineDecay) from the port's initial weights, and its
gradient against the JAX engine's forward of the same graph.

Tolerances: the loss within 1e-5 relative; each gradient tensor within
1e-3 of its largest magnitude (float32 sums in another order: about 1e-6
seen; where two values of a max-pool
window lie within a rounding of each other the two forwards may pick
different ones, and the gradient of the layers below moves by about 2e-4:
YOLOv3-tiny at 64x64 b2); after three steps each parameter within 1e-5 absolute plus 1e-4 of
its magnitude (an Adam step moves a parameter by up to the learning rate,
here at most 2e-3, whatever the gradient's scale), but for leaves whose
gradient is rounding noise (below).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shadernn_tpu.tools import train_denoiser as JD
from shadernn_tpu.tools import train_mobilenetv2 as JM
from shadernn_tpu.tools import train_resnet18 as JR
from shadernn_tpu.tools import train_styletransfer as JS
from shadernn_tpu.tools import train_yolo as JY

from shadernn_tpu_torch.tools import (
    train_denoiser, train_espcn, train_mobilenetv2, train_resnet18, train_styletransfer,
    train_yolo,
)
from shadernn_tpu_torch.weights import params_from_numpy

STEPS = 3
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
MODELS = ("resnet18", "mobilenetv2", "spatialdenoise", "unet", "aidenoise", "styletransfer",
          "yolo", "espcn")


def _frozen_labels(params):
    return {n: {k: ("freeze" if k in ("mean", "variance") else "train") for k in d}
            for n, d in params.items()}


def _classifier_loss(fwd, out_name):
    # shadernn_tpu/tools/train_resnet18.py:130-133 (train_mobilenetv2.py:72-75)
    def loss_fn(p, x, y):
        probs = fwd(p, {"input": x})[out_name]
        logp = jnp.log(jnp.clip(probs, 1e-8))
        return -jnp.mean(logp[jnp.arange(y.shape[0]), y])

    return loss_fn


def _mse_loss(fwd, in_name, out_name):
    # train_denoiser.py:68-70, train_styletransfer.py:183-185
    def loss_fn(p, x, y):
        return jnp.mean((fwd(p, {in_name: x})[out_name] - y) ** 2)

    return loss_fn


def _yolo_loss(fwd, in_name):
    # shadernn_tpu/tools/train_yolo.py:159-182
    def bce(logit, target):
        return jnp.maximum(logit, 0) - logit * target + jnp.log1p(jnp.exp(-jnp.abs(logit)))

    def loss_fn(p, x, tgt1, pos1, tgt2, pos2):
        outs = fwd(p, {in_name: x})
        total = 0.0
        for head, tgt, pos in (("head1", tgt1, pos1), ("head2", tgt2, pos2)):
            f = outs[head]
            n_, gh, gw, _ = f.shape
            f = f.reshape(n_, gh, gw, 3, 5 + JY.NUM_CLASSES)
            posf = pos.astype(jnp.float32)
            npos = jnp.maximum(posf.sum(), 1.0)
            lobj = bce(f[..., 4], tgt[..., 4])
            total = total + 5.0 * (lobj * posf).sum() / npos
            total = total + 0.5 * (lobj * (1 - posf)).sum() / lobj.size
            lxy = ((jax.nn.sigmoid(f[..., 0:2]) - tgt[..., 0:2]) ** 2).sum(-1)
            lwh = ((f[..., 2:4] - tgt[..., 2:4]) ** 2).sum(-1)
            lcls = bce(f[..., 5:], tgt[..., 5:]).sum(-1)
            total = total + ((lxy + 0.5 * lwh + lcls) * posf).sum() / npos
        return total

    return loss_fn


def _jax_model(graph, batch):
    import shadernn_tpu as snn
    from shadernn_tpu.engine.compile import compile_graph

    return compile_graph(graph, snn.EngineOptions(
        precision=snn.Precision.FP32, backend=snn.BackendKind.XLA, batch_size=batch,
        fold_batchnorm=False))


@functools.lru_cache(maxsize=None)
def case(name):
    """(port Setup, JAX forward, JAX initial params, JAX loss, JAX tx, the
    port's batches) for one trainer at its small size. The schedules are
    the trainers' defaults (steps 600 / 700 / 500 / 400 / 500), of which
    the three steps run the first counts."""
    if name == "resnet18":
        s = train_resnet18.setup(steps=600, base_filters=4, batch=4, device="cpu")
        g, m = JR.build_trainable(4, 4)
        p = dict(m.params)
        for n, d in p.items():  # train_resnet18.py:122-128
            if n.endswith("_bn2") and "gamma" in d:
                p[n] = dict(d, gamma=jnp.zeros_like(d["gamma"]))
        loss = _classifier_loss(m.forward, g.output_names[0])
        tx = optax.multi_transform({
            "train": optax.chain(optax.clip_by_global_norm(1.0),
                                 optax.adam(optax.warmup_cosine_decay_schedule(0.0, 2e-3, 50, 600))),
            "freeze": optax.set_to_zero()}, _frozen_labels(p))
    elif name == "mobilenetv2":
        s = train_mobilenetv2.setup(steps=700, width_mult=0.25, batch=4, device="cpu")
        g, m = JM.build_trainable(0.25, 4)
        p = dict(m.params)
        for n in {x.name.rsplit("_add", 1)[0] for x in g.nodes.values()
                  if x.name.endswith("_add")}:  # train_mobilenetv2.py:58-70
            bn = f"{n}_project_bn"
            if bn in p and "gamma" in p[bn]:
                p[bn] = dict(p[bn], gamma=jnp.zeros_like(p[bn]["gamma"]))
        loss = _classifier_loss(m.forward, g.output_names[0])
        tx = optax.multi_transform({
            "train": optax.chain(optax.clip_by_global_norm(1.0),
                                 optax.adam(optax.warmup_cosine_decay_schedule(0.0, 2e-3, 50, 700))),
            "freeze": optax.set_to_zero()}, _frozen_labels(p))
    elif name in ("spatialdenoise", "unet", "aidenoise"):
        from shadernn_tpu.models import build_model

        size = 16 if name == "spatialdenoise" else 32
        s = train_denoiser.setup(steps=500, model=name, batch=2, size=size, device="cpu")
        kw = {"unet": dict(base_filters=8, depth=3), "aidenoise": dict(features=16, depth=3)}
        g = build_model(name, h=size, w=size, **kw.get(name, dict(features=16, depth=4)))
        m = _jax_model(g, 2)
        p = m.params
        loss = _mse_loss(m.forward, "input", g.output_names[0])
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 30, 500)))
    elif name == "styletransfer":
        s = train_styletransfer.setup(steps=400, batch=2, hw=16, device="cpu")
        g, m = JS.build_trainable(2, hw=16)
        p = m.params
        loss = _mse_loss(m.forward, g.input_names[0], g.output_names[0])
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 30, 400)))
    elif name == "yolo":
        s = train_yolo.setup(steps=500, batch=2, hw=64, device="cpu")
        _full, g, m = JY.build_trainable(2, hw=64)
        p = m.params
        loss = _yolo_loss(m.forward, g.input_names[0])
        tx = optax.multi_transform({
            "train": optax.chain(optax.clip_by_global_norm(5.0),
                                 optax.adam(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 50, 500))),
            "freeze": optax.set_to_zero()}, _frozen_labels(p))
    else:  # espcn: the JAX engine's forward of the same graph; no optax
        from shadernn_tpu.graph.ir import Graph as JGraph, Node as JNode

        s = train_espcn.setup(steps=6000, batch=4, patch=16, device="cpu")
        g = JGraph("espcn")
        for n in s.graph.toposort():
            g.add(JNode(n.name, n.op, list(n.inputs), dict(n.attrs),
                        {k: np.array(v) for k, v in n.params.items()}))
        g.finalize()
        m = _jax_model(g, 4)
        p = m.params
        loss = _mse_loss(m.forward, "input", g.output_names[0])
        tx = None
    rng = np.random.default_rng(20261017)
    batches = [s.batch(rng) for _ in range(STEPS)]
    p = {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in p.items()}
    return s, p, loss, tx, batches


def _carry(s, p):
    """The JAX parameters into the port's tensors, in place (the optimizer
    holds them)."""
    src = params_from_numpy({n: {k: np.asarray(v) for k, v in d.items()} for n, d in p.items()},
                            "cpu")
    assert set(src) == set(s.params)
    with torch.no_grad():
        for n, d in s.params.items():
            assert set(d) == set(src[n]), n
            for k, t in d.items():
                t.copy_(src[n][k])


def _close(got, want, rtol, atol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    lim = atol + rtol * float(np.max(np.abs(want))) if want.size else atol
    assert err <= lim, f"{what}: max_abs_diff {err:.3e} > {lim:.3e}"
    return err


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax(name):
    s, p, loss, _tx, batches = case(name)
    _carry(s, p)
    batch = batches[0]
    jl, jg = jax.jit(jax.value_and_grad(loss))(p, *[jnp.asarray(a) for a in batch])
    pl, pg = s.state.grads(s.loss, *s.to_device(batch))
    _close(float(pl), float(jl), LOSS_RTOL, what="loss")
    frozen = {(n, k) for n, d in s.params.items() for k, t in d.items() if not t.requires_grad}
    assert sum(g.numel() for d in pg.values() for g in d.values()) > 0
    floor = 1e-3 * max(float(jnp.max(jnp.abs(v))) for d in jg.values() for v in d.values())
    rel = {}
    for n, d in jg.items():
        for k, v in d.items():
            if (n, k) in frozen:
                assert k in ("mean", "variance"), (n, k)
                continue
            want = np.asarray(v)
            err = float(np.abs(pg[n][k].numpy() - want).max())
            rel[f"{n}.{k}"] = err / max(float(np.abs(want).max()), floor)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_RTOL, f"{name} {worst}: {rel[worst]:.3e} of its magnitude"


def _keras_steps(w, batches):
    """Three steps of the JAX trainer's Keras recipe (train_espcn.py:92-101:
    Adam on CosineDecay(2e-3, steps), the MSE loss, batches in order), from
    the initial weights `w`."""
    import keras

    from shadernn_tpu.tools.train_espcn import build_keras_espcn

    model = build_keras_espcn()
    for n in ("conv_1", "conv_2", "conv_3"):
        model.get_layer(n).set_weights([np.asarray(w[n]["weight"]), np.asarray(w[n]["bias"])])
    opt = keras.optimizers.Adam(keras.optimizers.schedules.CosineDecay(2e-3, 6000))
    model.compile(optimizer=opt, loss="mse")
    for lr, hr in batches:
        model.train_on_batch(lr, hr)
    return {n: {"weight": model.get_layer(n).get_weights()[0],
                "bias": model.get_layer(n).get_weights()[1]} for n in ("conv_1", "conv_2",
                                                                        "conv_3")}


@pytest.mark.parametrize("name", MODELS)
def test_three_steps_match_jax(name):
    s, p, loss, tx, batches = case(name)
    _carry(s, p)
    assert s.state.count == 0  # the gradient test takes no step
    # Leaves whose gradient is rounding noise (the biases ahead of an
    # InstanceNorm, whose true gradient is 0; 1e-8 of the largest seen):
    # Adam moves them by up to the learning rate in either package, by the
    # noise's sign. They are held within twice the sum of the three rates.
    _, g0 = s.state.grads(s.loss, *s.to_device(batches[0]))
    gmax = max(float(g.abs().max()) for d in g0.values() for g in d.values())
    noise = {(n, k) for n, d in g0.items() for k, g in d.items()
             if float(g.abs().max()) <= 1e-6 * gmax}
    lr_sum = sum(s.state.sched.lr_lambdas[0](c) for c in range(STEPS))
    losses = [float(s.state.step(s.loss, *s.to_device(b))) for b in batches]
    if tx is None:
        want = _keras_steps(p, batches)
        assert s.state.keras_eps
    else:
        @jax.jit
        def step(p, opt, *b):
            l, g = jax.value_and_grad(loss)(p, *b)
            updates, opt = tx.update(g, opt, p)
            return optax.apply_updates(p, updates), opt, l

        want, opt = p, tx.init(p)
        for i, b in enumerate(batches):
            want, opt, jl = step(want, opt, *[jnp.asarray(a) for a in b])
            _close(losses[i], float(jl), LOSS_RTOL, what=f"{name} loss at step {i}")
    moved = 0
    for n, d in want.items():
        for k, v in d.items():
            got = s.params[n][k].detach().numpy()
            if (n, k) in noise:
                _close(got, v, 0.0, 2 * lr_sum, what=f"{name} {n}.{k} (noise gradient)")
            else:
                _close(got, v, PARAM_RTOL, PARAM_ATOL, what=f"{name} {n}.{k}")
            moved += int(not np.array_equal(got, np.asarray(p[n][k])))
            if not s.params[n][k].requires_grad:  # frozen: untouched
                assert np.array_equal(got, np.asarray(p[n][k])), (n, k)
    assert moved > 0, f"{name}: no parameter moved in {STEPS} steps"


@pytest.mark.parametrize("name", ["resnet18", "yolo"])
def test_frozen_statistics_and_requires_grad(name):
    s = case(name)[0]
    frozen = [(n, k) for n, d in s.params.items() for k, t in d.items() if not t.requires_grad]
    assert frozen and {k for _, k in frozen} == {"mean", "variance"}
    trained = {id(t) for _, _, t in s.state.trained}
    assert all(id(s.params[n][k]) not in trained for n, k in frozen)
    assert len(trained) == sum(len(d) for d in s.params.values()) - len(frozen)
