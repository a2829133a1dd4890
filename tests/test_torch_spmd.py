"""The port's explicit SPMD executor (shadernn_tpu_torch/parallel/spmd.py)
against the JAX package's, on logical meshes of the CPU.

Counterparts of tests/test_spmd.py: each case runs the same seeded model on
the same numpy frames through the JAX sharded engine (8 virtual CPU
devices) and through the port's sharded engine on a mesh of
torch.device("cpu") named n times, at the same mesh. The port's sharded
output is held to the JAX sharded output (1e-4 at FP32, 0.1 at BF16/INT8,
tests/conftest.py) and, as the JAX tests hold theirs, to the port's own
single-device engine with tests/oracle.py's `compare`. Where the port's
per-shard plan gives a conv to the implicit-GEMM kernel (AUTO admits
ESPCN's convs, the StyleTransfer k9 stem and the YOLOv3-tiny stem), the
two plans' kernel convs are asserted equal (the JAX planner under
SNN_AUTO_PALLAS_ANYWHERE=1), and on meshes of up to 4 devices the JAX
engine runs its Pallas kernel there too, in interpret mode (on 8 virtual
devices the JAX interpret mode does not finish: its sharded step waits
forever); on the CPU the port's kernel wrapper runs its plain version on
every shard.
"""

import contextlib
import os


import numpy as np
import pytest
import torch

import oracle
import shadernn_tpu as J
from shadernn_tpu.config import BackendKind as JBackend
from shadernn_tpu.config import ShardingOptions as JSharding
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.parallel.mesh import make_mesh as j_make_mesh
from shadernn_tpu.parallel.spmd import _local_backend as j_local_backend

import shadernn_tpu_torch as P
from shadernn_tpu_torch.config import ShardingOptions
from shadernn_tpu_torch.graph.builder import GraphBuilder
from shadernn_tpu_torch.parallel.mesh import make_mesh
from shadernn_tpu_torch.parallel.spmd import plan_spmd

CPU = torch.device("cpu")
TOL = {"fp32": 1e-4, "bf16": 0.1, "int8": 0.1}


def _opts(pkg, prec, batch, sh, **kw):
    return pkg.EngineOptions(precision=getattr(pkg.Precision, prec.upper()), batch_size=batch,
                             sharding=sh, **kw)


@contextlib.contextmanager
def pallas_anywhere(on=True):
    """The JAX planner's AUTO gives Pallas its convs off the TPU too."""
    old = os.environ.get("SNN_AUTO_PALLAS_ANYWHERE")
    if on:
        os.environ["SNN_AUTO_PALLAS_ANYWHERE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SNN_AUTO_PALLAS_ANYWHERE", None)
        if old is not None:
            os.environ["SNN_AUTO_PALLAS_ANYWHERE"] = old


def _jax_kernel_convs(eng):
    """The convs the JAX engine's per-shard program gives to Pallas."""
    g, o = eng.model.graph, eng.model.options
    with pallas_anywhere():
        return sorted(n.name for n in g.toposort()
                      if n.op == "Conv2D" and j_local_backend(n, g, o) == JBackend.PALLAS)


def sharded_pair(build_j, build_p, x, mesh, prec="fp32", jax_kw=None, **kw):
    """(JAX sharded output, port sharded output, port sharded engine) of
    the same model on the same frames and mesh; the JAX engine runs Pallas
    where the port runs the kernel on meshes of up to 4 devices."""
    d, m, s = mesh
    jsh, psh = JSharding(data=d, model=m, spatial=s), ShardingOptions(data=d, model=m, spatial=s)
    with pallas_anywhere(d * m * s <= 4):
        jeng = J.Engine.from_graph(build_j(), _opts(J, prec, x.shape[0], jsh, **(jax_kw or kw)),
                                   mesh=j_make_mesh(jsh))
        want = np.asarray(jeng.run_single(x), np.float32)
    peng = P.Engine.from_graph(build_p(), _opts(P, prec, x.shape[0], psh, device="cpu", **kw),
                               mesh=make_mesh(psh, [CPU] * (d * m * s)))
    got = peng.run_single(x)
    assert got.dtype == torch.float32
    oracle.compare(got.numpy(), want, TOL[prec], f"port vs jax {mesh}")
    # GSPMD drops the JAX package's Pallas kernels: no kernel on any shard.
    gspmd = kw.get("spmd_mode") == "gspmd"
    assert sorted(peng.model.forward.kernel_conv_plan) == ([] if gspmd else _jax_kernel_convs(jeng))
    return want, got.numpy(), peng


def zoo_pair(name, x, mesh, prec="fp32", **kw):
    size = dict(h=x.shape[1], w=x.shape[2]) if name != "resnet18" else {}
    return sharded_pair(lambda: jbuild(name, **size), lambda: P.build_model(name, **size),
                        x, mesh, prec, **kw)


def single(name, x, prec="fp32", build=None, **size):
    g = build() if build else P.build_model(name, **size)
    eng = P.Engine.from_graph(g, _opts(P, prec, x.shape[0], ShardingOptions(), device="cpu"))
    return eng.run_single(x).numpy()


def test_tp_shards_model_axis_under_sp(rng):
    """TP shards the model axis while SP is active; every conv runs in
    halo_conv mode on the kernel, O-sliced."""
    x = rng.random((4, 32, 32, 1), dtype=np.float32)
    _, got, eng = zoo_pair("espcn", x, (2, 2, 2))
    plan = eng.model.spmd_plan
    assert plan.summary()["tp_sharded"] >= 2
    assert plan.summary().get("halo_conv", 0) >= 3
    assert sorted(eng.model.forward.kernel_conv_plan) == ["conv_1", "conv_2", "conv_3"]
    shard = eng.model.params[0]
    assert tuple(shard["conv_1"]["weight"].shape) == (5, 5, 1, 8)
    assert tuple(shard["conv_3"]["weight"].shape) == (3, 3, 16, 2)
    oracle.compare(got, single("espcn", x, h=32, w=32), 1e-4, "tp-under-sp")


def test_sharded_large_frame_equivalence(rng):
    """SP at a 1080-row frame, TP beside it (the JAX engine on XLA: its
    Pallas interpret mode at 1080 rows would take minutes; the port's
    convs run the kernel's plain version)."""
    x = rng.random((1, 1080, 64, 1), dtype=np.float32)
    psh, jsh = ShardingOptions(model=2, spatial=4), JSharding(model=2, spatial=4)
    peng = P.Engine.from_graph(P.build_model("espcn", h=1080, w=64),
                               _opts(P, "fp32", 1, psh, device="cpu"),
                               mesh=make_mesh(psh, [CPU] * 8))
    jeng = J.Engine.from_graph(jbuild("espcn", h=1080, w=64), _opts(J, "fp32", 1, jsh),
                               mesh=j_make_mesh(jsh))
    got = peng.run_single(x).numpy()
    oracle.compare(got, np.asarray(jeng.run_single(x)), 1e-4, "sp-1080p vs jax")
    oracle.compare(got, single("espcn", x, h=1080, w=64), 1e-4, "sp-1080p")


def test_kernels_survive_sharding(rng):
    """Forced KERNEL under SP: the implicit-GEMM conv runs per shard (its
    plain version here), the JAX engine's Pallas conv in interpret mode."""
    x = rng.random((2, 16, 32, 1), dtype=np.float32)
    _, got, eng = sharded_pair(
        lambda: jbuild("espcn", h=16, w=32), lambda: P.build_model("espcn", h=16, w=32),
        x, (1, 1, 2), backend=P.BackendKind.KERNEL, jax_kw=dict(backend=JBackend.PALLAS))
    assert sorted(eng.model.forward.kernel_conv_plan) == ["conv_1", "conv_2", "conv_3"]
    oracle.compare(got, single("espcn", x, h=16, w=32), 1e-4, "kernel-under-sp")


def test_int8_sharded(rng):
    """INT8 weight-only under mixed sharding: the dequant scales are
    O-sliced beside the weights, and the kernel takes the int8 weight."""
    x = rng.random((4, 32, 32, 1), dtype=np.float32)
    _, got, eng = zoo_pair("espcn", x, (2, 2, 2), prec="int8")
    shard = eng.model.params[0]
    assert shard["conv_2"]["weight_q"].dtype == torch.int8
    assert tuple(shard["conv_2"]["weight_scale"].shape)[-1] == 8
    oracle.compare(got, single("espcn", x, "int8", h=32, w=32), 1e-2, "int8-sharded")


def test_plan_modes_are_static():
    """The planner is a pure function of (graph, options)."""
    from shadernn_tpu_torch.graph import fusion

    g = P.build_model("espcn", h=32, w=32)
    fusion.optimize(g)
    g.infer_shapes(batch_size=4)
    plan = plan_spmd(g, P.EngineOptions(batch_size=4, device="cpu",
                                        sharding=ShardingOptions(data=2, model=2, spatial=2)))
    modes = {n: p.mode for n, p in plan.nodes.items()}
    assert modes["input"] == "input"
    assert all(p == "halo_conv" for n, p in modes.items() if n.startswith("conv")), modes
    assert modes["subpixel"] == "local"
    assert plan.out_state["subpixel"]


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 2)], ids=["dp", "tp-under-sp"])
def test_gspmd_baseline_still_works(rng, mesh):
    """spmd_mode="gspmd": the explicit executor with TORCH on every shard
    and, under SP, no TP (the model axis replicates)."""
    d, m, s = mesh
    x = rng.random((2 * d, 16 * s, 32, 1), dtype=np.float32)
    _, got, eng = zoo_pair("espcn", x, mesh, spmd_mode="gspmd")
    assert eng.model.forward.kernel_conv_plan == []
    if s > 1:
        assert eng.model.spmd_plan.summary()["tp_sharded"] == 0
    oracle.compare(got, single("espcn", x, h=16 * s, w=32), 1e-4, "gspmd")


def _dw_graph(builder):
    b = builder("dwgather", seed=5)
    x = b.input(32, 32, 8, name="in")
    x = b.conv2d(x, 8, 3, name="c0", activation="relu")
    # valid padding: H_out = 30 does not divide spatial = 4 -> gather mode
    x = b.depthwise(x, 3, padding="valid", name="dw")
    b.conv2d(x, 8, 1, name="head")
    return b.build()


def test_depthwise_gather_fallback_drops_tp(rng):
    """A depthwise conv forced into gather mode drops TP too."""
    from shadernn_tpu.graph.builder import GraphBuilder as JBuilder

    x = rng.random((2, 32, 32, 8), dtype=np.float32)
    _, got, eng = sharded_pair(lambda: _dw_graph(JBuilder), lambda: _dw_graph(GraphBuilder),
                               x, (1, 2, 4))
    plan = eng.model.spmd_plan
    assert plan.nodes["dw"].mode == "gather" and not plan.nodes["dw"].tp
    np.testing.assert_allclose(got, single("", x, build=lambda: _dw_graph(GraphBuilder)),
                               rtol=1e-5, atol=1e-5)


def _ups_graph(builder, interp):
    b = builder(f"ups_{interp}", seed=6)
    x = b.input(32, 32, 4, name="in")
    x = b.conv2d(x, 4, 3, name="c0", activation="relu")
    b.upsample(x, 2, interpolation=interp, name="up")
    return b.build()


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_bilinear_upsample_gathers_under_sp(rng, interp):
    """Bilinear upsampling mixes rows across shard seams: it gathers;
    nearest stays shard-local."""
    from shadernn_tpu.graph.builder import GraphBuilder as JBuilder

    x = rng.random((2, 32, 32, 4), dtype=np.float32)
    _, got, eng = sharded_pair(lambda: _ups_graph(JBuilder, interp),
                               lambda: _ups_graph(GraphBuilder, interp), x, (1, 1, 4))
    assert eng.model.spmd_plan.nodes["up"].mode == ("gather" if interp == "bilinear" else "local")
    np.testing.assert_allclose(
        got, single("", x, build=lambda: _ups_graph(GraphBuilder, interp)),
        rtol=1e-5, atol=1e-5, err_msg=interp)


def _pool_graph(builder):
    b = builder("poolnet")
    x = b.input(32, 16, 3, name="input")
    x = b.conv2d(x, 8, 3, activation="relu", name="c1")
    x = b.maxpool(x, 2, stride=2, name="mp")
    x = b.conv2d(x, 8, 3, activation="relu", name="c2")
    x = b.avgpool(x, 3, stride=1, padding="same", name="ap")
    b.conv2d(x, 4, 3, name="out")
    return b.build()


def test_pool_halo_seam_correct(rng):
    """Max pooling with a -inf edge fill and the count-correct average stay
    shard-local under SP and match at the seams and the frame edges."""
    from shadernn_tpu.graph.builder import GraphBuilder as JBuilder

    x = rng.standard_normal((1, 32, 16, 3)).astype(np.float32) * 3
    _, got, eng = sharded_pair(lambda: _pool_graph(JBuilder), lambda: _pool_graph(GraphBuilder),
                               x, (1, 1, 4))
    plan = eng.model.spmd_plan
    assert plan.nodes["mp"].mode == "pool_halo" and plan.nodes["ap"].mode == "pool_halo"
    oracle.compare(got, single("", x, build=lambda: _pool_graph(GraphBuilder)), 1e-5,
                   "pool-halo-sp")


@pytest.mark.parametrize("mesh,prec", [((2, 2, 2), "bf16"), ((1, 2, 2), "fp32")],
                         ids=["2x2x2-bf16", "1x2x2-fp32"])
def test_espcn_auto_sharded_matches_jax(rng, mesh, prec):
    """AUTO under mixed sharding at each precision, the convs on the kernel
    per shard; at (1,2,2) the JAX engine runs its Pallas conv per shard."""
    d = mesh[0]
    x = rng.random((2 * d, 32, 32, 1), dtype=np.float32)
    _, got, eng = zoo_pair("espcn", x, mesh, prec=prec)
    assert sorted(eng.model.forward.kernel_conv_plan) == ["conv_1", "conv_2", "conv_3"]
    oracle.compare(got, single("espcn", x, prec, h=32, w=32), 1e-4 if prec == "fp32" else 0.1,
                   f"{prec}-sharded")
