"""The port's parallel layer against the JAX package on logical CPU meshes:
the halo-exchange conv (tests/test_halo.py's counterparts), sharded zoo
models (tests/test_parallel.py's and the zoo cases of tests/test_spmd.py),
the scaling harness (tests/test_scaling.py's; the wall-clock assertion of
`test_scaling_is_not_serialized` is not carried over: a logical mesh runs
its shards one after another), the dry run and the mesh helpers.
"""

import numpy as np
import pytest
import torch

import oracle
import shadernn_tpu as J
from shadernn_tpu.config import ShardingOptions as JSharding
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.ops.common import padding_offsets
from shadernn_tpu.parallel.mesh import make_mesh as j_make_mesh

import shadernn_tpu_torch as P
from shadernn_tpu_torch.config import ShardingOptions
from shadernn_tpu_torch.parallel.halo import halo_exchange, make_halo_conv
from shadernn_tpu_torch.parallel.mesh import make_mesh, owns_slice, shard_index

from test_torch_spmd import CPU, single, zoo_pair


def _spatial_mesh(n):
    return make_mesh(ShardingOptions(spatial=n), [CPU] * n)


# ---------------------------------------------------------------------------
# Halo exchange (tests/test_halo.py)


@pytest.mark.parametrize("k", [3, 5, 9, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n_shards", [4, 8])
def test_halo_conv_matches_oracle(rng, fp32_threshold, k, overlap, n_shards):
    h, w, cin, cout = 32, 24, 6, 8
    x = rng.standard_normal((2, h, w, cin), dtype=np.float32)
    wt = rng.standard_normal((k, k, cin, cout), dtype=np.float32) * 0.2
    pads = padding_offsets("same", k)
    conv = make_halo_conv(_spatial_mesh(n_shards), "spatial", overlap=overlap)
    got = conv(torch.from_numpy(x), torch.from_numpy(wt), pads).numpy()
    want = oracle.conv2d(x, wt, None, stride=1, pads=pads)
    oracle.compare(got, want, fp32_threshold, f"halo-conv k{k} n{n_shards} ov={overlap}")


def test_halo_conv_chain(rng, fp32_threshold):
    """Two chained halo convs, as a sharded model runs them."""
    x = rng.standard_normal((1, 64, 16, 4), dtype=np.float32)
    w1 = rng.standard_normal((3, 3, 4, 8), dtype=np.float32) * 0.3
    w2 = rng.standard_normal((5, 5, 8, 4), dtype=np.float32) * 0.3
    p1, p2 = padding_offsets("same", 3), padding_offsets("same", 5)
    conv = make_halo_conv(_spatial_mesh(8), "spatial")
    y = torch.relu(conv(torch.from_numpy(x), torch.from_numpy(w1), p1))
    got = conv(y, torch.from_numpy(w2), p2).numpy()
    want = oracle.conv2d(np.maximum(oracle.conv2d(x, w1, None, 1, p1), 0), w2, None, 1, p2)
    oracle.compare(got, want, fp32_threshold, "halo-chain")


@pytest.mark.parametrize("fill", [0.0, float("-inf")])
def test_halo_exchange_edge_fill(rng, fill):
    """Edge shards see `fill` halos (zero: the global zero padding; -inf:
    max-pooling's), inner shards their neighbours' rows."""
    x = torch.from_numpy(rng.standard_normal((1, 8, 4, 2), dtype=np.float32))
    ys = halo_exchange(list(torch.chunk(x, 4, dim=1)), 1, 1, fill)
    assert [tuple(y.shape) for y in ys] == [(1, 4, 4, 2)] * 4
    assert torch.all(ys[0][:, 0] == fill) and torch.all(ys[-1][:, -1] == fill)
    torch.testing.assert_close(ys[0][:, 1:3], x[:, 0:2], rtol=0, atol=0)
    torch.testing.assert_close(ys[1][:, 0], x[:, 1], rtol=0, atol=0)  # shard 0's last row
    torch.testing.assert_close(ys[1][:, 3], x[:, 4], rtol=0, atol=0)  # shard 2's first row


# ---------------------------------------------------------------------------
# Sharded models (tests/test_parallel.py)


@pytest.mark.parametrize("data,model_p,spatial", [(8, 1, 1), (1, 8, 1), (1, 1, 8), (2, 2, 2)])
def test_espcn_sharded_matches_single_device(rng, data, model_p, spatial):
    batch, h = 2 * data, 8 * spatial
    x = rng.random((batch, h, 32, 1), dtype=np.float32)
    _, got, _ = zoo_pair("espcn", x, (data, model_p, spatial))
    oracle.compare(got, single("espcn", x, h=h, w=32), 1e-4,
                   f"sharded d{data}m{model_p}s{spatial}")


def test_resnet_sharded(rng):
    """A classifier with BN-folded convs and a dense head under DP x TP."""
    x = rng.random((4, 32, 32, 3), dtype=np.float32)
    _, got, eng = zoo_pair("resnet18", x, (2, 4, 1))
    assert eng.model.spmd_plan.summary()["dense"] == 1
    oracle.compare(got, single("resnet18", x), 1e-4, "resnet-sharded")


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(ShardingOptions(data=64), [CPU] * 8)
    if not torch.cuda.is_available():  # no CUDA device: no default mesh, never the CPU
        with pytest.raises(ValueError):
            make_mesh(ShardingOptions(data=2))


def test_mesh_device_type_must_match_options():
    mesh = make_mesh(ShardingOptions(data=2), [CPU] * 2)
    g = P.build_model("espcn", h=8, w=8)
    with pytest.raises((ValueError, RuntimeError)):
        P.Engine.from_graph(g, P.EngineOptions(batch_size=2,
                                               sharding=ShardingOptions(data=2)), mesh=mesh)


def test_shard_index_and_owner():
    mesh = make_mesh(ShardingOptions(data=2, model=2, spatial=2), [CPU] * 8)
    spec = ("data", "spatial", None, None)
    assert shard_index(spec, mesh, (1, 0, 1), (4, 8, 3, 1)) == (
        slice(2, 4), slice(4, 8), slice(None), slice(None))
    assert owns_slice(spec, mesh, (1, 0, 1)) and not owns_slice(spec, mesh, (1, 1, 1))
    with pytest.raises(ValueError):
        shard_index(spec, mesh, (0, 0, 0), (3, 8, 3, 1))
    assert mesh.group((1, 0, 1), "model") == [(1, 0, 1), (1, 1, 1)]


# ---------------------------------------------------------------------------
# Zoo models (the zoo cases of tests/test_spmd.py)


def test_mobilenet_sharded_dw_tp_and_gap(rng):
    """Depthwise TP (input-channel slice + O-slice) and the psum'd global
    average pool under DP x TP."""
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    _, got, eng = zoo_pair("mobilenetv2", x, (2, 4, 1))
    assert eng.model.spmd_plan.summary()["dw_conv"] == 17
    oracle.compare(got, single("mobilenetv2", x, h=64, w=64), 1e-4, "mobilenet-dp-tp")


def test_mobilenet_spatial_sharded(rng):
    """MobileNetV2 under SP x TP: strided depthwise convs exchange halos,
    the global pool is psum'd."""
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    _, got, eng = zoo_pair("mobilenetv2", x, (1, 2, 2))
    summary = eng.model.spmd_plan.summary()
    assert summary["gap"] == 1 and summary["halo_conv"] >= 1, summary
    oracle.compare(got, single("mobilenetv2", x, h=64, w=64), 1e-4, "mobilenet-sp")


def test_styletransfer_instancenorm_sp(rng):
    """InstanceNorm statistics psum'd over the spatial axis; deconvs gather;
    the k9 stem on the kernel under SP."""
    x = rng.random((1, 64, 48, 3), dtype=np.float32)
    _, got, eng = zoo_pair("styletransfer", x, (1, 1, 4))
    assert eng.model.spmd_plan.summary()["instnorm"] >= 1
    assert eng.model.forward.kernel_conv_plan
    oracle.compare(got, single("styletransfer", x, h=64, w=48), 1e-4, "styletransfer-sp")


def test_yolo_head_gather_fallback(rng):
    """Detection: the YOLO decode needs whole-frame coordinates, so the
    planner gathers; everything upstream stays sharded."""
    x = rng.random((1, 128, 128, 3), dtype=np.float32)
    _, got, eng = zoo_pair("yolov3-tiny", x, (1, 1, 2))
    assert eng.model.spmd_plan.summary()["gather"] >= 1
    oracle.compare(got, single("yolov3-tiny", x, h=128, w=128), 1e-4, "yolo-sp")


# ---------------------------------------------------------------------------
# The scaling harness (tests/test_scaling.py) and the dry run


def test_measure_scaling_records():
    from shadernn_tpu_torch.parallel.scaling import measure_scaling

    results = measure_scaling("espcn", (1, 2, 4), per_device_batch=1, iters=2,
                              build_kwargs={"h": 16, "w": 24}, devices=[CPU] * 4)
    assert [r["devices"] for r in results] == [1, 2, 4]
    assert all(r["frames_per_sec"] > 0 for r in results)
    assert results[0]["speedup"] == 1.0
    assert all(r["batch"] == r["devices"] for r in results)


def test_scaling_outputs_not_serialized():
    """The output checks of tests/test_scaling.py's throughput test: the
    4-shard engine's output equals the single-device engine's and the JAX
    4-device engine's (its wall-clock bar is not asserted here)."""
    x = np.random.default_rng(0).random((8, 32, 32, 1), dtype=np.float32)
    sh = ShardingOptions(data=4)
    eng = P.Engine.from_graph(P.build_model("espcn", h=32, w=32),
                              P.EngineOptions(precision=P.Precision.BF16, batch_size=8,
                                              sharding=sh, device="cpu"),
                              mesh=make_mesh(sh, [CPU] * 4))
    got = eng.run_single(x).numpy()
    oracle.compare(got, single("espcn", x, "bf16", h=32, w=32), 0.1, "dp4 vs single")
    jsh = JSharding(data=4)
    jeng = J.Engine.from_graph(jbuild("espcn", h=32, w=32),
                               J.EngineOptions(precision=J.Precision.BF16, batch_size=8,
                                               sharding=jsh), mesh=j_make_mesh(jsh))
    oracle.compare(got, np.asarray(jeng.run_single(x), np.float32), 0.1, "dp4 vs jax")


def test_dp_output_is_genuinely_sharded():
    """The 4-shard engine's step returns 4 shards of batch/4 each, on their
    devices, and they assemble to the global output."""
    sh = ShardingOptions(data=4)
    eng = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                              P.EngineOptions(precision=P.Precision.BF16, batch_size=8,
                                              sharding=sh, device="cpu"),
                              mesh=make_mesh(sh, [CPU] * 4))
    x = torch.from_numpy(np.random.default_rng(0).random((8, 16, 24, 1), dtype=np.float32))
    name = eng.graph.output_names[0]
    shards = eng.model.step(eng.model.params, eng.model.split_inputs({"input": x}))
    assert len(shards) == 4 and {s[name].shape[0] for s in shards} == {2}
    torch.testing.assert_close(torch.cat([s[name] for s in shards]), eng.model({"input": x})[name],
                               rtol=0, atol=0)


def test_dryrun_multichip():
    from __graft_entry__ import _factor3 as j_factor3
    from shadernn_tpu_torch.parallel.dryrun import _factor3, dryrun_multichip

    assert [_factor3(n) for n in range(1, 17)] == [j_factor3(n) for n in range(1, 17)]
    summary = dryrun_multichip(8, devices=[CPU] * 8)
    assert summary["tp_sharded"] >= 1 and summary["halo_conv"] >= 1


def test_run_model_takes_a_mesh():
    from shadernn_tpu_torch.models.runners import run_model

    mesh = make_mesh(ShardingOptions(spatial=2), [CPU] * 2)
    res = run_model("resnet18", batch_size=2, inner_loops=2, mesh=mesh)
    assert res["output_shape"] == (2, 10) and res["class_index"].shape == (2,)


def test_sharded_engine_takes_jax_params(rng):
    """weights.shard_params cuts the JAX package's numpy params
    (params_from_numpy) onto the shards: a sharded engine built with other
    weights then equals the JAX sharded engine."""
    from shadernn_tpu.engine.compile import extract_params as j_extract
    from shadernn_tpu_torch.weights import params_from_numpy

    x = rng.random((4, 32, 32, 1), dtype=np.float32)
    jsh, psh = JSharding(data=2, model=2), ShardingOptions(data=2, model=2)
    jeng = J.Engine.from_graph(jbuild("espcn", h=32, w=32, seed=3),
                               J.EngineOptions(batch_size=4, sharding=jsh), mesh=j_make_mesh(jsh))
    peng = P.Engine.from_graph(P.build_model("espcn", h=32, w=32),
                               P.EngineOptions(batch_size=4, sharding=psh, device="cpu"),
                               mesh=make_mesh(psh, [CPU] * 4))
    before = peng.run_single(x).numpy()
    peng.model.load_params(params_from_numpy(j_extract(jeng.graph), "cpu"))
    assert tuple(peng.model.params[0]["conv_1"]["weight"].shape) == (5, 5, 1, 8)
    want = np.asarray(jeng.run_single(x), np.float32)
    assert np.abs(before - want).max() > 1e-2
    oracle.compare(peng.run_single(x).numpy(), want, 1e-4, "jax params")
    with pytest.raises(ValueError):
        peng.model.load_params({"conv_1": {}})
