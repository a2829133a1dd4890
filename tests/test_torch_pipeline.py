"""The port's pipeline parallelism (shadernn_tpu_torch/parallel/pipeline.py)
against the JAX package's (tests/test_pipeline.py's counterparts).

The JAX engines run on the conftest's eight forced CPU devices, the port's
on `[torch.device("cpu")] * n` (a logical pipeline: one device named once
per stage), both from the same numpy frames and the same builder weights.
The JAX stages run at its default backend (XLA on the CPU); the port's run
as its AUTO plans them (the implicit-GEMM kernel's plain version on the
CPU). Thresholds are the conftest's: 0.01 fp32, 0.1 bf16. No test asserts a
CPU wall-clock ratio: on the CPU the port runs every stage in order on the
calling thread.
"""

import functools

import numpy as np
import pytest
import torch

import oracle
from shadernn_tpu.config import EngineOptions as JOptions
from shadernn_tpu.config import Precision as JPrecision
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.parallel.pipeline import PipelinedEngine as JPipelined
from shadernn_tpu.parallel.pipeline import split_stages as j_split_stages

import shadernn_tpu_torch as P
from shadernn_tpu_torch.config import BackendKind
from shadernn_tpu_torch.models.zoo import list_models
from shadernn_tpu_torch.parallel.pipeline import PipelinedEngine, split_stages

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _graphs(name):
    """Both builder graphs, shapes inferred where the builder left them
    out, at a micro-batch of 2 (as both PipelinedEngines do)."""
    graphs = jbuild(name), P.build_model(name)
    for g in graphs:
        if any(n.out_spec is None for n in g.nodes.values()):
            g.infer_shapes(batch_size=2)
    return graphs


def _stage_view(stages):
    return [([n.name for n in s.nodes], s.consumes, s.produces, s.flops) for s in stages]


@pytest.mark.parametrize("num_stages", [2, 4, 8])
@pytest.mark.parametrize("name", list_models())
def test_split_stages_equal_jax(name, num_stages):
    """Node for node, the same cuts, consumes, produces and flops on the
    builder graph (no fusion pass)."""
    jg, pg = _graphs(name)
    got = split_stages(pg, num_stages)
    assert _stage_view(got) == _stage_view(j_split_stages(jg, num_stages))
    assert len(got) == min(num_stages, len(pg.nodes) - len(pg.input_names))
    assert pg.output_names[0] in got[-1].produces


def test_split_stages_balanced_and_complete():
    g = P.build_model("resnet18")
    stages = split_stages(g, 4)
    all_nodes = [n.name for s in stages for n in s.nodes]
    assert len(all_nodes) == len(set(all_nodes)) == len(g.nodes) - 1
    total = sum(s.flops for s in stages)
    assert max(s.flops for s in stages) < 0.7 * total


def _opts(prec="fp32", **kw):
    return (P.EngineOptions(precision=getattr(P.Precision, prec.upper()), device="cpu", **kw),
            JOptions(precision=getattr(JPrecision, prec.upper())))


def _held(got, jpipe, single, x, in_name, out_name, prec, label):
    tol = 0.01 if prec == "fp32" else 0.1
    want = np.asarray(jpipe.run({in_name: x})[out_name], np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    oracle.compare(got, want, tol * scale, f"{label} vs JAX pipeline")
    oracle.compare(got, single, tol * scale, f"{label} vs single-device engine")


@pytest.mark.parametrize("model,kwargs,num_stages,prec,backend", [
    ("espcn", {"h": 16, "w": 24}, 4, "fp32", BackendKind.AUTO),
    ("espcn", {"h": 16, "w": 24}, 4, "bf16", BackendKind.AUTO),
    ("resnet18", {}, 4, "fp32", BackendKind.AUTO),
    ("resnet18", {}, 4, "fp32", BackendKind.KERNEL),
    ("styletransfer", {"h": 32, "w": 32, "num_res_blocks": 2}, 8, "fp32", BackendKind.AUTO),
])
def test_pipeline_matches_jax_and_single_device(rng, model, kwargs, num_stages, prec, backend):
    g = P.build_model(model, **kwargs)
    in_name, out_name = g.input_names[0], g.output_names[0]
    batch = 4
    x = rng.random((batch, *g.nodes[in_name].out_spec.shape[1:]), dtype=np.float32)
    popts, jopts = _opts(prec, backend=backend)
    single = P.Engine.from_graph(P.build_model(model, **kwargs),
                                 P.EngineOptions(precision=popts.precision, backend=backend,
                                                 batch_size=batch, device="cpu"))
    want_single = single.run_single(x).float().numpy()
    pipe = PipelinedEngine(g, popts, devices=[CPU] * num_stages, micro_batch=2)
    assert len(pipe.stage_devices()) == num_stages
    got = pipe.run({in_name: x})[out_name]
    assert got.dtype == torch.float32 and tuple(got.shape) == want_single.shape
    jpipe = JPipelined(jbuild(model, **kwargs), jopts, num_stages=num_stages, micro_batch=2)
    _held(got.numpy(), jpipe, want_single, x, in_name, out_name, prec,
          f"pipeline-{model}-{prec}-{backend.value}")


def test_pipeline_skip_connections(rng):
    """U-Net's long skip concats cross stage boundaries."""
    kw = dict(h=32, w=32, base_filters=4, depth=2)
    x = rng.random((2, 32, 32, 1), dtype=np.float32)
    pipe = PipelinedEngine(P.build_model("unet", **kw), P.EngineOptions(device="cpu"),
                           devices=[CPU] * 4, micro_batch=1)
    assert any(set(s.consumes) - {n.name for n in pipe.stages[s.index - 1].nodes}
               for s in pipe.stages[1:]), "no value skips a stage"
    got = pipe.run({"input": x})["head"].numpy()
    single = P.Engine.from_graph(P.build_model("unet", **kw),
                                 P.EngineOptions(batch_size=2, device="cpu")).run_single(x)
    jpipe = JPipelined(jbuild("unet", **kw), JOptions(), num_stages=4, micro_batch=1)
    _held(got, jpipe, single.numpy(), x, "input", "head", "fp32", "pipeline-unet-skips")


@pytest.mark.parametrize("groups,micro_batch", [([2, 2, 2, 2], 2), ([2, 2], 4), ([1, 2, 4], 4)])
def test_pipeline_dp_submesh(rng, groups, micro_batch):
    """PP x DP: each stage a data-only sub-mesh. Params are shared by the
    shards of a group on one device (the counterpart of JAX's replicated
    P() sharding), micro-batches split over the group by rows, and values
    crossing stages are re-laid where the groups differ."""
    import jax

    batch = 8
    x = rng.random((batch, 16, 24, 1), dtype=np.float32)
    pipe = PipelinedEngine(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"),
                           devices=[[CPU] * n if n > 1 else CPU for n in groups],
                           micro_batch=micro_batch)
    for s, n in zip(pipe.stages, groups):
        assert (s.mesh.size if n > 1 else 1) == n == len(s.steps)
        assert all(st is s.steps[0] for st in s.steps)  # one params set per device
    got = pipe.run({"input": x})
    # The JAX pipeline takes all-group or all-device entries; its output
    # does not depend on the placement.
    devs = jax.devices()
    starts = np.cumsum([0] + groups)
    jgroups = ([list(devs[a:b]) for a, b in zip(starts, starts[1:])] if min(groups) > 1
               else devs[:len(groups)])
    single = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                                 P.EngineOptions(batch_size=batch, device="cpu")).run_single(x)
    name = pipe.graph.output_names[0]
    jpipe = JPipelined(jbuild("espcn", h=16, w=24), JOptions(), devices=jgroups,
                       micro_batch=micro_batch)
    _held(got[name].numpy(), jpipe, single.numpy(), x, "input", name, "fp32", "pipeline-dp")


def test_indivisible_micro_batch_raises(rng):
    with pytest.raises(ValueError, match="not divisible"):
        PipelinedEngine(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"),
                        devices=[[CPU] * 2] * 2, micro_batch=3)
    pipe = PipelinedEngine(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"),
                           devices=[CPU] * 2, micro_batch=2)
    with pytest.raises(ValueError, match="multiple of micro_batch"):
        pipe.run({"input": rng.random((3, 16, 24, 1), dtype=np.float32)})


def test_devices_default_to_cuda():
    """No CUDA device: the default options raise, and a CPU engine given no
    devices does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.fail("these tests run on the CPU")
    with pytest.raises(RuntimeError, match="cuda"):
        PipelinedEngine(P.build_model("espcn", h=16, w=24))
    with pytest.raises(ValueError, match="0 device entries"):
        PipelinedEngine(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"))


def test_throughput_stats_keys(rng):
    """The JAX keys and formulas. On the CPU the stages run in order on one
    thread: no out-of-order step."""
    x = rng.random((8, 32, 48, 1), dtype=np.float32)
    eng = PipelinedEngine(P.build_model("espcn", h=32, w=48), P.EngineOptions(device="cpu"),
                          devices=[CPU] * 2, micro_batch=2)
    stats = eng.throughput_stats({"input": x}, iters=2)
    jeng = JPipelined(jbuild("espcn", h=32, w=48), JOptions(), num_stages=2, micro_batch=2)
    assert sorted(stats) == sorted(jeng.throughput_stats({"input": x}, iters=1))
    assert stats["stages"] == 2 and stats["micro_batches"] == 4
    assert stats["pipelined_s"] > 0 and stats["serial_s"] > 0 and stats["dispatch_s"] > 0
    assert stats["bubble_fraction_model"] == round(1 / 5, 4)
    assert stats["overlap_efficiency"] == pytest.approx(stats["speedup"] / 2, abs=1e-3)
    assert stats["schedule_inversions"] == 0


def test_kernel_operands_prepared_once(rng, monkeypatch):
    """A kernel node's operands are folded once, when the stage is built:
    no micro-batch folds them again."""
    from shadernn_tpu_torch.kernels import conv_igemm

    pipe = PipelinedEngine(P.build_model("espcn", h=16, w=24), P.EngineOptions(device="cpu"),
                           devices=[CPU] * 4, micro_batch=1)
    kernel = [(node.name, ctx) for s in pipe.stages for node, _view, ctx in s.steps[0]
              if ctx.backend == BackendKind.KERNEL]
    assert [n for n, _ in kernel] == ["conv_1", "conv_2", "conv_3"]
    assert all(ctx.operands is not None for _, ctx in kernel)
    calls = []
    real = conv_igemm.folded_operands
    monkeypatch.setattr(conv_igemm, "folded_operands",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pipe.run({"input": rng.random((4, 16, 24, 1), dtype=np.float32)})
    assert calls == []


def test_dryrun_runs_both_halves():
    from shadernn_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, [CPU] * 8)
    assert out["tp_sharded"] >= 1 and out["halo_conv"] >= 1
    stats = out["pipeline"]
    assert stats["stages"] == 4 and stats["micro_batches"] == 8
    assert stats["schedule_inversions"] == 0
