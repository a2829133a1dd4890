"""The port's elastic execution (shadernn_tpu_torch/parallel/elastic.py)
against the JAX package's (every case of tests/test_elastic.py).

The JAX ElasticEngine runs on the conftest's eight forced CPU devices, the
port's on `[torch.device("cpu")] * n`, where a device's id is its position
in that list. Each case injects the same failure into both, and the port's
replayed output is held to the JAX engine's (0.01 at FP32, conftest) and,
as the JAX tests hold theirs, to its own failure-free output (1e-4). A
hung step is simulated as in the JAX tests: the step's waitable blocks in
the watchdog thread (on the card, chip_smoke.py queues a real device-side
sleep instead).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import oracle
from shadernn_tpu.config import EngineOptions as JOptions
from shadernn_tpu.config import ShardingOptions as JSharding
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.parallel.elastic import ElasticEngine as JElastic

import shadernn_tpu_torch as P
from shadernn_tpu_torch.config import ShardingOptions
from shadernn_tpu_torch.parallel.elastic import ElasticEngine, RuntimeWedged, StepTimeout

CPU = torch.device("cpu")
FP32 = 0.01  # tests/conftest.py


def _make(data=4, batch=4, n_devices=4, **kw):
    return ElasticEngine(
        lambda: P.build_model("espcn", h=16, w=24),
        P.EngineOptions(batch_size=batch, sharding=ShardingOptions(data=data), device="cpu"),
        devices=[CPU] * n_devices, **kw)


def _jmake(data=4, batch=4, **kw):
    return JElastic(lambda: jbuild("espcn", h=16, w=24),
                    JOptions(batch_size=batch, sharding=JSharding(data=data)), **kw)


def _out(ee, out):
    return np.asarray(out[ee.engine.graph.output_names[0]], np.float32)


def _jout(je, out):
    return np.asarray(out[je.engine.graph.output_names[0]], np.float32)


class Hang:
    """A step's waitable that blocks for `secs` (a hung device)."""

    def __init__(self, secs):
        self.secs = secs

    def synchronize(self):
        time.sleep(self.secs)


class Blocked:
    """A step's waitable that blocks until `release` is set (a hang that
    outlasts every deadline)."""

    def __init__(self, release):
        self.release = release

    def synchronize(self):
        self.release.wait()


def test_normal_operation():
    ee, je = _make(), _jmake()
    x = np.random.default_rng(0).random((4, 16, 24, 1), dtype=np.float32)
    got = _out(ee, ee.run({"input": x}))
    assert got.shape == (4, 32, 48, 1)
    assert ee.failures == 0 and ee.data_parallel_degree == 4
    assert ee.engine.model.mesh.size == 4
    oracle.compare(got, _jout(je, je.run({"input": x})), FP32, "elastic normal vs JAX")


def test_failure_shrinks_and_recovers(rng):
    ee, je = _make(), _jmake()
    x = rng.random((4, 16, 24, 1), dtype=np.float32)
    want = _out(ee, ee.run({"input": x}))
    ee.inject_failure(1)
    je.inject_failure(1)
    got = _out(ee, ee.run({"input": x}))
    jgot = _jout(je, je.run({"input": x}))
    assert ee.failures == 1 and ee.rebuilds == 1
    assert ee.data_parallel_degree == je.data_parallel_degree == 2  # halved
    np.testing.assert_allclose(got, want, atol=1e-4)
    oracle.compare(got, jgot, FP32, "replay vs JAX replay")


def test_double_failure_then_single_device(rng):
    ee, je = _make(), _jmake()
    x = rng.random((4, 16, 24, 1), dtype=np.float32)
    want = _out(ee, ee.run({"input": x}))
    ee.inject_failure(2)
    je.inject_failure(2)
    got = _out(ee, ee.run({"input": x}))
    jgot = _jout(je, je.run({"input": x}))
    assert ee.data_parallel_degree == je.data_parallel_degree == 1
    assert getattr(ee.engine.model, "mesh", None) is None  # a single-device engine
    np.testing.assert_allclose(got, want, atol=1e-4)
    oracle.compare(got, jgot, FP32, "single-device replay vs JAX")


def test_exhausted_rebuilds_raises(rng):
    for make in (_make, _jmake):
        ee = make(data=2, batch=2, max_rebuilds=1)
        ee.inject_failure(5)
        with pytest.raises(RuntimeError, match="injected device failure"):
            ee.run({"input": rng.random((2, 16, 24, 1), dtype=np.float32)})
        assert ee.rebuilds == 1


def test_failed_device_excluded_from_rebuild(rng):
    """A failure blaming a device excludes it: the rebuild never uses the
    dead entry and the DP degree fits the survivors (8 -> 7 -> dp 4)."""
    ee = _make(data=8, batch=8, n_devices=8)
    je = _jmake(data=8, batch=8)
    dead = 3
    x = rng.random((8, 16, 24, 1), dtype=np.float32)
    want = _out(ee, ee.run({"input": x}))
    ee.inject_failure(1, device=dead)
    je.inject_failure(1, device=jax.devices()[dead].id)
    got = _out(ee, ee.run({"input": x}))
    jgot = _jout(je, je.run({"input": x}))
    assert dead in ee.excluded_ids and ee.excluded_ids == je.excluded_ids
    assert ee.data_parallel_degree == je.data_parallel_degree == 4  # 7 survivors -> pow2
    assert dead not in ee.healthy_ids() and len(ee.healthy_devices()) == 7
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got.shape[0] == 8  # all 8 frames, re-bucketed onto the smaller engine
    oracle.compare(got, jgot, FP32, "excluded-device replay vs JAX")


def test_mark_failed_external_detector():
    ee = _make()
    ee.mark_failed(0)
    assert len(ee.healthy_devices()) == 3 and ee.healthy_ids() == [1, 2, 3]


def test_logical_entries_are_positions(rng):
    """A logical list names one device four times: each entry is its own
    id, and losing entry 3 leaves entries 0-2 (data 4 -> 2)."""
    ee = _make()
    ee.inject_failure(1, device=3)
    x = rng.random((4, 16, 24, 1), dtype=np.float32)
    ee.run({"input": x})
    assert ee.excluded_ids == {3} and ee.healthy_ids() == [0, 1, 2]
    assert ee.data_parallel_degree == 2 and ee.engine.model.mesh.size == 2
    ee.mark_failed(1)
    ee.mark_failed(2)
    ee.inject_failure(1)  # unattributed: one entry left, a single-device engine
    ee.run({"input": x})
    assert ee.data_parallel_degree == 1 and ee.healthy_ids() == [0]
    assert ee.engine.model.device == CPU


def test_devices_default_to_cuda():
    if torch.cuda.is_available():
        pytest.fail("these tests run on the CPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticEngine(lambda: P.build_model("espcn", h=16, w=24), P.EngineOptions())


def _warm(ee):
    """One real step: an engine's first step runs under the recovery
    deadline, later ones under the step's own."""
    ee.run({"input": np.zeros((ee._options.batch_size, 16, 24, 1), np.float32)})


def test_watchdog_times_out_hung_step(monkeypatch):
    ee = _make(data=1, batch=2)
    _warm(ee)
    ee.step_timeout_s = 0.05
    ee._max_rebuilds = 0  # surface the timeout instead of rebuilding
    monkeypatch.setattr(ee, "_step", lambda inputs: ({"y": None}, [Hang(1.0)]))
    with pytest.raises(StepTimeout):
        ee.run({"input": np.zeros((2, 16, 24, 1), np.float32)})
    assert ee.engine is None  # dropped: the next step builds anew
    assert len(ee._leaked) == 1


def test_midstream_recovery_completes_workload(rng):
    """Stream 6 batches; a device dies mid-stream; every frame of the
    workload still comes back (on the shrunk mesh) and stays correct."""
    ee, je = _make(), _jmake()
    frames = rng.random((24, 16, 24, 1), dtype=np.float32)
    ee.inject_failure(1, device=1)  # dies on batch 0
    je.inject_failure(1, device=jax.devices()[1].id)
    got = np.concatenate([_out(ee, ee.run({"input": frames[s:s + 4]})) for s in range(0, 24, 4)])
    jgot = np.concatenate([_jout(je, je.run({"input": frames[s:s + 4]}))
                           for s in range(0, 24, 4)])
    ref = _make()  # failure-free reference engine
    want = _out(ref, ref.run({"input": frames}))
    assert got.shape == want.shape == (24, 32, 48, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert ee.rebuilds == 1 and 1 in ee.excluded_ids
    oracle.compare(got, jgot, FP32, "mid-stream recovery vs JAX")


def test_timeout_recovery_probes_and_reaps_waiters(rng, monkeypatch):
    """A StepTimeout drops the engine and actively probes the devices (not
    just the message regex), the stuck waiter is tracked, and recovery
    completes on the healthy devices. Too many stuck waiters = fatal."""
    ee = _make(data=2, batch=2)
    _warm(ee)
    ee.step_timeout_s = 0.2  # the deadline covers the step's host work too
    real_step = ee._step
    calls = {"n": 0}

    def hang_once(inputs):
        calls["n"] += 1
        if calls["n"] == 1:
            return {"y": None}, [Hang(1.0)]
        return real_step(inputs)

    monkeypatch.setattr(ee, "_step", hang_once)
    probed = {"n": 0}
    orig_probe = ee._probe_devices
    monkeypatch.setattr(ee, "_probe_devices",
                        lambda: probed.__setitem__("n", probed["n"] + 1) or orig_probe())
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    out = ee.run({"input": x})
    assert probed["n"] == 1  # the timeout path probed the devices
    assert ee.rebuilds == 1 and ee.data_parallel_degree == 1  # unattributed: halved
    assert len(ee._leaked) <= 1  # stuck waiter tracked, not accumulated
    ref = _make(data=1, batch=2)
    np.testing.assert_allclose(_out(ee, out), _out(ref, ref.run({"input": x})), atol=1e-4)
    time.sleep(1.1)  # the stuck waiter returns: reaped on the next step
    ee.run({"input": x})
    assert ee._leaked == []

    # waiter-cap: exceeding MAX_LEAKED_WAITERS is fatal, not an endless loop
    ee2 = _make(data=1, batch=2)
    _warm(ee2)
    ee2.step_timeout_s = 0.01
    ee2._leaked = [type("T", (), {"is_alive": lambda self: True})()] * (
        ee2.MAX_LEAKED_WAITERS + 1
    )
    monkeypatch.setattr(ee2, "_step", lambda inputs: ({"y": None}, [Hang(0.5)]))
    with pytest.raises(RuntimeWedged, match="wedged"):
        ee2.run({"input": np.zeros((2, 16, 24, 1), np.float32)})


def test_probe_excludes_a_hung_device(monkeypatch):
    """A probe that hangs past its deadline excludes that entry."""
    ee = _make(data=2, batch=2)
    ee.step_timeout_s = 0.05
    real = ee._wait_with_deadline
    seen = []

    def slow_entry_2(fn, deadline):
        seen.append(deadline)
        if len(seen) == 3:  # the probe of entry 2
            return real(lambda: time.sleep(0.5), 0.05)
        return real(fn, deadline)

    monkeypatch.setattr(ee, "_wait_with_deadline", slow_entry_2)
    assert ee._probe_devices() is True
    assert ee.excluded_ids == {2} and seen[:2] == [5.0, 5.0]  # JAX's 5 s floor


def test_hung_rebuild_is_bounded(rng, monkeypatch):
    """A hang that outlasts every deadline, with the default max_rebuilds:
    the step times out and every rebuild blocks behind the hang (on the card
    its weight upload waits on the hung stream), so each rebuild times out
    under the recovery deadline and run() gives up instead of blocking. Once
    the hang ends the stuck threads return, and the next step completes."""
    release = threading.Event()
    builds = {"n": 0}

    def builder():
        builds["n"] += 1
        if builds["n"] > 1:
            release.wait()
        return P.build_model("espcn", h=16, w=24)

    ee = ElasticEngine(builder, P.EngineOptions(batch_size=2, device="cpu"), devices=[CPU])
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    want = _out(ee, ee.run({"input": x}))
    ee.step_timeout_s, ee.RECOVERY_DEADLINE_FLOOR_S = 0.05, 0.2
    real_step = ee._step
    calls = {"n": 0}

    def hang_once(inputs):
        calls["n"] += 1
        return ({"y": None}, [Blocked(release)]) if calls["n"] == 1 else real_step(inputs)

    monkeypatch.setattr(ee, "_step", hang_once)
    t0 = time.perf_counter()
    try:
        with pytest.raises((StepTimeout, RuntimeWedged)):
            ee.run({"input": x})
        gave_up_s = time.perf_counter() - t0
        assert ee.rebuilds == ee._max_rebuilds == 3 and ee.failures == 4
        assert builds["n"] == 4 and len(ee._leaked) == 4  # the step and three rebuilds
        assert ee.engine is None and ee.excluded_ids == set()  # the probes passed
        # the step's deadline and three rebuild deadlines, with room for the probes
        assert gave_up_s < 0.05 + 4 * 2 * 0.2 + 2.0, gave_up_s
    finally:
        release.set()
    for th in ee._leaked:
        th.join(10)
    assert not [th for th in ee._leaked if th.is_alive()]
    ee.step_timeout_s = 120.0
    np.testing.assert_allclose(_out(ee, ee.run({"input": x})), want, atol=1e-4)
    assert ee._leaked == []


def test_rebuild_runs_under_the_recovery_deadline(monkeypatch):
    """A rebuild and each engine's first step go through the watchdog at the
    step's deadline floored at 5 s, as the probe does; later steps at the
    step's own deadline."""
    ee = _make(data=2, batch=2)
    ee.step_timeout_s = 2.0
    seen = []
    real = ee._wait_with_deadline
    monkeypatch.setattr(ee, "_wait_with_deadline",
                        lambda fn, deadline: seen.append(deadline) or real(fn, deadline))
    x = np.zeros((2, 16, 24, 1), np.float32)
    ee.run({"input": x})
    ee.run({"input": x})
    ee.inject_failure(1)
    ee.run({"input": x})
    ee.run({"input": x})
    # first step, a step; the rebuild, then two buckets of one frame (the
    # unattributed failure halved the batch): the new engine's first step,
    # a step; two steps
    assert seen == [5.0, 2.0, 5.0, 5.0, 2.0, 2.0, 2.0]
    assert ee.rebuilds == 1 and ee.data_parallel_degree == 1


def test_engine_dispatch_matches_run(rng):
    """Engine.dispatch queues the step the elastic engine waits on: the same
    outputs as Engine.run, and no event on the CPU."""
    eng = P.Engine.from_graph(P.build_model("espcn", h=16, w=24),
                              P.EngineOptions(batch_size=2, device="cpu"))
    x = rng.random((2, 16, 24, 1), dtype=np.float32)
    outs, events = eng.dispatch({"input": x})
    assert events == []
    name = eng.graph.output_names[0]
    np.testing.assert_array_equal(outs[name].numpy(), eng.run({"input": x})[name].numpy())
    with pytest.raises(ValueError, match="compiled for"):
        eng.dispatch({"input": np.zeros((2, 8, 8, 1), np.float32)})
