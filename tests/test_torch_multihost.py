"""The port's SPMD plans and multi-process hosts against the JAX package.

Plans: `plan_spmd` of the port (shadernn_tpu_torch/parallel/spmd.py) must
equal the JAX package's node by node for every zoo builder under six
meshes, as must `sharding_plan` and `input_spec` (pure Python, fast).

Multi-process hosts: counterparts of tests/test_multihost.py. Two (dp) and
four (v5e16: 4 processes x 4 logical CPU devices, data 4 x model 2 x
spatial 2) real OS processes of `python -m
shadernn_tpu_torch.parallel.multihost` join a gloo group, build the
process-major mesh, run one sharded ESPCN step on their own shards and
check them against the single-device engine. Each subprocess has its own
time limit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from shadernn_tpu.config import EngineOptions as JOptions
from shadernn_tpu.config import ShardingOptions as JSharding
from shadernn_tpu.graph import fusion as jfusion
from shadernn_tpu.models import build_model as jbuild
from shadernn_tpu.parallel.sharding import input_spec as j_input_spec
from shadernn_tpu.parallel.sharding import sharding_plan as j_sharding_plan
from shadernn_tpu.parallel.spmd import plan_spmd as j_plan_spmd

from shadernn_tpu_torch.config import EngineOptions, ShardingOptions
from shadernn_tpu_torch.graph import fusion as pfusion
from shadernn_tpu_torch.models.zoo import build_model as pbuild
from shadernn_tpu_torch.parallel.mesh import P, make_mesh
from shadernn_tpu_torch.parallel.sharding import input_spec, sharding_plan
from shadernn_tpu_torch.parallel.spmd import plan_spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT = 120  # seconds, per subprocess

# Every zoo builder at a small size whose H divides the meshes' spatial
# counts, so that halos, gathers and re-splits all show up.
ZOO = {
    "espcn": dict(h=32, w=32),
    "mobilenetv2": dict(h=64, w=64),
    "resnet18": dict(),
    "unet": dict(h=64, w=64, base_filters=8, depth=3),
    "styletransfer": dict(h=64, w=48),
    "styletransfer-candy": dict(h=64, w=48),
    "yolov3-tiny": dict(h=128, w=128),
    "spatialdenoise": dict(h=32, w=48),
    "aidenoise": dict(h=32, w=48),
}
MESHES = [(2, 2, 2), (1, 2, 4), (2, 4, 1), (1, 1, 4), (1, 1, 2), (2, 1, 1)]
BATCH = 4


def _graphs(name):
    jg, pg = jbuild(name, **ZOO[name]), pbuild(name, **ZOO[name])
    jfusion.optimize(jg)
    pfusion.optimize(pg)
    jg.infer_shapes(batch_size=BATCH)
    pg.infer_shapes(batch_size=BATCH)
    return jg, pg


def _specs(d):
    return {k: (tuple(v) if not isinstance(v, dict) else _specs(v)) for k, v in d.items()}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", list(ZOO))
def test_plan_equals_jax(name, mesh):
    d, m, s = mesh
    jg, pg = _graphs(name)
    jsh, psh = JSharding(data=d, model=m, spatial=s), ShardingOptions(data=d, model=m, spatial=s)
    jp = j_plan_spmd(jg, JOptions(batch_size=BATCH, sharding=jsh))
    pp = plan_spmd(pg, EngineOptions(batch_size=BATCH, sharding=psh, device="cpu"))
    assert list(pp.nodes) == list(jp.nodes)
    for n, jn in jp.nodes.items():
        pn = pp.nodes[n]
        assert (pn.mode, pn.tp, pn.halo_up, pn.halo_dn, pn.resplit, pn.gather_inputs) == (
            jn.mode, jn.tp, jn.halo_up, jn.halo_dn, jn.resplit, jn.gather_inputs), n
    assert pp.out_state == jp.out_state
    assert _specs(pp.param_specs) == _specs(jp.param_specs)
    assert _specs(pp.input_specs) == _specs(jp.input_specs)
    assert _specs(pp.output_specs) == _specs(jp.output_specs)
    assert pp.summary() == jp.summary()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_sharding_plan_and_input_spec_equal_jax(mesh):
    d, m, s = mesh
    for name in ("espcn", "mobilenetv2", "styletransfer"):
        jg, pg = _graphs(name)
        jsh = JSharding(data=d, model=m, spatial=s)
        psh = ShardingOptions(data=d, model=m, spatial=s)
        pm = make_mesh(psh, [CPU] * (d * m * s))
        assert _specs(sharding_plan(pg, pm, psh)) == _specs(j_sharding_plan(jg, None, jsh))
        for shape in ((BATCH, 32, 32, 1), (3, 16, 16, 3), (BATCH, 30, 8, 2), (BATCH, 10)):
            assert tuple(input_spec(shape, psh)) == tuple(j_input_spec(shape, jsh)), shape


def test_partition_spec_is_a_tuple():
    from jax.sharding import PartitionSpec as JP

    assert P() == () and P(None, "model") == (None, "model")
    assert tuple(P(None, None, None, "model")) == tuple(JP(None, None, None, "model"))
    assert repr(P("data")) == "P('data',)"


# ---------------------------------------------------------------------------
# Multi-process hosts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(nproc, mode):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "shadernn_tpu_torch.parallel.multihost",
             str(pid), str(nproc), str(port), mode, "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO, text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid} procs={nproc}" in out, out[-2000:]
    return outs


def test_two_process_dp_smoke():
    outs = _spawn(2, "dp")
    # 2 processes x 2 logical devices: data = 4, each process checks 2 shards.
    assert all("devices=4 local=2 kind=cpu" in o for o in outs), outs


def test_v5e16_shaped_4x4():
    outs = _spawn(4, "v5e16")
    assert all("devices=16 local=4 kind=cpu" in o for o in outs), outs


def test_multihost_mesh_requires_local_model_axes():
    from shadernn_tpu_torch.parallel.multihost import make_multihost_mesh

    n = 4
    mesh = make_multihost_mesh(ShardingOptions(data=n), [CPU] * n)
    assert mesh.devices.shape == (n, 1, 1)
    assert mesh.local_coords == mesh.coords
    with pytest.raises(ValueError, match="host boundary"):
        make_multihost_mesh(ShardingOptions(model=2 * n), [CPU] * n)


def test_host_local_inputs_single_process_passthrough():
    from shadernn_tpu_torch.parallel.multihost import host_local_inputs, make_multihost_mesh

    mesh = make_multihost_mesh(ShardingOptions(data=2), [CPU] * 2)
    x = np.arange(2 * 4 * 4 * 1, dtype=np.float32).reshape(2, 4, 4, 1)
    shards = host_local_inputs(mesh, {"input": P("data", None, None, None)}, {"input": x})
    assert len(shards) == 2
    got = torch.cat([s["input"] for s in shards], dim=0)
    assert tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), x)
    assert all(s["input"].shape[0] == 1 for s in shards)


def test_initialize_from_env_noop_without_coordinator(monkeypatch):
    for var in ("SNN_COORDINATOR", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    from shadernn_tpu_torch.parallel.multihost import initialize_from_env

    assert initialize_from_env() is False
