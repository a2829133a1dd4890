"""Multi-process hosts (counterpart of shadernn_tpu/parallel/multihost.py).

Every process of a job runs the same program over one global
(data, model, spatial) mesh. The layout rule is the JAX package's: the
`data` axis is laid process-major, so a process owns whole rows of it and
every model/spatial group lies inside one process (`make_multihost_mesh`
checks it). An inference step needs no collective along `data`, so each
process runs its own shards, on its own devices, from its own frames
(`host_local_inputs`), and nothing of the step crosses a process
boundary; `torch.distributed` (a gloo group over TCP) carries only
control: the rendezvous, the device counts, the barrier and the results.

Launch (one command per host):

  SNN_COORDINATOR=host0:8476 SNN_NUM_PROCESSES=4 SNN_PROCESS_ID=$i \\
      python your_serving_entry.py

with `initialize_from_env()` at the top of the entry (the standard
MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK work too), then
`make_multihost_mesh(ShardingOptions(data=4, model=2, spatial=2))` and the
regular Engine API with `mesh=`.

The smoke worker `python -m shadernn_tpu_torch.parallel.multihost <pid>
<nproc> <port> [dp|v5e16] [cpu|cuda]` runs one sharded ESPCN step per
process and checks its shards against the single-device engine
(parallel/scaling.py run_multihost_smoke spawns it).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from shadernn_tpu_torch.config import ShardingOptions
from shadernn_tpu_torch.parallel.mesh import Mesh, as_device, cuda_devices
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.multihost")


def initialize_from_env() -> bool:
    """`initialize` from SNN_COORDINATOR / SNN_NUM_PROCESSES /
    SNN_PROCESS_ID, or from MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK.
    Returns True if a multi-process group was set up, False without a
    coordinator (the single-process case)."""
    coord = os.environ.get("SNN_COORDINATOR")
    if not coord and os.environ.get("MASTER_ADDR"):
        coord = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not coord:
        return False
    nproc = os.environ.get("SNN_NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
    pid = os.environ.get("SNN_PROCESS_ID") or os.environ.get("RANK")
    if nproc is None or pid is None:
        raise ValueError("a coordinator needs the process count and this process's index")
    initialize(coord, int(nproc), int(pid))
    return process_count() > 1


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the job: a gloo process group over TCP at `coordinator_address`
    (host:port; process 0 listens there)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    logger.info("multihost: process %d/%d", process_index(), process_count())


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def make_multihost_mesh(sharding: ShardingOptions,
                        local_devices: Optional[Sequence] = None) -> Mesh:
    """The global (data, model, spatial) mesh with `data` process-major:
    process p's devices (`local_devices`, every CUDA device by default; a
    device may be named more than once) fill its rows of the data axis.
    Every process must pass as many. Requires model*spatial to divide one
    process's device count, so that no model/spatial group straddles a
    process boundary; raises ValueError otherwise."""
    local = [as_device(d) for d in (local_devices if local_devices is not None
                                    else cuda_devices())]
    nproc = process_count()
    if nproc > 1:
        import torch.distributed as dist

        counts: List[Optional[int]] = [None] * nproc
        dist.all_gather_object(counts, len(local))
        if len(set(counts)) != 1:
            raise ValueError(f"processes hold different device counts {counts}")
    fixed = sharding.model * sharding.spatial
    if fixed > len(local) or len(local) % fixed != 0:
        raise ValueError(
            f"model*spatial = {fixed} must evenly divide the per-host device "
            f"count {len(local)}: otherwise a model/spatial group straddles a "
            "host boundary and its collectives cross hosts. Put host-spanning "
            "parallelism on the data axis."
        )
    n = sharding.total_devices
    if n > len(local) * nproc:
        raise ValueError(f"sharding wants {n} devices, only {len(local) * nproc} available")
    pid = process_index()
    devices = np.empty(n, dtype=object)
    owners = np.empty(n, dtype=np.int64)
    for g in range(n):
        p, j = divmod(g, len(local))
        # Another process's device: named as it is here (the grid keeps
        # only its owner; this process never runs its shards).
        devices[g] = local[j]
        owners[g] = p
    shape = (sharding.data, sharding.model, sharding.spatial)
    return Mesh(devices.reshape(shape),
                (sharding.data_axis, sharding.model_axis, sharding.spatial_axis),
                owners=owners.reshape(shape), process_index=pid)


def host_local_inputs(mesh: Mesh, input_specs: Dict[str, Sequence],
                      local: Dict[str, np.ndarray]) -> List:
    """Per-host ingest: this process's frames (`local`: input name -> its
    slice of the global batch, the data rows it owns) as the per-shard
    inputs a sharded step takes (ShardedModel.step), each on its shard's
    device; None at the shards other processes own."""
    from shadernn_tpu_torch.parallel.mesh import shard_index

    data_axis = mesh.axis_names[0]
    rows = sorted({mesh.axis_index(c, data_axis) for c in mesh.local_coords})
    out: List = []
    for coord in mesh.coords:
        if not mesh.is_local(coord):
            out.append(None)
            continue
        shard = {}
        for name, arr in local.items():
            t = torch.as_tensor(np.asarray(arr))
            spec = tuple(input_specs[name])
            if spec and spec[0] == data_axis:
                # The local batch holds this process's rows, in order.
                per = t.shape[0] // len(rows)
                r = rows.index(mesh.axis_index(coord, data_axis))
                t = t[r * per:(r + 1) * per]
                spec = (None,) + spec[1:]
            shard[name] = t[shard_index(spec, mesh, coord, tuple(t.shape))].to(
                mesh.device_at(coord))
        out.append(shard)
    return out


# ---------------------------------------------------------------------------
# Smoke worker: `python -m shadernn_tpu_torch.parallel.multihost <pid> <nproc>
# <port> [dp|v5e16] [cpu|cuda]` (spawned by parallel/scaling.py
# run_multihost_smoke and the tests).


def _local_devices(kind: str, n: int) -> List[torch.device]:
    """`n` devices for one process: logical CPU devices, or the CUDA
    devices in turn (one card named n times on a one-GPU host)."""
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is available")
    cuda = cuda_devices()
    return [cuda[i % len(cuda)] for i in range(n)]


def _worker(argv) -> None:
    import torch.distributed as dist

    from shadernn_tpu_torch.config import EngineOptions, Precision
    from shadernn_tpu_torch.engine.engine import Engine
    from shadernn_tpu_torch.models.zoo import build_model
    from shadernn_tpu_torch.parallel.mesh import shard_index

    pid, nproc = int(argv[0]), int(argv[1])
    port = argv[2] if len(argv) > 2 else "29411"
    mode = argv[3] if len(argv) > 3 else "dp"
    kind = argv[4] if len(argv) > 4 else "cuda"
    initialize(f"127.0.0.1:{port}", nproc, pid)

    if mode == "v5e16":
        # 4 hosts x 4 devices: data = 4 across hosts, model x spatial = 2 x 2
        # inside each. Only data-axis work may cross a process boundary.
        assert nproc == 4, nproc
        local_devs = _local_devices(kind, 4)
        sharding = ShardingOptions(data=4, model=2, spatial=2)
        mesh = make_multihost_mesh(sharding, local_devs)
        assert mesh.devices.shape == (4, 2, 2)
        for di in range(4):
            owners = {int(o) for o in mesh.owners[di].flat}
            assert len(owners) == 1, (
                f"data-slice {di} spans processes {owners}: model/spatial "
                "collectives would cross hosts")
    else:
        local_devs = _local_devices(kind, 2)
        sharding = ShardingOptions(data=nproc * len(local_devs))  # DP across hosts
        mesh = make_multihost_mesh(sharding, local_devs)
        assert mesh.devices.shape == (nproc * len(local_devs), 1, 1)
    assert all(int(mesh.owners[c]) == pid for c in mesh.local_coords)

    per_host = mesh.shape["data"] // nproc  # 1 frame per data row
    options = EngineOptions(batch_size=per_host * nproc, precision=Precision.FP32,
                            sharding=sharding, device=kind)
    eng = Engine.from_graph(build_model("espcn", h=64, w=64), options, mesh=mesh)
    cm = eng.model
    g = cm.graph
    spec = cm.spmd_plan.input_specs["input"]
    assert spec[0] is not None, f"DP axis missing from input spec {spec}"

    rng = np.random.default_rng(0)  # same seed everywhere: the global batch
    x_global = rng.random((per_host * nproc, 64, 64, 1), dtype=np.float32)
    lo = pid * per_host
    inputs = host_local_inputs(mesh, cm.spmd_plan.input_specs,
                               {"input": x_global[lo:lo + per_host]})
    outs = cm.step(cm.params, inputs)
    eng._sync()

    # Every process checks its shards against the single-device engine for
    # those frames.
    ref = Engine.from_graph(build_model("espcn", h=64, w=64),
                            EngineOptions(batch_size=per_host * nproc,
                                          precision=Precision.FP32, device=kind))
    want = ref.run_single(x_global).cpu().numpy()
    out_spec = cm.spmd_plan.output_specs[g.output_names[0]]
    checked, worst = 0, 0.0
    for coord, o in zip(mesh.coords, outs):
        if o is None:
            continue
        got = o[g.output_names[0]].cpu().numpy()
        ref_part = want[shard_index(out_spec, mesh, coord, want.shape)]
        worst = max(worst, float(np.abs(got - ref_part).max()))
        # FP32: summation order only (the engines' FP32 tolerance).
        np.testing.assert_allclose(got, ref_part, rtol=1e-4, atol=1e-4)
        checked += 1
    ok = torch.tensor([checked])
    dist.all_reduce(ok)  # control only: how many shards the job checked
    assert int(ok) == mesh.size, (int(ok), mesh.size)
    dist.barrier()
    print(f"MULTIHOST_OK pid={pid} procs={process_count()} devices={mesh.size} "
          f"local={len(mesh.local_coords)} kind={kind} max_abs_diff={worst:.3e}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    _worker(sys.argv[1:])
