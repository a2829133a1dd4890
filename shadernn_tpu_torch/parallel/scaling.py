"""Scaling harness: frames/s against the number of shards (counterpart of
shadernn_tpu/parallel/scaling.py).

`measure_scaling` runs the same engine step data-parallel over n shards
for each n and reports throughput and efficiency against one shard. On a
host with n GPUs that is scaling; on a logical mesh (one device named n
times, `devices=[torch.device("cuda", 0)] * 8`) the shards run one after
another on that device, and the records measure the executor's overhead
per shard, not scaling. `run_multihost_smoke` spawns the multi-process
worker of parallel/multihost.py.

CLI:  python -m shadernn_tpu_torch.parallel.scaling --model espcn --devices 1,2,4,8
      [--logical] [--device cpu]
      python -m shadernn_tpu_torch.parallel.scaling --multihost [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision, ShardingOptions
from shadernn_tpu_torch.engine.engine import Engine
from shadernn_tpu_torch.models.zoo import build_model
from shadernn_tpu_torch.parallel.mesh import cuda_devices, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure_scaling(
    model_name: str = "espcn",
    device_counts: Sequence[int] = (1, 2, 4, 8),
    per_device_batch: int = 2,
    precision: Precision = Precision.BF16,
    backend: BackendKind = BackendKind.AUTO,
    iters: int = 10,
    build_kwargs: Optional[dict] = None,
    devices: Optional[Sequence] = None,
) -> List[dict]:
    """Run the model DP-sharded over n shards for each n (stopping where
    `devices`, every CUDA device by default, runs out); one record per
    count with throughput and parallel efficiency. One shard runs the
    single-device engine."""
    build_kwargs = build_kwargs or {}
    devices = [torch.device(d) for d in (devices if devices is not None else cuda_devices())]
    results = []
    base_fps = None
    for n in device_counts:
        if n > len(devices):
            break
        batch = per_device_batch * n
        sharding = ShardingOptions(data=n)
        mesh = make_mesh(sharding, devices[:n]) if n > 1 else None
        graph = build_model(model_name, **build_kwargs)
        options = EngineOptions(precision=precision, backend=backend, batch_size=batch,
                                sharding=sharding, device=devices[0].type)
        eng = Engine.from_graph(graph, options, mesh=mesh)
        spec = graph.nodes[graph.input_names[0]].out_spec
        x = np.random.default_rng(0).random((batch, *spec.shape[1:]), dtype=np.float32)
        stats = eng.device_benchmark({graph.input_names[0]: x}, iters=iters)
        fps = stats["frames_per_sec"]
        if base_fps is None:
            base_fps = fps
        results.append({
            "devices": n,
            "batch": batch,
            "mean_ms": stats["mean_ms"],
            "frames_per_sec": fps,
            "speedup": fps / base_fps,
            "efficiency": fps / (base_fps * n),
        })
    return results


def run_multihost_smoke(nproc: int = 2, device: str = "cuda", mode: str = "dp",
                        timeout: float = 120.0) -> int:
    """Spawn `nproc` processes of the multihost worker (gloo carrying only
    control) on `device` and wait for them, at most `timeout` seconds;
    prints one JSON line and returns a shell exit code. Every process is
    stopped before this returns."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "shadernn_tpu_torch.parallel.multihost",
             str(pid), str(nproc), str(port), mode, device],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(nproc)
    ]
    outs, rcs = [], []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            rcs.append(p.returncode)
    except subprocess.TimeoutExpired:
        rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = len(outs) == nproc and all(
        rc == 0 and f"MULTIHOST_OK pid={pid} procs={nproc}" in out
        for pid, (rc, out) in enumerate(zip(rcs, outs)))
    for pid, out in enumerate(outs):
        if not ok:
            sys.stderr.write(f"--- process {pid} ---\n{out[-3000:]}\n")
    print(json.dumps({"multihost_smoke": "ok" if ok else "FAILED", "processes": nproc,
                      "mode": mode, "device": device,
                      "lines": [ln for out in outs for ln in out.splitlines()
                                if ln.startswith("MULTIHOST_OK")]}), flush=True)
    return 0 if ok else (max(rcs) or 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="espcn")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--per-device-batch", type=int, default=2)
    ap.add_argument("--precision", default="bf16", choices=["fp32", "bf16", "int8"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--logical", action="store_true",
                    help="shards on one device named n times (the executor's overhead)")
    ap.add_argument("--multihost", action="store_true",
                    help="run the 2-process smoke instead")
    args = ap.parse_args(argv)
    if args.multihost:
        return run_multihost_smoke(2, args.device)
    prec = {"fp32": Precision.FP32, "bf16": Precision.BF16, "int8": Precision.INT8}[args.precision]
    counts = [int(x) for x in args.devices.split(",")]
    devices = None  # every CUDA device
    if args.device == "cpu" or args.logical:
        if args.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("--logical on cuda, but no CUDA device is available")
        one = torch.device("cpu") if args.device == "cpu" else cuda_devices()[0]
        devices = [one] * max(counts)
    for r in measure_scaling(args.model, counts, args.per_device_batch, prec,
                             iters=args.iters, devices=devices):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
