"""Multi-device dry run: one sharded engine step with DP, TP and SP all
active (counterpart of the SPMD half of the JAX package's
`dryrun_multichip`).

    python -m shadernn_tpu_torch.parallel.dryrun 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _factor3(n: int):
    """Split n into (data, model, spatial) factors, preferring balance."""
    best = (n, 1, 1)
    for d in range(1, n + 1):
        if n % d:
            continue
        rem = n // d
        for m in range(1, rem + 1):
            if rem % m:
                continue
            s = rem // m
            cand = (d, m, s)
            if max(cand) < max(best) or (max(cand) == max(best) and sorted(cand) > sorted(best)):
                best = cand
    return best


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Build a tiny ESPCN engine over an n_devices mesh (`devices`, every
    CUDA device by default) with DP (batch), TP (conv output channels,
    active together with SP) and SP (H with halo exchange), and run one
    step. Asserts the params really carry the model axis and the convs
    really run in halo-exchange mode. Returns the plan's summary."""
    from shadernn_tpu_torch.config import EngineOptions, Precision, ShardingOptions
    from shadernn_tpu_torch.engine.engine import Engine
    from shadernn_tpu_torch.models.zoo import build_model
    from shadernn_tpu_torch.parallel.mesh import make_mesh

    d, m, s = _factor3(n_devices)
    sharding = ShardingOptions(data=d, model=m, spatial=s)
    mesh = make_mesh(sharding, devices=list(devices)[:n_devices] if devices is not None else None)

    # Tiny ESPCN: batch divisible by d, H divisible by s (and by the 2x
    # subpixel), channels 16 divisible by m for m in {1, 2, 4, 8}.
    batch = max(d, 1) * 2
    h = 16 * max(s, 1)
    graph = build_model("espcn", h=h, w=32)
    options = EngineOptions(precision=Precision.BF16, batch_size=batch, sharding=sharding,
                            device=mesh.device_type)
    eng = Engine.from_graph(graph, options, mesh=mesh)
    plan = eng.model.spmd_plan
    summary = plan.summary()
    if m > 1:
        assert summary["tp_sharded"] >= 1, summary
        full = {n: {k: tuple(v.shape) for k, v in d_.items()}
                for n, d_ in eng.model.params[0].items()}
        assert any(tuple(graph.nodes[n].params[k].shape) != shape
                   for n, d_ in full.items() for k, shape in d_.items()), \
            "no param sharded on the model axis"
    if s > 1:
        assert summary.get("halo_conv", 0) >= 1, summary
    x = np.random.default_rng(0).random((batch, h, 32, 1), dtype=np.float32)
    y = eng.run_single(x)
    assert tuple(y.shape) == (batch, 2 * h, 64, 1), y.shape
    assert bool(torch.isfinite(y).all())
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: a logical mesh of the CPU named n times")
    args = ap.parse_args(argv)
    devices = [torch.device("cpu")] * args.n_devices if args.device == "cpu" else None
    print(dryrun_multichip(args.n_devices, devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
