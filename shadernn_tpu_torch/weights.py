"""Carry parameters across from the JAX package (or any numpy source).

`params_from_numpy` takes the dict that the JAX package's
`extract_params(graph)` (its engine/compile.py) returns — node name ->
{param name: numpy array}, conv weights HWIO — and returns the port's
tensors on `device`, ready for `CompiledModel.load_params`. The port keeps
HWIO at this boundary; only the convolutions convert it. Every array keeps
its dtype: int8 `weight_q` and float32 `weight_scale` arrive unchanged.

`shard_params` cuts such tensors onto the shards of a mesh by an SPMD
plan's partition specs (parallel/spmd.py).

`calibration_from_graph` copies the calibrated activation scales
(quant/calibrate.py: `act_scale`, `in_act_scale`) from another graph's
nodes, so that both packages plan and run int8 activations on one set of
scales.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch


def params_from_numpy(params: Dict[str, Dict[str, np.ndarray]], device) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        name: {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}
        for name, d in params.items()
    }


def shard_params(params: Dict[str, Dict[str, torch.Tensor]], plan, mesh) -> List:
    """Each shard's params, indexed like `mesh.coords` (None at the shards
    another process owns): every tensor cut by `plan.param_specs` (its
    output-channel axis over `model` where the plan says TP) and put on the
    shard's device. Shards on one device with the same slice share it."""
    from shadernn_tpu_torch.parallel.mesh import shard_index

    memo: dict = {}
    out: List = []
    for coord in mesh.coords:
        if not mesh.is_local(coord):
            out.append(None)
            continue
        dev = mesh.device_at(coord)
        shard = {}
        for name, d in params.items():
            specs = plan.param_specs.get(name, {})
            shard[name] = {}
            for k, v in d.items():
                index = shard_index(specs.get(k, ()), mesh, coord, tuple(v.shape))
                key = (dev, name, k, tuple((s.start, s.stop) for s in index))
                if key not in memo:
                    memo[key] = v[index].contiguous().to(dev)
                shard[name][k] = memo[key]
        out.append(shard)
    return out


CALIBRATION_ATTRS = ("act_scale", "in_act_scale")


def calibration_from_graph(src, dst, keys: Iterable[str] = CALIBRATION_ATTRS) -> int:
    """Copy the calibration attrs of `src`'s nodes (any graph whose `.nodes`
    maps names to nodes with `.attrs`, the JAX package's too) onto the
    nodes of `dst` with the same names, and `act_scales` of its meta.
    Returns the number of attrs copied."""
    count = 0
    for name, node in src.nodes.items():
        if name not in dst.nodes:
            continue
        for k in keys:
            if k in node.attrs:
                dst.nodes[name].attrs[k] = float(node.attrs[k])
                count += 1
    if "act_scales" in getattr(src, "meta", {}):
        dst.meta["act_scales"] = {k: float(v) for k, v in src.meta["act_scales"].items()}
    return count
