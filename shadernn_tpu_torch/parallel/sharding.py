"""Sharding rules and the choice of executor (counterpart of
shadernn_tpu/parallel/sharding.py).

- **DP**: input frames split on the batch axis.
- **TP**: conv/dense weights split on the output-channel axis, and
  activations on C (ShaderNN's per-pass MRT channel chunking lifted from
  "passes on one GPU" to "devices in a mesh").
- **SP**: activations split on H, with halo exchange for the convs.

`shard_compiled` dispatches on `EngineOptions.spmd_mode`. "shard_map" is
the explicit executor of parallel/spmd.py with the kernels kept on every
shard. The JAX package's "gspmd" hands the graph to XLA's
auto-partitioner; PyTorch has none in one process, so here "gspmd" runs
the same explicit executor under the two restrictions that GSPMD puts on
the JAX result: no kernels (TORCH on every shard) and no TP while the
spatial axis is active (`sharding_plan`'s rule).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from shadernn_tpu_torch.config import EngineOptions, ShardingOptions
from shadernn_tpu_torch.graph.ir import Graph
from shadernn_tpu_torch.parallel.mesh import Mesh, P

# Weight tensors whose trailing axis is the conv/dense output channel and
# may be sharded along the model axis.
_OUT_CHANNEL_PARAMS = ("weight", "weight_q", "bias", "bn_gamma", "bn_beta",
                       "bn_mean", "bn_variance", "gamma", "beta", "mean", "variance")


def _divisible(dim: int, ways: int) -> bool:
    return ways > 1 and dim % ways == 0


def sharding_plan(graph: Graph, mesh: Mesh, opts: ShardingOptions) -> Dict[str, Dict[str, P]]:
    """PartitionSpec per param leaf under GSPMD's rules, keyed like the
    params. With the spatial axis active the weights stay replicated (TP
    off), as the JAX package must there."""
    plan: Dict[str, Dict[str, P]] = {}
    tp = 1 if opts.spatial > 1 else opts.model
    for n in graph.nodes.values():
        if not n.params:
            continue
        specs: Dict[str, P] = {}
        for k, v in n.params.items():
            v = np.asarray(v)
            spec = P()
            if (k in _OUT_CHANNEL_PARAMS or k == "weight_scale") and _divisible(v.shape[-1], tp):
                spec = P(*([None] * (v.ndim - 1) + [opts.model_axis]))
            specs[k] = spec
        plan[n.name] = specs
    return plan


def input_spec(shape, opts: ShardingOptions) -> P:
    """NHWC input frames: batch over data, H over spatial (C is not split:
    inputs have few channels)."""
    parts = [None] * len(shape)
    if opts.data > 1 and _divisible(shape[0], opts.data):
        parts[0] = opts.data_axis
    if len(shape) == 4 and _divisible(shape[1], opts.spatial):
        parts[1] = opts.spatial_axis
    return P(*parts)


def shard_compiled(graph: Graph, options: EngineOptions, params, mesh: Mesh):
    """A sharded CompiledModel of `graph` over `mesh` (`params`: numpy, as
    extract_params gives them), by `options.spmd_mode`."""
    from shadernn_tpu_torch.parallel.spmd import plan_spmd, shard_compiled_spmd

    if options.spmd_mode == "shard_map":
        return shard_compiled_spmd(graph, options, params, mesh)
    sh = options.sharding
    # GSPMD's restrictions: TP off under SP (the model axis then replicates
    # the work), and TORCH on every shard.
    plan_opts = (dataclasses.replace(options, sharding=dataclasses.replace(sh, model=1))
                 if sh.spatial > 1 else options)
    return shard_compiled_spmd(graph, options, params, mesh,
                               plan=plan_spmd(graph, plan_opts), use_kernels=False)
