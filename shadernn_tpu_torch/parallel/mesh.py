"""Device meshes (counterpart of shadernn_tpu/parallel/mesh.py).

A `Mesh` is a (data, model, spatial) grid of `torch.device`s driven by one
process, as the JAX package's mesh is driven by one controller:

  data    batch/frame parallelism
  model   channel (tensor) parallelism: conv output channels sharded
  spatial H partitioning with halo exchange

A caller may name one device more than once. Such a logical mesh runs
every shard on that device, and its collectives become plain tensor
copies; this is how a sharded step runs on a host with one GPU, and how
the tests run on the CPU. On a host with several GPUs the shards sit on
cuda:0..n-1 and the collectives are peer copies.

Under multi-process hosts (parallel/multihost.py) each grid entry also has
an owning process: a process runs only the shards it owns, and only the
data axis crosses a process boundary.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from shadernn_tpu_torch.config import ShardingOptions

AXES = ("data", "model", "spatial")
Coord = Tuple[int, int, int]


class PartitionSpec(tuple):
    """Per-dimension mesh axis name (or None) of a tensor, as JAX's
    `PartitionSpec`: `P(None, "model")` cuts the trailing axis over
    `model`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A (data, model, spatial) grid of devices. `owners` holds the process
    that runs each entry (None: this process runs them all)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXES,
                 owners: Optional[np.ndarray] = None, process_index: int = 0):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 3 or len(axis_names) != 3:
            raise ValueError(f"a mesh is a (data, model, spatial) grid, got shape "
                             f"{devices.shape} and axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = owners
        self.process_index = process_index

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def coords(self) -> List[Coord]:
        """Every grid position, row-major (the shards' order)."""
        return list(itertools.product(*(range(n) for n in self.devices.shape)))

    def device_at(self, coord: Coord) -> torch.device:
        return self.devices[coord]

    def axis_index(self, coord: Coord, axis: str) -> int:
        """The shard's index along `axis` (JAX's `lax.axis_index`)."""
        return coord[self.axis_names.index(axis)]

    def group(self, coord: Coord, axis: str) -> List[Coord]:
        """The shards along `axis` through `coord`, in axis order."""
        ax = self.axis_names.index(axis)
        return [coord[:ax] + (i,) + coord[ax + 1:] for i in range(self.devices.shape[ax])]

    def is_local(self, coord: Coord) -> bool:
        return self.owners is None or int(self.owners[coord]) == self.process_index

    @property
    def local_coords(self) -> List[Coord]:
        return [c for c in self.coords if self.is_local(c)]

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first shard: where a sharded engine
        assembles its outputs."""
        return self.device_at(self.local_coords[0])

    @property
    def device_type(self) -> str:
        return self.first_device.type

    @property
    def local_devices(self) -> List[torch.device]:
        """Each distinct device this process runs shards on."""
        out: List[torch.device] = []
        for c in self.local_coords:
            if self.device_at(c) not in out:
                out.append(self.device_at(c))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.local_devices]})"


def as_device(d) -> torch.device:
    """torch.device(d), a bare "cuda" given its index: a tensor's device
    always has one, and shards compare devices."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(sharding: Optional[ShardingOptions] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model, spatial) mesh over `devices` (every CUDA device by
    default; never the CPU unless named). Raises ValueError when there are
    fewer devices than the sharding wants. `data` is laid outermost."""
    sharding = sharding or ShardingOptions()
    devices = [as_device(d) for d in (devices if devices is not None else cuda_devices())]
    n = sharding.total_devices
    if n > len(devices):
        raise ValueError(
            f"sharding wants {n} devices ({sharding}), only {len(devices)} available"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(sharding.data, sharding.model, sharding.spatial),
                (sharding.data_axis, sharding.model_axis, sharding.spatial_axis))


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh(ShardingOptions(), [device])


def shard_index(spec: Sequence, mesh: Mesh, coord: Coord, shape: Sequence[int]) -> tuple:
    """The slices of a global tensor of `shape` that the shard at `coord`
    holds under `spec` (JAX's `shard.index`): a dimension named after a mesh
    axis is cut into that axis's size, the others are whole."""
    index = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            index.append(slice(None))
            continue
        ways = mesh.shape[axis]
        if size % ways:
            raise ValueError(f"dimension {dim} of size {size} does not split {ways} ways "
                             f"over {axis!r}")
        step = size // ways
        at = mesh.axis_index(coord, axis)
        index.append(slice(at * step, (at + 1) * step))
    return tuple(index)


def owns_slice(spec: Sequence, mesh: Mesh, coord: Coord) -> bool:
    """Is `coord` the first holder of its slice (index 0 along every mesh
    axis that `spec` does not name)? The replicas along the other axes
    hold the same values."""
    named = {a for a in spec if a is not None}
    return all(mesh.axis_index(coord, a) == 0 for a in mesh.axis_names if a not in named)
