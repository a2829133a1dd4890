"""Halo exchange for spatial partitioning (counterpart of
shadernn_tpu/parallel/halo.py).

A large frame is split along H over the shards of a spatial group; each
conv needs its neighbours' boundary rows (the receptive-field halo). The
JAX package sends them with `ppermute` inside `shard_map`; here one
process holds the group's shards as a list, in axis order, and a halo is a
copy of the neighbour's rows to the receiving shard's device.

- `halo_exchange(shards, halo_up, halo_dn, fill)`: every shard extended by
  its neighbours' rows; the edge shards receive `fill` (0, the conv's zero
  padding; max-pooling passes -inf).
- `halo_conv2d_shard(shards, w, pads, overlap)`: the spatially sharded
  stride-1 conv. With `overlap` each shard's interior rows are computed
  from its own rows alone and only the two thin border strips read the
  exchanged halos, the split the JAX package uses to overlap the
  collective with the interior conv.
- `make_halo_conv(mesh, axis_name, overlap)`: the same conv on a global
  tensor, split over the mesh's `axis_name` shards and put back together.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from shadernn_tpu_torch.ops.conv import conv2d_nhwc_f32

Tensors = List[torch.Tensor]


def _edge(x: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    return torch.full_like(x[:, :rows], fill)


def _from_upper(shards: Sequence[torch.Tensor], i: int, rows: int, fill: float):
    """The last `rows` rows of shard i-1 on shard i's device (`fill` for
    shard 0)."""
    x = shards[i]
    return shards[i - 1][:, -rows:].to(x.device) if i > 0 else _edge(x, rows, fill)


def _from_lower(shards: Sequence[torch.Tensor], i: int, rows: int, fill: float):
    """The first `rows` rows of shard i+1 on shard i's device (`fill` for
    the last shard)."""
    x = shards[i]
    return shards[i + 1][:, :rows].to(x.device) if i < len(shards) - 1 else _edge(x, rows, fill)


def halo_exchange(shards: Sequence[torch.Tensor], halo_up: int, halo_dn: int,
                  fill: float = 0.0) -> Tensors:
    """Each (N, H_local, W, C) shard of a spatial group, in axis order,
    extended to (N, halo_up + H_local + halo_dn, W, C) by its neighbours'
    boundary rows; rows from outside the frame take `fill`."""
    out = []
    for i, x in enumerate(shards):
        parts = [x]
        if halo_up > 0:
            parts.insert(0, _from_upper(shards, i, halo_up, fill))
        if halo_dn > 0:
            parts.append(_from_lower(shards, i, halo_dn, fill))
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else x)
    return out


def _local_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad_w: Tuple[int, int]):
    """VALID along H, the horizontal pads along W; float32 sums."""
    return conv2d_nhwc_f32(x, w, (0, 0) + tuple(pad_w), stride)


def halo_conv2d_shard(shards: Sequence[torch.Tensor],
                      w: Union[torch.Tensor, Sequence[torch.Tensor]], *,
                      pads: Tuple[int, int, int, int], overlap: bool = True) -> Tensors:
    """Spatially sharded stride-1 conv of a spatial group's shards (float32
    out, one per shard). `w` is one HWIO weight or one per shard (on its
    device). pads = (top, bottom, left, right) of the GLOBAL conv, with
    top + bottom == k - 1 (every same-padded conv): output row j of a shard
    reads rows [j, j + k) of (top halo | its rows | bottom halo)."""
    ws = list(w) if isinstance(w, (list, tuple)) else [w] * len(shards)
    k = ws[0].shape[0]
    pt, pb, pl, pr = pads
    assert pt + pb == k - 1, f"halo conv needs same-geometry pads, got {pads}"
    h_local = shards[0].shape[1]
    halo_up, halo_dn = pt, k - 1 - pt
    assert halo_up <= h_local and halo_dn <= h_local, "shard too thin for halo"
    n_int = h_local - k + 1
    if not overlap or n_int <= 0:
        # No interior to overlap with: exchange, then convolve.
        xh = halo_exchange(shards, halo_up, halo_dn)
        return [_local_conv(x, wi, 1, (pl, pr)) for x, wi in zip(xh, ws)]
    out = []
    for i, (x, wi) in enumerate(zip(shards, ws)):
        interior = _local_conv(x, wi, 1, (pl, pr))  # output rows [pt, pt + n_int)
        parts = []
        if halo_up:  # output rows [0, pt): the upper halo and the first k - 1 rows
            top = torch.cat([_from_upper(shards, i, halo_up, 0.0), x[:, :k - 1]], dim=1)
            parts.append(_local_conv(top, wi, 1, (pl, pr)))
        parts.append(interior)
        if halo_dn:  # output rows [pt + n_int, h_local): the last k - 1 rows and the lower halo
            bot = torch.cat([x[:, -(k - 1):], _from_lower(shards, i, halo_dn, 0.0)], dim=1)
            parts.append(_local_conv(bot, wi, 1, (pl, pr)))
        out.append(torch.cat(parts, dim=1))
    return out


def make_halo_conv(mesh, axis_name: str = "spatial", overlap: bool = True):
    """conv(x, w, pads) on a global NHWC `x`: split along H over the
    shards of `mesh` along `axis_name` (the first such group), each shard
    on its device, convolved with halo exchange, and put back together on
    the group's first device."""
    group = mesh.group(mesh.coords[0], axis_name)
    devices = [mesh.device_at(c) for c in group]

    def conv(x: torch.Tensor, w: torch.Tensor, pads: Tuple[int, int, int, int]):
        n = len(devices)
        if x.shape[1] % n:
            raise ValueError(f"H = {x.shape[1]} does not split over {n} shards")
        shards = [s.to(d) for s, d in zip(torch.chunk(x, n, dim=1), devices)]
        ws = [w.to(d) for d in devices]
        ys = halo_conv2d_shard(shards, ws, pads=tuple(pads), overlap=overlap)
        return torch.cat([y.to(devices[0]) for y in ys], dim=1)

    return conv
