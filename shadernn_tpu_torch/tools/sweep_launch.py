"""Sweep the launch geometry of the float32 (3xTF32) forms of the block,
single-conv and chain kernels and of the implicit-GEMM conv kernel on the
card, the measurement behind `kernels/invres.py` `_f32_cost`, the f32
channel-block rule of `kernels/conv.py` `launch_geometry`,
`kernels/chain.py` `_f32_cost` and `kernels/conv_igemm.py`
`launch_geometry`:

    python -m shadernn_tpu_torch.tools.sweep_launch [--out FILE] [--only chain,igemm,wide]

For every block geometry of MobileNetV2 224 (b8) and the trained cls10
model (b64), every tile, split of E and buffer count that fits; for the
ResNet18 paths' single convs, the channel block, chunk, taps per stage and
tile; for the single-conv kernel's wide body at StyleTransfer's k9 stem and
head, the packing, buffers and grid (bf16) and its f32 form's grid; for the
FP32 chain plans (ESPCN 540p b8, the trained ResNet18's
16->16->16 at 32x32 b64), every tile, thread count and weight staging
that fits; for the implicit-GEMM conv at the two-input graph's shape and
the ResNet-wide shapes, bf16 and f32, the warp layout, tile, ring depth
and grid. Each configuration's device time per call from torch.profiler
(the device's own events over 10 calls, the median of three profiles),
one line each, then for each shape the time of the module's choice
against the sweep's best. Needs one CUDA card; speed only, the results
do not depend on the geometry.
"""

from __future__ import annotations

import argparse
import itertools
import sys


def device_ms(fn, reps: int = 10, profiles: int = 3) -> float:
    """Device time per call of fn: the profiler's device events over
    `reps` calls after one warm call, the median of `profiles` profiles
    (a profile now and then records no device event, or only some). 0.0
    where most recorded none."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA)
        readings.append(total / 1e3 / reps)
    return statistics.median(readings)


def _best(times):
    """The least time of a sweep, readings of 0.0 (no device event) left out."""
    return min(v for v in times.values() if v > 0)


def _blocks(graph, n, dev):
    import torch

    from shadernn_tpu_torch.graph import fusion
    from shadernn_tpu_torch.kernels import invres

    fusion.optimize(graph)
    graph.infer_shapes(batch_size=n)
    out = {}
    for node in graph.toposort():
        m = invres.match_invres_block(graph, node) if node.op == "SeparableConv2D" else None
        if m is None:
            continue
        head = m[0] if m[0] is not None else m[1]
        ops, spec = invres.build_invres(m, graph.nodes[head.inputs[0]].out_spec, torch.float32)
        key = (spec, n)
        if key not in out:
            out[key] = [invres.prepare_operands({k: v.to(dev) for k, v in ops.items()}, spec,
                                                torch.float32), 0]
        out[key][1] += 1  # the blocks of this geometry in a step
    return out


def _sweep_wide(dev, sms, rng, emit) -> None:
    """The single-conv kernel's wide body at StyleTransfer 512x512 b4's k9
    stem and head: at bf16 (the tensor cores) K packed or not (the stem),
    the 16x16 tile with one or two input buffers, and the grid of one wave
    at one and at two CTAs a SM; at fp32 the form on the CUDA cores at both
    grids. Then launch_geometry's choice against the best."""
    import dataclasses

    import numpy as np
    import torch

    from shadernn_tpu_torch.kernels import conv

    geometry = conv.launch_geometry
    pads = (4, 4, 4, 4)
    try:
        for dt in (torch.bfloat16, torch.float32):
            bf16 = dt == torch.bfloat16
            for name, c, o in (("stem", 3, 32), ("head", 32, 3)):
                x = torch.from_numpy(rng.random((4, 512, 512, c), dtype=np.float32)).to(dev, dt)
                w = torch.from_numpy((rng.standard_normal((9, 9, c, o)) / np.sqrt(81 * c))
                                     .astype(np.float32)).to(dev, dt)
                one, zero = torch.ones(o, device=dev), torch.zeros(o, device=dev)
                nb = 8 if o <= 8 else 32
                if bf16:
                    geos = [conv._wide_layout(c, 9, 9, 16, 16, nb, bufs, packed, 4096, 1, sms)
                            for packed in ({c < 8, False}) for bufs in (2, 1)]
                else:
                    geos = [conv.fma_geometry(4, 512, 512, c, 9, 9, o, pads, sms)]
                geos = [dataclasses.replace(g, grid=grid) for g in geos
                        if g.smem <= conv.MAX_SMEM_BYTES for grid in (sms, 2 * sms)]
                times = {}
                for geo in geos:
                    conv.launch_geometry = lambda *_a, geo=geo: geo
                    times[geo] = device_ms(lambda: conv.fused_conv2d_haloed(
                        x, w, one, zero, pads, "linear", compute_dtype=dt))
                    emit(f"wide {name} k9 {c}->{o} 512x512 b4 {'bf16' if bf16 else 'fp32'} body "
                         f"{geo.body} packed {geo.packed} tile {geo.tile_h}x{geo.tile_w} bufs "
                         f"{geo.in_bufs} grid {geo.grid} smem {geo.smem} {times[geo]:.5f} ms")
                conv.launch_geometry = geometry
                choice = geometry(4, 512, 512, c, 9, 9, o, pads, bf16, sms)
                mine = times.get(choice) or device_ms(lambda: conv.fused_conv2d_haloed(
                    x, w, one, zero, pads, "linear", compute_dtype=dt))
                best = _best(times)
                emit(f"wide {name} {'bf16' if bf16 else 'fp32'}: launch_geometry body {choice.body} "
                     f"packed {choice.packed} bufs {choice.in_bufs} grid {choice.grid} "
                     f"{mine:.5f} ms, best {best:.5f} ms ({mine / best:.3f}x)")
    finally:
        conv.launch_geometry = geometry


def main(argv=None) -> int:
    import numpy as np
    import torch

    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import conv, invres
    from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2
    from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--only", default="block,conv,chain,igemm,wide",
                    help="comma-separated kernels to sweep: block, conv (these two run together), "
                         "chain, igemm, wide")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("sweep_launch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)

    emit(f"card {torch.cuda.get_device_name(0)}, {sms} SMs")
    if "chain" in only:
        _sweep_chain(dev, sms, rng, emit)
    if "igemm" in only:
        _sweep_igemm(dev, sms, rng, emit)
    if "wide" in only:
        _sweep_wide(dev, sms, rng, emit)
    if "block" not in only and "conv" not in only:
        return _write(args.out, lines)
    blocks = {**_blocks(build_mobilenetv2(), 8, dev),
              **_blocks(parse_model_file(MOBILENETV2_TRAINED), 64, dev)}
    pick = invres.pick_launch
    chosen_sum = best_sum = 0.0
    try:
        for (spec, n), (ops, count) in blocks.items():
            x = torch.from_numpy(rng.standard_normal((n, spec.h, spec.w, spec.cin))
                                 .astype(np.float32)).to(dev)
            choice = pick(spec, n, sms, False)
            times = {}
            for (th, tw), split, bufs in itertools.product(invres._F32_TILES, (1, 2, 4, 8), (2, 1)):
                th, tw = min(th, spec.h), min(tw, spec.w)
                geo = invres.layout(spec, th, tw, split, False, bufs)
                cfg = (th, tw, split, bufs)
                if cfg in times or split > -(-spec.e // 32) or geo.smem > invres.MAX_SMEM_BYTES:
                    continue
                invres.pick_launch = lambda *_a, geo=geo: geo
                times[cfg] = device_ms(lambda: invres.fused_invres_block(x, ops, spec))
                emit(f"block {spec.h}x{spec.w} {spec.cin}->{spec.e}->{spec.cout} b{n} tile "
                     f"{th}x{tw} split {split} bufs {bufs} smem {geo.smem} {times[cfg]:.5f} ms")
            invres.pick_launch = pick
            mine = times[(choice.tile_h, choice.tile_w, choice.split, choice.bufs)]
            best = _best(times)
            chosen_sum, best_sum = chosen_sum + mine * count, best_sum + best * count
            emit(f"block {spec.h}x{spec.w} {spec.cin}->{spec.e}->{spec.cout} b{n}: pick_launch "
                 f"{choice.tile_h}x{choice.tile_w} split {choice.split} bufs {choice.bufs} "
                 f"{mine:.5f} ms, best {best:.5f} ms ({mine / best:.3f}x)")
    finally:
        invres.pick_launch = pick
    emit(f"blocks: pick_launch's choices {chosen_sum / best_sum:.3f}x the best, summed over "
         f"the {sum(c for _o, c in blocks.values())} blocks of both paths' steps")

    geometry = conv.launch_geometry
    try:
        for n, h, w, c, k, o in ((8, 32, 32, 3, 3, 64), (8, 32, 32, 64, 3, 64),
                                 (8, 16, 16, 128, 3, 128), (64, 32, 32, 3, 3, 16),
                                 (64, 16, 16, 16, 3, 16), (64, 8, 8, 32, 3, 32),
                                 (64, 4, 4, 64, 3, 64), (64, 4, 4, 128, 3, 128)):
            x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(dev)
            wts = torch.from_numpy((rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c))
                                   .astype(np.float32)).to(dev)
            one, zero = torch.ones(o, device=dev), torch.zeros(o, device=dev)
            pads = (1, 1, 1, 1)
            choice = geometry(n, h, w, c, k, k, o, pads, False, sms)
            c8 = -(-c // 8) * 8
            small = h * w <= 32
            tiles = [(h, w)] if small else [(8, 8), (4, 8), (4, 4)]
            times = {}
            for nb, cc, tg, (th, tw), imgs in itertools.product(
                    (16, 32, 64, 128), sorted({c8, max(8, c8 // 2)}), sorted({k * k, -(-k * k // 2)}),
                    tiles, [64 // (h * w), 1] if small else [1]):
                if nb > 2 * max(16, o):
                    continue
                geo = conv._stage_layout(c, k, k, th, tw, imgs, nb, cc, tg, False)
                if geo.smem > conv.MAX_SMEM_BYTES:
                    continue
                conv.launch_geometry = lambda *_a, geo=geo: geo
                ms = device_ms(lambda: conv.fused_conv2d_haloed(x, wts, one, zero, pads, "relu"))
                times[(nb, cc, tg, th, tw, imgs)] = ms
                emit(f"conv k{k} c{c}->{o} {h}x{w} b{n} nb {nb} cc {cc} taps/stage {tg} tile "
                     f"{th}x{tw} imgs {imgs} smem {geo.smem} {ms:.5f} ms")
            conv.launch_geometry = geometry
            mine = times.get((choice.nb, choice.cc, choice.tg, choice.tile_h, choice.tile_w,
                              choice.imgs))
            mine = f"{mine:.5f} ms" if mine is not None else "not swept"
            emit(f"conv k{k} c{c}->{o} {h}x{w} b{n}: launch_geometry nb {choice.nb} cc "
                 f"{choice.cc} taps/stage {choice.tg} {mine}, best {_best(times):.5f} ms")
    finally:
        conv.launch_geometry = geometry
    return _write(args.out, lines)


def _write(out, lines) -> int:
    if out:
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


def _sweep_chain(dev, sms, rng, emit) -> None:
    """The chain's f32 form at the FP32 plans' chains: every tile of 1-32
    rows and 8-64 columns (at most 2048 pixels), 256 or 512 threads, the
    weights resident or staged pass by pass, that fits; f32_launch_geometry's
    choice against the best."""
    import dataclasses

    import numpy as np
    import torch

    from shadernn_tpu_torch.kernels import chain

    def specs_of(cfg, cin):
        out, c = [], cin
        for k, o, act in cfg:
            out.append(chain.ChainLayerSpec(k, c, o, (k - 1) // 2, k // 2, (k - 1) // 2, k // 2,
                                            act, 0.3))
            c = o
        return out

    geometry = chain.f32_launch_geometry
    try:
        for label, cfg, cin, shape in (
            ("espcn", [(5, 16, "relu"), (3, 16, "relu"), (3, 4, "tanh")], 1, (8, 540, 960)),
            ("resnet18 cls10 16->16->16", [(3, 16, "relu"), (3, 16, "linear")], 16, (64, 32, 32)),
        ):
            specs = specs_of(cfg, cin)
            n, h, w = shape
            ops = [{"w": torch.from_numpy((rng.standard_normal((s.k, s.k, s.c, s.o))
                                           / np.sqrt(s.k * s.k * s.c)).astype(np.float32)).to(dev),
                    "scale": torch.ones(s.o, device=dev), "offset": torch.zeros(s.o, device=dev)}
                   for s in specs]
            x = torch.from_numpy(rng.random((n, h, w, cin), dtype=np.float32)).to(dev)
            choice = geometry(tuple(specs), n, h, w, sms)
            times = {}
            for th, tw, threads, w_all in itertools.product(
                    (4, 8, 16, 32), (8, 16, 32, 64), (256, 512), (True, False)):
                th, tw = min(th, h), min(tw, w)
                if th * tw > 2048 or (th, tw, threads, w_all) in times:
                    continue
                geo = chain._f32_launch(specs, th, tw, w_all, chain.F32_PASS, threads)
                if geo.smem > chain.MAX_SMEM_BYTES:
                    continue
                tiles = n * -(-h // th) * -(-w // tw)
                geo = dataclasses.replace(geo, grid=min(tiles, sms * chain._f32_per_sm(geo)))
                chain.f32_launch_geometry = lambda *_a, geo=geo: geo
                times[(th, tw, threads, w_all)] = device_ms(
                    lambda: chain.fused_conv_chain(x, ops, specs, compute_dtype=torch.float32))
                emit(f"chain f32 {label} {n}x{h}x{w} tile {th}x{tw} threads {threads} "
                     f"{'resident' if w_all else 'staged'} smem {geo.smem} grid {geo.grid} "
                     f"{times[(th, tw, threads, w_all)]:.5f} ms")
            chain.f32_launch_geometry = geometry
            key = (choice.tile_h, choice.tile_w, choice.threads, bool(choice.w_all))
            mine = times.get(key)
            mine = f"{mine:.5f} ms" if mine is not None else "not swept"
            emit(f"chain f32 {label}: f32_launch_geometry tile {key[0]}x{key[1]} threads "
                 f"{key[2]} {mine}, best {_best(times):.5f} ms")
    finally:
        chain.f32_launch_geometry = geometry


def _sweep_igemm(dev, sms, rng, emit) -> None:
    """The implicit-GEMM conv at the two-input graph's conv and the
    ResNet-wide shapes, bf16 and f32: n8-tiles per warp 1-4, warps along M
    1-8, near-square tiles of the CTA's pixels or half of them, ring depth
    2 or 4, one or two CTAs per SM; launch_geometry's choice against the
    best."""
    import dataclasses

    import numpy as np
    import torch

    from shadernn_tpu_torch.kernels import conv_igemm

    geometry = conv_igemm.launch_geometry
    try:
        for n, h, w, c, k, o in ((8, 540, 960, 8, 3, 16), (8, 32, 32, 64, 3, 64),
                                 (8, 16, 16, 128, 3, 128)):
            for dt in (torch.bfloat16, torch.float32):
                f32 = dt == torch.float32
                pads = (1, 1, 1, 1)
                x = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(np.float32)).to(dev, dt)
                wts = torch.from_numpy((rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c))
                                       .astype(np.float32)).to(dev, dt)
                one, zero = torch.ones(o, device=dev), torch.zeros(o, device=dev)
                choice = geometry(n, h, w, c, k, k, o, 1, pads, f32, sms)
                times = {}
                for nt, wm, half, bufs, per_sm in itertools.product(
                        (1, 2, 4), (1, 2, 4, 8), (False, True), (2, 4), (1, 2)):
                    if 8 * nt * (8 // wm) > 2 * max(16, o):
                        continue
                    th, tw = conv_igemm._tile(32 * wm, h, w)
                    if half:
                        th = max(1, th // 2)
                    cc, tg = -(-c // 8) * 8, k * k
                    while True:  # as launch_geometry: the stage until it fits
                        mt = n * -(-h // th) * -(-w // tw)
                        geo = conv_igemm.layout(c, k, k, 1, nt, wm, th, tw, cc, tg, bufs, f32,
                                                mt, sms)
                        if geo.smem <= conv_igemm.MAX_SMEM_BYTES or tg == 1:
                            break
                        if cc > 8 and geo.w_off - geo.in_off > conv_igemm.MAX_SMEM_BYTES // 4:
                            cc = -(-(cc // 2) // 8) * 8
                        else:
                            tg = -(-tg // 2)
                    if geo.smem > conv_igemm.MAX_SMEM_BYTES:
                        continue
                    geo = dataclasses.replace(geo, grid=min(mt, sms * per_sm))
                    cfg = (nt, wm, th, tw, geo.cc, geo.tg, bufs, geo.grid)
                    if cfg in times:
                        continue
                    conv_igemm.launch_geometry = lambda *_a, geo=geo: geo
                    times[cfg] = device_ms(lambda: conv_igemm.conv2d_kernel_nhwc(
                        x, wts, one, zero, stride=1, pads=pads, activation="relu"))
                    emit(f"igemm {'fp32' if f32 else 'bf16'} k{k} c{c}->{o} {h}x{w} b{n} nt {nt} "
                         f"wm {wm} tile {th}x{tw} cc {geo.cc} taps/stage {geo.tg} bufs {bufs} "
                         f"grid {geo.grid} smem {geo.smem} {times[cfg]:.5f} ms")
                conv_igemm.launch_geometry = geometry
                key = (choice.nt, choice.wm, choice.tile_h, choice.tile_w, choice.cc, choice.tg,
                       choice.bufs, choice.grid)
                mine = times.get(key)
                mine = f"{mine:.5f} ms" if mine is not None else "not swept"
                emit(f"igemm {'fp32' if f32 else 'bf16'} k{k} c{c}->{o} {h}x{w} b{n}: "
                     f"launch_geometry nt {choice.nt} wm {choice.wm} tile {choice.tile_h}x"
                     f"{choice.tile_w} bufs {choice.bufs} grid {choice.grid} {mine}, best "
                     f"{_best(times):.5f} ms")
    finally:
        conv_igemm.launch_geometry = geometry


if __name__ == "__main__":
    sys.exit(main())
