"""Sweep the launch geometry of the float32 (3xTF32) forms of the block and
single-conv kernels on the card, the measurement behind
`kernels/invres.py` `_f32_cost` and the f32 channel-block rule of
`kernels/conv.py` `launch_geometry`:

    python -m shadernn_tpu_torch.tools.sweep_launch [--out FILE]

For every block geometry of MobileNetV2 224 (b8) and the trained cls10
model (b64), every tile, split of E and buffer count that fits; for the
ResNet18 paths' single convs, the channel block, chunk, taps per stage and
tile. Each configuration's device time per call from torch.profiler (the
device's own events over 10 calls, the median of three profiles), one
line each, then for each block
geometry the time of pick_launch's choice against the sweep's best and
the step-weighted ratio of the two. Needs one CUDA card; speed only, the
results do not depend on the geometry.
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


def main(argv=None) -> int:
    import numpy as np
    import torch

    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import conv, invres
    from shadernn_tpu_torch.models.mobilenetv2 import build_mobilenetv2
    from shadernn_tpu_torch.models.zoo import MOBILENETV2_TRAINED

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
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
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
