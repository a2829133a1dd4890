"""The implicit-GEMM conv kernel (B5, kernels/conv_igemm.py) at the launch
shapes of ESPCN 2x 540p b8 sharded on (2,2,2) and (1,2,4), bf16 and fp32:
CUDA-event ms per call (20 back-to-back calls, median of 3 rounds) and
torch.profiler device ms per call, with whether the profile saw every
launch. `--tree` takes the kernel from another checkout (its
shadernn_tpu_torch/, built into its own build/kernels/), so that two
commits are timed on one card in one call:

    python -m shadernn_tpu_torch.tools.time_sharded_b5 [--tree DIR] [--tag NAME]

One JSON line per shape and dtype. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (x, HWIO weight, pads, activation, mesh): per shard, H halo-extended,
# vertical pads 0, O sliced over the model axis (16 -> 8, 4 -> 2).
SHAPES = [((4, 274, 960, 1), (5, 5, 1, 8), (0, 0, 2, 2), "relu", "2x2x2"),
          ((4, 272, 960, 16), (3, 3, 16, 8), (0, 0, 1, 1), "relu", "2x2x2"),
          ((4, 272, 960, 16), (3, 3, 16, 2), (0, 0, 1, 1), "linear", "2x2x2"),
          ((8, 139, 960, 1), (5, 5, 1, 8), (0, 0, 2, 2), "relu", "1x2x4"),
          ((8, 137, 960, 16), (3, 3, 16, 8), (0, 0, 1, 1), "relu", "1x2x4"),
          ((8, 137, 960, 16), (3, 3, 16, 2), (0, 0, 1, 1), "linear", "1x2x4")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="checkout whose kernel is timed")
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
        for name in [m for m in sys.modules if m.split(".")[0] == "shadernn_tpu_torch"]:
            del sys.modules[name]
    import torch

    from shadernn_tpu_torch.kernels import _build, conv_igemm
    from shadernn_tpu_torch.utils.trace_profile import complete, profile_steps

    if not torch.cuda.is_available():
        print("time_sharded_b5: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        assert os.path.abspath(conv_igemm.__file__).startswith(os.path.abspath(args.tree))
    _build.kernel_lib()
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)

    def event_ms(fn, reps=20, warm=3, rounds=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        evs = []
        for _ in range(rounds):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) / reps for a, b in evs)

    for dt in (torch.bfloat16, torch.float32):
        for xs, ws, pads, act, mesh in SHAPES:
            x = torch.randn(xs, device=dev).to(dt)
            w = (torch.randn(ws, device=dev) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dt)
            sc, of = torch.ones(ws[-1], device=dev), torch.zeros(ws[-1], device=dev)

            def fn():
                return conv_igemm.conv2d_kernel_nhwc(x, w, sc, of, stride=1, pads=pads,
                                                     activation=act)

            rep = profile_steps(fn, 10, dev)
            print(json.dumps({"tag": args.tag, "dtype": str(dt).split(".")[-1], "mesh": mesh,
                              "x": xs, "w": ws, "ms": event_ms(fn),
                              "device_ms": rep.e2e_us / 1e3, "profile_complete": complete(rep),
                              "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
