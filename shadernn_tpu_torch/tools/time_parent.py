"""A kernel at the launches of the paths that run it, from this tree or from
another checkout, so that a parent and a change are timed on one card in
one call (parent, change, change, parent):

    python -m shadernn_tpu_torch.tools.time_parent {b1,b3,b5} [--tree DIR] [--tag NAME]

`--tree` takes the package from that checkout (its shadernn_tpu_torch/,
built into its own build/kernels/). Each row: CUDA-event ms per call (20
back-to-back calls, median of 3 rounds) and torch.profiler device ms. One
JSON line per row. Needs one CUDA card. A timed call launches the kernel
alone, on operands its module's `prepare` made before (in a package
without it, its own cache at the first call). Row sets:

b1, the chain kernel (kernels/chain.py): the trained ESPCN 2x 540p b8
chain as the engine plans it, at bf16 (d2s2 tail) and fp32 (none).

b3, the single-conv kernel (kernels/conv.py): the single-conv launches of
one step of each path that plans them (ResNet18 at the zoo width b8 and the
trained ResNet18 b64, forced KERNEL; the trained MobileNetV2 b64's folded
stem; U-Net 256 b8; YOLOv3-tiny 256 b8), summed, with the models' folded
weights, at bf16 and fp32; StyleTransfer
512x512 b4's k9 stem (3 -> 32) and head (32 -> 3) at bf16 and fp32, inputs
in the compute dtype as the engines pass them; the StyleTransfer-candy 512
b4 step through Engine.from_json at BF16 and FP32: p50 (Engine.benchmark,
20 steps), device busy and the single-conv kernel's device ms per step.

b5, the implicit-GEMM conv kernel (kernels/conv_igemm.py): the launch
shapes of ESPCN 2x 540p b8 sharded on (2,2,2) and (1,2,4), bf16 and fp32,
with whether the profile saw every launch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

# (x, HWIO weight, pads, activation, mesh): per shard, H halo-extended,
# vertical pads 0, O sliced over the model axis (16 -> 8, 4 -> 2).
B5_SHAPES = [((4, 274, 960, 1), (5, 5, 1, 8), (0, 0, 2, 2), "relu", "2x2x2"),
             ((4, 272, 960, 16), (3, 3, 16, 8), (0, 0, 1, 1), "relu", "2x2x2"),
             ((4, 272, 960, 16), (3, 3, 16, 2), (0, 0, 1, 1), "linear", "2x2x2"),
             ((8, 139, 960, 1), (5, 5, 1, 8), (0, 0, 2, 2), "relu", "1x2x4"),
             ((8, 137, 960, 16), (3, 3, 16, 8), (0, 0, 1, 1), "relu", "1x2x4"),
             ((8, 137, 960, 16), (3, 3, 16, 2), (0, 0, 1, 1), "linear", "1x2x4")]


def event_ms(fn, reps=20, warm=3, rounds=3) -> float:
    """CUDA-event ms per call: `reps` back-to-back calls, median of `rounds`."""
    import torch

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


def _prepared(mod, entry, x, w, scale, offset, dt, **kw):
    """A call of `mod.entry` on x, on operands `mod.prepare` made once."""
    if not hasattr(mod, "prepare"):
        return lambda: getattr(mod, entry)(x, w, scale, offset, **kw)
    ops = mod.prepare(w, scale, offset, dt)
    kw.pop("compute_dtype", None)
    return lambda: mod.run(x, ops, **kw)


def _rows_b1(emit, dev) -> None:
    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.kernels import chain
    from shadernn_tpu_torch.models import zoo

    x = torch.from_numpy(np.random.default_rng(0).random((8, 540, 960, 1), dtype=np.float32)
                         ).to(dev)
    for prec, tail in ((Precision.BF16, "d2s2"), (Precision.FP32, "none")):
        eng = Engine.from_json(zoo.ESPCN_TRAINED, EngineOptions(precision=prec, batch_size=8),
                               input_hw=(540, 960))
        dt, specs = prec.activation_dtype, eng.model.forward.chain_specs["conv_1"]
        nodes = [eng.graph.nodes[n] for n in ("conv_1", "conv_2", "conv_3")]
        ops = [{k: v.to(dev) for k, v in p.items()} for p in chain.chain_operands(nodes, dt, specs)]
        ops = chain.prepare(ops, specs, dt) if hasattr(chain, "prepare") else ops
        launch = chain.fused_conv_chain_packed if tail == "d2s2" else chain.fused_conv_chain
        emit({"row": f"espcn 540x960 b8 chain, tail {tail}", "dtype": prec.value},
             lambda: launch(x, ops, specs, tail=tail, compute_dtype=dt))


def _rows_b3(emit, dev) -> None:
    import numpy as np
    import torch

    from shadernn_tpu_torch import Engine, EngineOptions, Precision
    from shadernn_tpu_torch.config import BackendKind
    from shadernn_tpu_torch.graph.parser import parse_model_file
    from shadernn_tpu_torch.kernels import conv
    from shadernn_tpu_torch.models import zoo
    from shadernn_tpu_torch.models.resnet18 import build_resnet18_cifar10
    from shadernn_tpu_torch.ops.common import padding_offsets
    from shadernn_tpu_torch.ops.conv import folded_operands
    from shadernn_tpu_torch.utils.trace_profile import trace_report

    rng = np.random.default_rng(0)
    kernel = BackendKind.KERNEL
    paths = [
        ("resnet18 zoo width b8 KERNEL", lambda o: Engine.from_graph(
            build_resnet18_cifar10(), EngineOptions(batch_size=8, backend=kernel, **o)), 8),
        ("resnet18 cls10 b64 KERNEL", lambda o: Engine.from_json(
            zoo.RESNET18_TRAINED, EngineOptions(batch_size=64, backend=kernel, **o)), 10),
        ("mobilenetv2 cls10 b64", lambda o: Engine.from_json(
            zoo.MOBILENETV2_TRAINED, EngineOptions(batch_size=64, **o)), 1),
        ("unet 256x256 b8", lambda o: Engine.from_graph(
            parse_model_file(zoo.UNET_TRAINED, input_hw=(256, 256)),
            EngineOptions(batch_size=8, **o)), 1),
        ("yolov3-tiny 256x256 b8", lambda o: Engine.from_json(
            zoo.YOLOV3_TINY_TRAINED, EngineOptions(batch_size=8, **o)), 1),
    ]
    for label, make, want in paths:
        for prec in (Precision.BF16, Precision.FP32):
            eng = make({"precision": prec})
            dt = prec.activation_dtype
            g = eng.graph
            launches = []
            for node_name in eng.model.forward.single_conv_plan:
                node = g.nodes[node_name]
                s = g.nodes[node.inputs[0]].out_spec
                k = int(node.attr("kernel_size"))
                x = torch.from_numpy(rng.random((eng.options.batch_size, s.h, s.w, s.c),
                                                dtype=np.float32)).to(dev, dt)
                wts, sc, of = (t.to(dev) for t in folded_operands(node, dt))
                launches.append(_prepared(
                    conv, "fused_conv2d_haloed", x, wts, sc, of, dt, compute_dtype=dt,
                    pads=padding_offsets(node.attr("padding", "same"), k),
                    activation=str(node.attr("activation", "linear"))))
            assert len(launches) == want, (label, len(launches))
            emit({"row": f"{label}: the {want} single-conv launches of one step",
                  "dtype": prec.value},
                 lambda: [call() for call in launches])
            del eng

    for dt in (torch.bfloat16, torch.float32):
        prec = "bf16" if dt == torch.bfloat16 else "fp32"
        for name, xs, ws in (("stem", (4, 512, 512, 3), (9, 9, 3, 32)),
                             ("head", (4, 512, 512, 32), (9, 9, 32, 3))):
            x = torch.from_numpy(rng.random(xs, dtype=np.float32)).to(dev, dt)
            w = torch.from_numpy((rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3])))
                                 .astype(np.float32)).to(dev, dt)
            one, zero = torch.ones(ws[3], device=dev), torch.zeros(ws[3], device=dev)
            emit({"row": f"styletransfer 512x512 b4 {name} k9 {xs[3]}->{ws[3]}", "dtype": prec},
                 _prepared(conv, "fused_conv2d_haloed", x, w, one, zero, dt,
                           pads=(4, 4, 4, 4), activation="linear", compute_dtype=dt))

    x = {"input": rng.random((4, 512, 512, 3), dtype=np.float32)}
    for prec in (Precision.BF16, Precision.FP32):
        eng = Engine.from_json(zoo.STYLE512_TRAINED["candy"],
                               EngineOptions(precision=prec, batch_size=4))
        bench = eng.benchmark(x, loops=20)
        rep = trace_report(eng, x)
        b3 = sum(o.us for o in rep.ops if o.name.startswith("conv_single")) / 1e3
        emit({"row": "styletransfer-candy 512x512 b4 step", "dtype": prec.value,
              "step_p50_ms": bench["p50_ms"], "device_busy_ms": rep.e2e_us / 1e3,
              "single_conv_device_ms": b3,
              "single_conv_kernels": sorted({o.name for o in rep.ops
                                             if o.name.startswith("conv_single")})})
        del eng


def _rows_b5(emit, dev) -> None:
    import torch

    from shadernn_tpu_torch.kernels import conv_igemm

    torch.manual_seed(0)
    for dt in (torch.bfloat16, torch.float32):
        for xs, ws, pads, act, mesh in B5_SHAPES:
            x = torch.randn(xs, device=dev).to(dt)
            w = (torch.randn(ws, device=dev) / (ws[0] * ws[1] * ws[2]) ** 0.5).to(dt)
            sc, of = torch.ones(ws[-1], device=dev), torch.zeros(ws[-1], device=dev)
            emit({"dtype": str(dt).split(".")[-1], "mesh": mesh, "x": xs, "w": ws},
                 _prepared(conv_igemm, "conv2d_kernel_nhwc", x, w, sc, of, dt, stride=1,
                           pads=pads, activation=act))


ROWS = {"b1": _rows_b1, "b3": _rows_b3, "b5": _rows_b5}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ROWS))
    ap.add_argument("--tree", default=None, help="checkout whose package is timed")
    ap.add_argument("--tag", default="this tree")
    args = ap.parse_args(argv)
    if args.tree:  # the package (and its kernel sources) from that checkout from here on
        sys.path.insert(0, os.path.abspath(args.tree))
        for name in [m for m in sys.modules if m.split(".")[0] == "shadernn_tpu_torch"]:
            del sys.modules[name]
    import torch

    import shadernn_tpu_torch
    from shadernn_tpu_torch.kernels import _build
    from shadernn_tpu_torch.utils.trace_profile import complete, profile_steps

    if not torch.cuda.is_available():
        print("time_parent: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        assert os.path.abspath(shadernn_tpu_torch.__file__).startswith(os.path.abspath(args.tree))
    _build.kernel_lib()
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)

    def emit(row, fn=None):
        out = {"tag": args.tag, **row}
        if fn is not None:
            rep = profile_steps(fn, 10, dev)
            out.update(ms=event_ms(fn), device_ms=rep.e2e_us / 1e3, profile_complete=complete(rep),
                       device_ops=[[o.name[:60], o.us / 1e3, o.count] for o in rep.ops])
        print(json.dumps({**out, "card": card}), flush=True)

    ROWS[args.kernel](emit, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
