"""Demo / test CLI of the port (counterpart of shadernn_tpu/demo.py): the
reference's test-binary flag surface as one tool.

  python -m shadernn_tpu_torch.demo run espcn --image cat.png --precision bf16
  python -m shadernn_tpu_torch.demo run resnet18 --inner-loops 50 --backend kernel
  python -m shadernn_tpu_torch.demo profile espcn
  python -m shadernn_tpu_torch.demo stream espcn --frames 64 --batch 8
  python -m shadernn_tpu_torch.demo serve espcn --batch 8   # exported engine
  python -m shadernn_tpu_torch.demo list

Every command runs on the card unless `--device cpu` asks for the CPU.
`--backend` takes the port's names (auto, torch, kernel) and the JAX demo's
(xla for torch, pallas for kernel). The printed lines keep the JAX demo's
format. The kernels are built once into build/kernels/ (kernels/_build.py),
the port's counterpart of the JAX demo's compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from shadernn_tpu_torch.config import BackendKind, Precision

PRECISIONS = {"fp32": Precision.FP32, "bf16": Precision.BF16, "int8": Precision.INT8}
BACKENDS = {"auto": BackendKind.AUTO, "torch": BackendKind.TORCH, "kernel": BackendKind.KERNEL,
            "xla": BackendKind.TORCH, "pallas": BackendKind.KERNEL}


def _common(ap):
    ap.add_argument("model", help="runner name (see `list`)")
    ap.add_argument("--image", default=None, help="input image (PNG/JPEG)")
    ap.add_argument("--precision", default="bf16", choices=list(PRECISIONS))
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--inner-loops", type=int, default=10)
    ap.add_argument("--dump-outputs", action="store_true")
    ap.add_argument("--dump-dir", default="layer_dumps")


def _opts(args):
    return PRECISIONS[args.precision], BACKENDS[args.backend]


def _device_line(args) -> str:
    import torch

    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    return f"device: {args.device} ({name})"


def _frames(rng, n, shape):
    return [rng.random(tuple(shape), dtype=np.float32) for _ in range(n)]


def _serve_frames(svc, frames) -> dict:
    """Submit `frames` round robin over 4 streams, drain, and return the
    service's stats."""
    svc.start()
    try:
        for i, x in enumerate(frames):
            svc.submit(i % 4, i, x)
    finally:
        svc.stop(drain=True)
    return svc.stats()


def cmd_run(args):
    from shadernn_tpu_torch.models.runners import run_model

    precision, backend = _opts(args)
    result = run_model(
        args.model,
        image_path=args.image,
        precision=precision,
        backend=backend,
        batch_size=args.batch,
        inner_loops=args.inner_loops,
        dump_dir=args.dump_dir if args.dump_outputs else None,
        device=args.device,
    )
    stats = result["stats"]
    print(_device_line(args))
    print(f"model: {args.model}  out: {result['output_shape']}")
    print(
        f"latency mean {stats['mean_ms']:.3f} ms  p50 {stats['p50_ms']:.3f} ms  "
        f"throughput {stats['frames_per_sec']:.1f} frames/s"
    )
    if "class_index" in result:
        print("class_index:", result["class_index"])
    if "detections" in result:
        print(f"detections ({len(result['detections'])}):")
        for d in result["detections"][:10]:
            print(f"  class {int(d[0])} score {d[1]:.3f} box "
                  f"[{d[2]:.3f}, {d[3]:.3f}, {d[4]:.3f}, {d[5]:.3f}]")
    if "dumps" in result:
        print(f"dumped {len(result['dumps'])} layer outputs to {args.dump_dir}/")


def cmd_profile(args):
    from shadernn_tpu_torch.models.runners import RUNNERS, make_engine
    from shadernn_tpu_torch.utils.profiler import print_report, profile_layers

    precision, backend = _opts(args)
    cfg = RUNNERS[args.model]
    eng = make_engine(args.model, precision, backend, args.batch, device=args.device)
    x = np.random.default_rng(0).random(
        (args.batch, cfg.height, cfg.width, cfg.channels), dtype=np.float32
    )
    profiles = profile_layers(eng, {eng.graph.input_names[0]: x}, iters=args.inner_loops)
    print(_device_line(args))
    print(print_report(profiles, precision="bfloat16" if precision != Precision.FP32 else "float32"))


def cmd_stream(args):
    from shadernn_tpu_torch.engine.streaming import StreamingEngine
    from shadernn_tpu_torch.models.runners import RUNNERS, make_engine

    precision, backend = _opts(args)
    cfg = RUNNERS[args.model]
    eng = make_engine(args.model, precision, backend, args.batch, device=args.device)
    frames = _frames(np.random.default_rng(0), args.frames, (cfg.height, cfg.width, cfg.channels))
    stats = _serve_frames(StreamingEngine(eng), frames)
    print(_device_line(args))
    print(json.dumps(stats, indent=2))


def cmd_serve(args):
    """Production serving start from an exported engine by default.

    The first start builds the engine and exports it (engine/deploy.py) to
    `--export-dir`; every later start loads that directory with no model
    code (no parser, builder or fusion) and plans it again. "ready in"
    runs from the start to the end of the first step. `--no-aot` serves the
    engine built from the model code directly.
    """
    from shadernn_tpu_torch.engine.deploy import ExportedEngine, export_engine
    from shadernn_tpu_torch.engine.streaming import StreamingEngine
    from shadernn_tpu_torch.models.runners import make_engine

    precision, backend = _opts(args)
    export_dir = args.export_dir or os.path.join(
        "serving_artifacts", f"{args.model}_{args.precision}_b{args.batch}"
    )
    t0 = time.time()
    if args.no_aot:
        eng = make_engine(args.model, precision, backend, args.batch, device=args.device)
    else:
        if not os.path.exists(os.path.join(export_dir, "meta.json")):
            # one-time deploy step: build, plan, export
            export_engine(make_engine(args.model, precision, backend, args.batch,
                                      device=args.device), export_dir)
            print(f"exported engine to {export_dir}/")
        eng = ExportedEngine(export_dir, device=args.device)
    (in_name,) = eng.graph.input_names
    shape = eng.model.input_specs[in_name]
    eng.run({in_name: np.zeros(shape, np.float32)})  # the first step, waited for
    print(f"serving ready in {time.time() - t0:.3f}s "
          f"({'exported' if not args.no_aot else 'engine'}; model {args.model}, "
          f"batch {shape[0]})")
    frames = _frames(np.random.default_rng(0), args.frames, shape[1:])
    stats = _serve_frames(StreamingEngine(eng), frames)
    print(_device_line(args))
    print(json.dumps(stats, indent=2))


def cmd_list(_args):
    from shadernn_tpu_torch.models.runners import RUNNERS

    for name, cfg in RUNNERS.items():
        print(f"  {name:<16} {cfg.model:<14} {cfg.height}x{cfg.width}x{cfg.channels} "
              f"({cfg.model_type})")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="shadernn_tpu_torch.demo")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a model once + benchmark")
    _common(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_prof = sub.add_parser("profile", help="per-layer timing table")
    _common(p_prof)
    p_prof.set_defaults(fn=cmd_profile)

    p_stream = sub.add_parser("stream", help="continuous-batching throughput demo")
    _common(p_stream)
    p_stream.add_argument("--frames", type=int, default=64)
    p_stream.set_defaults(fn=cmd_stream)

    p_serve = sub.add_parser(
        "serve", help="start a serving loop (exported engine by default)")
    _common(p_serve)
    p_serve.add_argument("--frames", type=int, default=64)
    p_serve.add_argument("--export-dir", default=None,
                         help="exported engine dir (default: "
                         "serving_artifacts/<model>_<precision>_b<batch>)")
    p_serve.add_argument("--no-aot", action="store_true",
                         help="skip the exported engine and serve the engine "
                         "built from the model code directly")
    p_serve.set_defaults(fn=cmd_serve)

    p_list = sub.add_parser("list", help="list runners")
    p_list.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
