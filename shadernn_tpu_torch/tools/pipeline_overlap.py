"""When do a pipeline's stages overlap on the card? `throughput_stats` of
ESPCN 2x BF16/FP32 staged as the dry run stages it (4 stages, plain or as
2-device data sub-meshes of one card, micro_batch 2, a batch of 16 frames
already on the card), five times at each frame size, beside the host
round trip that the blocking schedule pays per stage (a stream's
synchronize right after a tiny kernel):

    python -m shadernn_tpu_torch.tools.pipeline_overlap

One JSON line per configuration (speedups, schedule_inversions and
dispatch_fraction of the five runs), then the round trip. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

# (precision, frame H, W): the dry run's 16x32 up to 1080p.
CONFIGS = [("bf16", 16, 32), ("bf16", 270, 480), ("bf16", 540, 960), ("bf16", 1080, 1920),
           ("fp32", 540, 960)]


def main(argv=None) -> int:
    import torch

    from shadernn_tpu_torch import EngineOptions, Precision
    from shadernn_tpu_torch.models.zoo import build_model
    from shadernn_tpu_torch.parallel.pipeline import PipelinedEngine

    if not torch.cuda.is_available():
        print("pipeline_overlap: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    for prec, h, w in CONFIGS:
        for layout in ("sub-meshes", "plain"):
            devices = [[dev, dev]] * 4 if layout == "sub-meshes" else [dev] * 4
            pipe = PipelinedEngine(build_model("espcn", h=h, w=w),
                                   EngineOptions(precision=Precision(prec)),
                                   devices=devices, micro_batch=2)
            frames = {"input": torch.zeros((16, h, w, 1), device=dev)}
            runs = [pipe.throughput_stats(frames, iters=3) for _ in range(5)]
            print(json.dumps({"card": card, "precision": prec, "hw": [h, w], "stages": layout,
                              **{k: [r[k] for r in runs] for k in
                                 ("speedup", "schedule_inversions", "dispatch_fraction")}}),
                  flush=True)
    stream = torch.cuda.Stream(dev)
    x = torch.ones(1024, device=dev)
    times = []
    for _ in range(200):
        with torch.cuda.stream(stream):
            x.add_(1)
        t0 = time.perf_counter()
        stream.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    print(json.dumps({"card": card, "round_trip_us_p50": statistics.median(times),
                      "round_trip_us_p90": sorted(times)[179]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
