"""Hand-written CUDA kernels of the port (sources in ../csrc), each with a
plain PyTorch version beside it.

`KERNELS` names the kernels of each entry point as csrc/*.cu declares them,
which is also how the profiler names their launches (utils/trace_profile.py
`HAND_WRITTEN` is built from it): first the bfloat16 form on the tensor
cores, then the float32 form, then any further body. Each launch is counted
once, in the span and counter recorder (utils/timer.py), as
`kernels.launches.<kernel>.<entry>`; `launch_counts` sums those counters by
entry point or by kernel. While a thread captures a CUDA graph
(`capturing`), its launches are tallied for the graph instead, whose every
replay adds the tally (engine/graphs.py).

The kernels keep no state: a wrapper's `prepare` (invres.py's
`prepare_operands`) returns what its launch reads, for the caller to keep
(engine/compile.py `OperandStore`); an entry point prepares on each call.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from shadernn_tpu_torch.utils import timer

KERNELS = {
    "fused_conv_chain": ("conv_chain_tc_kernel", "conv_chain_tf32_kernel"),
    "fused_conv_chain_packed": ("conv_chain_tc_kernel", "conv_chain_tf32_kernel"),
    # the tile body's two forms, then the wide body's (bf16) and its f32 form
    "fused_conv2d_haloed": ("conv_single_tc_kernel", "conv_single_tf32_kernel",
                            "conv_single_wide_kernel", "conv_single_fma_kernel"),
    "fused_invres_block": ("invres_tc_kernel", "invres_tf32_kernel"),
    "conv2d_kernel_nhwc": ("conv_igemm_tc_kernel",),
    "fused_matmul": ("matmul_fused_kernel",),
    # the YOLO head's suppression (ops/yolo.py nms_fixed), in one launch
    "nms_fixed": ("yolo_nms_kernel",),
    # a bfloat16 InstanceNormalization (ops/normalize.py): both launch each call
    "instance_norm": ("instance_norm_stats_kernel", "instance_norm_apply_kernel"),
}
LAUNCHES = "kernels.launches."
_COUNTER = {(entry, i): f"{LAUNCHES}{kernel}.{entry}"
            for entry, kernels in KERNELS.items() for i, kernel in enumerate(kernels)}


# The tally of the capture running on a thread, if any.
_capture = threading.local()


def count_launch(entry: str, form: int = 0) -> None:
    """Count one launch of `KERNELS[entry][form]`: in the recorder, or in the
    tally of the capture running on this thread (a capture launches nothing)."""
    name = _COUNTER[entry, form]
    tally = getattr(_capture, "tally", None)
    if tally is None:
        timer.count(name)
    else:
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured on this thread: yields the tally of
    the launches counted ({counter: launches})."""
    _capture.tally = {}
    try:
        yield _capture.tally
    finally:
        _capture.tally = None


def launch_counts(by: str = "entry", counters: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The launches in the recorder's counters (`counters`, else the
    recorder's now), summed by "entry" (every entry point of `KERNELS`, 0
    where none ran) or by "kernel" (the kernels launched)."""
    counters = timer.counters() if counters is None else counters
    out = dict.fromkeys(KERNELS, 0) if by == "entry" else {}
    for name, n in counters.items():
        if name.startswith(LAUNCHES):
            kernel, entry = name[len(LAUNCHES):].split(".")
            key = entry if by == "entry" else kernel
            out[key] = out.get(key, 0) + n
    return out
