"""Hand-written CUDA kernels of the port (sources in ../csrc), each with a
plain PyTorch version beside it.

`KERNELS` names the kernels of each entry point as csrc/*.cu declares them,
which is also how the profiler names their launches (utils/trace_profile.py
`HAND_WRITTEN` is built from it): first the bfloat16 form on the tensor
cores, then the float32 form, then any further body. Each launch is counted
once, in the span and counter recorder (utils/timer.py), as
`kernels.launches.<kernel>.<entry>`; `launch_counts` sums those counters by
entry point or by kernel.
"""

from __future__ import annotations

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
}
LAUNCHES = "kernels.launches."
_COUNTER = {(entry, i): f"{LAUNCHES}{kernel}.{entry}"
            for entry, kernels in KERNELS.items() for i, kernel in enumerate(kernels)}


def count_launch(entry: str, form: int = 0) -> None:
    """Count one launch of `KERNELS[entry][form]`."""
    timer.count(_COUNTER[entry, form])


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
