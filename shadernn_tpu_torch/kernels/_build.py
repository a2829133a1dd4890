"""Build and load the port's CUDA kernels.

`nvcc` compiles each `shadernn_tpu_torch/csrc/*.cu` for sm_90a, one
process per source, all started together, and links them into
`build/kernels/libsnn_torch_kernels.so` at the repository root, at first
use; the library is loaded with ctypes (plain C interface, no PyTorch
headers: a build takes seconds). Nothing is built when the package is
imported; a build failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libsnn_torch_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources(suffixes=(".cu",)):
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(suffixes)
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> Tuple[str, str]:
    """Compile the kernels if the library is missing or older than a source
    or a shared header. Returns (library path, compiler log; empty when
    nothing was built)."""
    srcs = _sources()
    if (
        not force
        and os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH)
        >= max(os.path.getmtime(s) for s in _sources((".cu", ".cuh")))
    ):
        return LIB_PATH, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o") for src in srcs]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs))
    ]
    done = []
    for cmd, proc in procs:  # wait for every compiler before raising
        out, err = proc.communicate()
        done.append((cmd, proc.returncode, out, err))
    for cmd, rc, _out, err in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    logs = [out + err for _cmd, _rc, out, err in done]
    tmp = f"{LIB_PATH}.{tag}"
    cmd = [_nvcc(), *ARCH, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH, "".join(logs) + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device `index`: the wrappers size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with its C functions
    typed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.snn_conv_chain_f32.argtypes = [
                P, I, P, P, ctypes.POINTER(I), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(I), I, I, I, I, I, ctypes.POINTER(I), P,
            ]
            lib.snn_conv_chain_f32.restype = I
            lib.snn_conv_chain_tc.argtypes = [
                P, I, P, P, ctypes.POINTER(I), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), I, I, I, I, I, ctypes.POINTER(I), P,
            ]
            lib.snn_conv_chain_tc.restype = I
            lib.snn_conv_single.argtypes = [
                P, I, P, P, I, P, P, I, I, I, I, I, I, I, I, I, I, I, I,
                ctypes.c_float, I, ctypes.POINTER(I), P,
            ]
            lib.snn_conv_single.restype = I
            lib.snn_invres_block.argtypes = [
                P, I, P, ctypes.POINTER(P), I, I, I, I, I, I, I, I,
                ctypes.POINTER(I), ctypes.c_float, ctypes.c_float, ctypes.c_float, I,
                ctypes.POINTER(I), P,
            ]
            lib.snn_invres_block.restype = I
            lib.snn_conv_igemm.argtypes = [
                P, I, P, P, I, I, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I,
                ctypes.c_float, ctypes.POINTER(I), P,
            ]
            lib.snn_conv_igemm.restype = I
            lib.snn_matmul_fused.argtypes = [
                P, I, P, I, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, ctypes.POINTER(I), P,
            ]
            lib.snn_matmul_fused.restype = I
            lib.snn_yolo_nms.argtypes = [P, P, P, P, P, I, I, I, ctypes.c_float, P]
            lib.snn_yolo_nms.restype = I
            lib.snn_instance_norm.argtypes = [
                P, P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I, ctypes.c_float, P,
            ]
            lib.snn_instance_norm.restype = I
            for name in ("snn_error_string", "snn_conv_single_error", "snn_invres_error",
                         "snn_conv_igemm_error", "snn_matmul_error", "snn_yolo_nms_error",
                         "snn_instance_norm_error"):
                getattr(lib, name).argtypes = [I]
                getattr(lib, name).restype = ctypes.c_char_p
            _lib = lib
        return _lib
