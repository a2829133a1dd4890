"""Build and load the port's CUDA kernels.

`nvcc` compiles `shadernn_tpu_torch/csrc/*.cu` for sm_90a into
`build/kernels/libsnn_torch_kernels.so` at the repository root, at first
use, and the library is loaded with ctypes (plain C interface, no PyTorch
headers: a build takes seconds). Nothing is built when the package is
imported; a build failure raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libsnn_torch_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False) -> Tuple[str, str]:
    """Compile the kernels if the library is missing or older than a source.
    Returns (library path, compiler log; empty when nothing was built)."""
    srcs = _sources()
    if (
        not force
        and os.path.exists(LIB_PATH)
        and os.path.getmtime(LIB_PATH) >= max(os.path.getmtime(s) for s in srcs)
    ):
        return LIB_PATH, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)
    return LIB_PATH, proc.stdout + proc.stderr


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with its C functions
    typed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.snn_conv_chain.argtypes = [
                P, I, P, P, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float), I, I, I, I, I, I, I, I, P,
            ]
            lib.snn_conv_chain.restype = I
            lib.snn_error_string.argtypes = [I]
            lib.snn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
