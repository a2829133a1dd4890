"""The port's native host runtime (counterpart of shadernn_tpu/native.py):
ctypes bindings to its own copy of the C++ runtime,
`native_src/snn_runtime.cpp`.

The host-side hot paths around the device's work run in C++, as the
reference's runtime does: the artifact's weight repack (OIHW -> HWIO and
depthwise -> HW1O, which graph/parser.py calls for every artifact),
symmetric per-channel int8 quantization, NV12/NV21 -> RGB, a lock-free
single-producer single-consumer frame ring and raw float32 dumps.

The library is built at first use with the host's C++ compiler (`c++
-O3 -std=c++17 -ffp-contract=off -shared -fPIC`, no cmake) into
`build/native/libsnn_torch_runtime.so` at the repository root, and again
when the source is newer. Several processes may build at once (test
workers): the build holds a file lock, compiles to a name of its own and
renames the library into place. A failed build raises with the
compiler's output; no function here falls back to numpy. Each function's
numpy version stands beside it (`*_plain`), for the tests: the library's
results are bit-equal to them (no contraction into fused multiply-adds,
so that the colour conversion rounds as the numpy version does).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.native")

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "native_src", "snn_runtime.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libsnn_torch_runtime.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _fresh() -> bool:
    return os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)


def build(force: bool = False) -> str:
    """Compile the runtime if the library is missing or older than its
    source (always with `force`). Returns the library's path."""
    if not force and _fresh():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not force and _fresh():  # another process built it meanwhile
            return LIB_PATH
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the native "
                               "runtime cannot be built")
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"native runtime build failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIB_PATH)
        logger.info("native runtime built: %s", LIB_PATH)
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded runtime (built on first use), with its C functions typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f32p = ctypes.POINTER(ctypes.c_float)
            i8p = ctypes.POINTER(ctypes.c_int8)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            I, I64, P = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
            lib.snn_repack_oihw_to_hwio.argtypes = [f32p, f32p, I, I, I, I]
            lib.snn_repack_oihw_to_hwio.restype = I
            lib.snn_repack_dw_to_hw1o.argtypes = [f32p, f32p, I, I, I]
            lib.snn_repack_dw_to_hw1o.restype = I
            lib.snn_quantize_int8.argtypes = [f32p, I64, I64, i8p, f32p]
            lib.snn_quantize_int8.restype = I
            lib.snn_nv12_to_rgb.argtypes = [u8p, u8p, I, I, I, u8p]
            lib.snn_nv12_to_rgb.restype = I
            lib.snn_ring_create.argtypes = [I64, I64]
            lib.snn_ring_create.restype = P
            lib.snn_ring_destroy.argtypes = [P]
            lib.snn_ring_destroy.restype = None
            lib.snn_ring_push.argtypes = [P, u8p, I64]
            lib.snn_ring_push.restype = I
            lib.snn_ring_pop.argtypes = [P, u8p]
            lib.snn_ring_pop.restype = I64
            lib.snn_ring_size.argtypes = [P]
            lib.snn_ring_size.restype = I64
            lib.snn_write_dump.argtypes = [ctypes.c_char_p, f32p, I64]
            lib.snn_write_dump.restype = I
            lib.snn_version.argtypes = []
            lib.snn_version.restype = I
            logger.info("native runtime loaded: %s (version %d)", LIB_PATH, lib.snn_version())
            _lib = lib
        return _lib


def available() -> bool:
    """True once the runtime is loaded (it is built and loaded here if it
    is not yet; a failed build raises)."""
    return get_lib() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {what} failed (rc {rc})")


def _stream(flat: np.ndarray, count: int, what: str) -> np.ndarray:
    flat = np.ascontiguousarray(flat, np.float32).reshape(-1)
    if flat.size != count:
        raise ValueError(f"{what}: {flat.size} floats, expected {count}")
    return flat


# ---------------------------------------------------------------------------
def repack_oihw_to_hwio(flat: np.ndarray, o: int, i: int, kh: int, kw: int) -> np.ndarray:
    """OIHW float32 stream (the artifact's bin layout) -> HWIO array."""
    flat = _stream(flat, o * i * kh * kw, "repack_oihw_to_hwio")
    out = np.empty((kh, kw, i, o), np.float32)
    _check(get_lib().snn_repack_oihw_to_hwio(
        _ptr(flat, ctypes.c_float), _ptr(out, ctypes.c_float), o, i, kh, kw),
        "repack_oihw_to_hwio")
    return out


def repack_oihw_to_hwio_plain(flat: np.ndarray, o: int, i: int, kh: int, kw: int) -> np.ndarray:
    flat = np.ascontiguousarray(flat, np.float32)
    return np.ascontiguousarray(flat.reshape(o, i, kh, kw).transpose(2, 3, 1, 0))


def repack_dw_to_hw1o(flat: np.ndarray, o: int, kh: int, kw: int) -> np.ndarray:
    """Depthwise stream, per output channel kh x kw -> (kh, kw, 1, o)."""
    flat = _stream(flat, o * kh * kw, "repack_dw_to_hw1o")
    out = np.empty((kh, kw, 1, o), np.float32)
    _check(get_lib().snn_repack_dw_to_hw1o(
        _ptr(flat, ctypes.c_float), _ptr(out, ctypes.c_float), o, kh, kw),
        "repack_dw_to_hw1o")
    return out


def repack_dw_to_hw1o_plain(flat: np.ndarray, o: int, kh: int, kw: int) -> np.ndarray:
    flat = np.ascontiguousarray(flat, np.float32)
    return np.ascontiguousarray(flat.reshape(o, kh, kw).transpose(1, 2, 0)[:, :, None, :])


def quantize_int8(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-trailing-channel int8 (q, scale), scale shaped to
    broadcast against w: quant/quantize.py quantize_weight(w, axis=-1)."""
    w = np.asarray(w, np.float32)
    w2 = np.ascontiguousarray(w).reshape(-1, w.shape[-1])
    if w2.size == 0:
        raise ValueError(f"quantize_int8: empty weight of shape {w.shape}")
    q = np.empty(w2.shape, np.int8)
    scale = np.empty((w2.shape[1],), np.float32)
    _check(get_lib().snn_quantize_int8(
        _ptr(w2, ctypes.c_float), w2.shape[0], w2.shape[1],
        _ptr(q, ctypes.c_int8), _ptr(scale, ctypes.c_float)), "quantize_int8")
    return q.reshape(w.shape), scale.reshape([1] * (w.ndim - 1) + [w.shape[-1]])


def quantize_int8_plain(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from shadernn_tpu_torch.quant.quantize import quantize_weight

    return quantize_weight(w, axis=-1)


def _planes(y_plane: np.ndarray, uv_plane: np.ndarray):
    y_c = np.ascontiguousarray(y_plane, np.uint8)
    uv_c = np.ascontiguousarray(uv_plane, np.uint8)
    if y_c.ndim != 2 or y_c.shape[0] % 2 or y_c.shape[1] % 2:
        raise ValueError(f"nv12_to_rgb: Y plane {y_c.shape}, expected (H, W) with H, W even")
    h, w = y_c.shape
    if uv_c.size != h * w // 2:
        raise ValueError(f"nv12_to_rgb: UV plane of {uv_c.size} bytes, expected "
                         f"{h * w // 2} for a {h}x{w} frame")
    return y_c, uv_c


def nv12_to_rgb(y_plane: np.ndarray, uv_plane: np.ndarray, nv21: bool = False) -> np.ndarray:
    """NV12 (NV21 with `nv21`) planes -> (H, W, 3) uint8 RGB, BT.601
    limited range."""
    y_c, uv_c = _planes(y_plane, uv_plane)
    h, w = y_c.shape
    out = np.empty((h, w, 3), np.uint8)
    _check(get_lib().snn_nv12_to_rgb(
        _ptr(y_c, ctypes.c_uint8), _ptr(uv_c, ctypes.c_uint8), h, w, int(nv21),
        _ptr(out, ctypes.c_uint8)), "nv12_to_rgb")
    return out


def nv12_to_rgb_plain(y_plane: np.ndarray, uv_plane: np.ndarray, nv21: bool = False) -> np.ndarray:
    """The C++ conversion in numpy float32, operation for operation."""
    y_c, uv_c = _planes(y_plane, uv_plane)
    f = np.float32
    uv = uv_c.reshape(y_c.shape[0] // 2, y_c.shape[1] // 2, 2).astype(f)
    uv = np.repeat(np.repeat(uv, 2, 0), 2, 1)
    u = uv[..., 1 if nv21 else 0] - f(128)
    v = uv[..., 0 if nv21 else 1] - f(128)
    yv = f(1.164) * (y_c.astype(f) - f(16))
    rgb = np.stack([yv + f(1.596) * v, yv - f(0.392) * u - f(0.813) * v, yv + f(2.017) * u], -1)
    return np.where(rgb < 0, f(0), np.where(rgb > 255, f(255), rgb + f(0.5))).astype(np.uint8)


class NativeFrameRing:
    """Lock-free single-producer single-consumer ring of byte slots (the C++
    ring): one thread pushes, one pops. The capacity rounds up to a power of
    two."""

    def __init__(self, capacity: int, slot_bytes: int):
        self._lib = get_lib()
        self.slot_bytes = int(slot_bytes)
        self._h = self._lib.snn_ring_create(int(capacity), self.slot_bytes)
        if not self._h:
            raise ValueError(f"ring of capacity {capacity} and slot {slot_bytes} bytes")

    def push(self, payload: np.ndarray) -> bool:
        """Copy `payload`'s bytes into the next slot; False when full."""
        buf = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
        if buf.nbytes > self.slot_bytes:
            raise ValueError(f"payload of {buf.nbytes} bytes > slot of {self.slot_bytes}")
        return bool(self._lib.snn_ring_push(self._h, _ptr(buf, ctypes.c_uint8), buf.nbytes))

    def pop(self) -> Optional[np.ndarray]:
        """The oldest payload as uint8 bytes, or None when empty."""
        out = np.empty(self.slot_bytes, np.uint8)
        size = self._lib.snn_ring_pop(self._h, _ptr(out, ctypes.c_uint8))
        return out[:size] if size else None

    def __len__(self) -> int:
        return int(self._lib.snn_ring_size(self._h))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.snn_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def write_dump(path: str, data: np.ndarray) -> None:
    """`data` as raw little-endian float32 (the layer-dump format)."""
    flat = np.ascontiguousarray(data, np.float32).reshape(-1)
    if get_lib().snn_write_dump(os.fsencode(path), _ptr(flat, ctypes.c_float), flat.size):
        raise OSError(f"native write_dump could not write {path}")


def write_dump_plain(path: str, data: np.ndarray) -> None:
    np.ascontiguousarray(data, np.float32).reshape(-1).astype("<f4").tofile(path)
