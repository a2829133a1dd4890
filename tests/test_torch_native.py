"""The port's native host runtime (shadernn_tpu_torch/native.py and its own
C++ source, native_src/snn_runtime.cpp) against its numpy versions and
the JAX package's numpy paths (tests/test_native.py's counterparts).

The library is built by the host's C++ compiler at first use; these tests
hold each function bit-equal to its numpy version, the build under
concurrent processes, a failed build raising, and every trained artifact
parsed through the library to the JAX parser's weights.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from shadernn_tpu.graph.parser import parse_model_file as j_parse
from shadernn_tpu.image.color import nv12_to_rgb as j_nv12_to_rgb
from shadernn_tpu.quant.quantize import quantize_weight as j_quantize_weight

from shadernn_tpu_torch import native
from shadernn_tpu_torch.graph.parser import parse_model_file
from shadernn_tpu_torch.image.color import nv12_to_rgb as p_nv12_to_rgb
from shadernn_tpu_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("o,i,kh,kw", [(8, 5, 3, 3), (16, 1, 5, 5), (3, 32, 9, 9), (7, 3, 2, 4)])
def test_repack_oihw_bit_equal(rng, o, i, kh, kw):
    flat = rng.standard_normal(o * i * kh * kw).astype(np.float32)
    got = native.repack_oihw_to_hwio(flat, o, i, kh, kw)
    assert got.shape == (kh, kw, i, o)
    np.testing.assert_array_equal(got, native.repack_oihw_to_hwio_plain(flat, o, i, kh, kw))
    # the JAX package's numpy path (shadernn_tpu/native.py's fallback)
    np.testing.assert_array_equal(got, flat.reshape(o, i, kh, kw).transpose(2, 3, 1, 0))


@pytest.mark.parametrize("o,k", [(6, 5), (32, 3), (1, 1)])
def test_repack_dw_bit_equal(rng, o, k):
    flat = rng.standard_normal(o * k * k).astype(np.float32)
    got = native.repack_dw_to_hw1o(flat, o, k, k)
    np.testing.assert_array_equal(got, native.repack_dw_to_hw1o_plain(flat, o, k, k))
    np.testing.assert_array_equal(got, flat.reshape(o, k, k).transpose(1, 2, 0)[:, :, None, :])


def test_repack_rejects_a_short_stream(rng):
    with pytest.raises(ValueError, match="expected 90"):
        native.repack_oihw_to_hwio(np.zeros(89, np.float32), 2, 5, 3, 3)


@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (64, 10), (1, 1, 4, 1), (5, 5, 1, 32)])
def test_quantize_bit_equal(rng, shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # a zero channel: scale 1
    if shape[-1] > 2:  # a channel of exact halves (scale 1): round half to even
        w[..., 1] = (np.arange(w[..., 1].size).reshape(w[..., 1].shape) % 255 - 127) + 0.5
        w.reshape(-1, shape[-1])[0, 1] = 127.0
        w[..., 1] = np.clip(w[..., 1], -127, 127)
    q, s = native.quantize_int8(w)
    for want_q, want_s in (native.quantize_int8_plain(w), j_quantize_weight(w, axis=-1)):
        np.testing.assert_array_equal(q, want_q)
        np.testing.assert_array_equal(s, want_s)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (1,) * (w.ndim - 1) + (shape[-1],)


@pytest.mark.parametrize("nv21", [False, True])
def test_nv12_bit_equal(rng, nv21):
    """Every Y value against random chroma: bit-equal to the numpy version of
    the C++ arithmetic; within one unit of the matrix form the image modules
    of both packages use (as tests/test_native.py holds the JAX one)."""
    h, w = 32, 512
    y = np.tile(np.arange(256, dtype=np.uint8), h * w // 256).reshape(h, w)
    uv = (rng.random((h // 2, w // 2, 2)) * 256).astype(np.uint8)
    got = native.nv12_to_rgb(y, uv, nv21=nv21)
    np.testing.assert_array_equal(got, native.nv12_to_rgb_plain(y, uv, nv21=nv21))
    data = np.concatenate([y.reshape(-1), uv.reshape(-1)])
    for matrix in (j_nv12_to_rgb(data, h, w, nv21=nv21), p_nv12_to_rgb(data, h, w, nv21=nv21)):
        assert np.abs(got.astype(int) - matrix.astype(int)).max() <= 1


def test_nv12_rejects_odd_frames():
    with pytest.raises(ValueError, match="even"):
        native.nv12_to_rgb(np.zeros((3, 4), np.uint8), np.zeros(6, np.uint8))


def test_frame_ring_two_threads(rng):
    """1,000 frames of different sizes from a producer thread to a consumer
    thread through 8 slots: all arrive, in order."""
    ring = native.NativeFrameRing(capacity=8, slot_bytes=1024)
    frames = [rng.random(int(rng.integers(1, 256))).astype(np.float32) for _ in range(1000)]
    received = []

    def consumer():
        while len(received) < len(frames):
            item = ring.pop()
            if item is not None:
                received.append(item.view(np.float32).copy())

    def producer():
        for f in frames:
            while not ring.push(f):
                pass

    threads = [threading.Thread(target=consumer), threading.Thread(target=producer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(received) == len(frames) and len(ring) == 0
    for got, want in zip(received, frames):
        np.testing.assert_array_equal(got, want)
    ring.close()


def test_ring_full_and_empty():
    ring = native.NativeFrameRing(capacity=2, slot_bytes=16)
    assert ring.pop() is None and len(ring) == 0
    payload = np.arange(4, dtype=np.float32)
    assert ring.push(payload)
    assert ring.push(payload * 2)
    assert not ring.push(payload)  # full (capacity rounded to 2)
    assert len(ring) == 2
    np.testing.assert_array_equal(ring.pop().view(np.float32), payload)
    np.testing.assert_array_equal(ring.pop().view(np.float32), payload * 2)
    assert ring.pop() is None
    with pytest.raises(ValueError, match="slot"):
        ring.push(np.zeros(5, np.float32))


def test_write_dump_bytes(tmp_path, rng):
    data = rng.standard_normal((4, 5, 3)).astype(np.float32)
    native.write_dump(str(tmp_path / "d.bin"), data)
    native.write_dump_plain(str(tmp_path / "plain.bin"), data)
    got = (tmp_path / "d.bin").read_bytes()
    assert got == (tmp_path / "plain.bin").read_bytes() == data.astype("<f4").tobytes()
    with pytest.raises(OSError):
        native.write_dump(str(tmp_path / "no_such_dir" / "d.bin"), data)


def test_library_loaded():
    native.repack_dw_to_hw1o(np.zeros(9, np.float32), 1, 3, 3)
    assert native.available()
    assert os.path.exists(native.LIB_PATH)
    assert native.get_lib().snn_version() == 1


def test_concurrent_builds_load_one_library(tmp_path):
    """Six processes build into one empty directory at once: each loads a
    good library (one compiles under the lock, the others find it)."""
    code = (
        "import sys, numpy as np\n"
        "from shadernn_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "native.LIB_PATH = sys.argv[1] + '/libsnn_torch_runtime.so'\n"
        "f = np.arange(2 * 3 * 4, dtype=np.float32)\n"
        "assert np.array_equal(native.repack_oihw_to_hwio(f, 2, 3, 2, 2),\n"
        "                      native.repack_oihw_to_hwio_plain(f, 2, 3, 2, 2))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    for p in procs:
        _out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    assert sorted(os.listdir(tmp_path)) == ["libsnn_torch_runtime.so", "lock"]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int snn_version() { return }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="native runtime build failed") as info:
        native.build()
    assert "bad.cpp" in str(info.value)
    assert not (tmp_path / "build" / "lib.so").exists()


_ARTIFACTS = ["ESPCN_TRAINED", "MOBILENETV2_TRAINED", "RESNET18_TRAINED",
              "SPATIALDENOISE_TRAINED", "AIDENOISE_TRAINED", "UNET_TRAINED",
              "STYLETRANSFER_TRAINED", "YOLOV3_TINY_TRAINED"]


@pytest.mark.parametrize("artifact", _ARTIFACTS + [f"STYLE512:{s}" for s in zoo.STYLES])
def test_artifact_weights_equal_jax_parser(artifact):
    """Every trained artifact parses, through the native repacks, to the
    JAX parser's weights, bit for bit."""
    if artifact.startswith("STYLE512:"):
        path = zoo.STYLE512_TRAINED[artifact.split(":")[1]]
    else:
        path = getattr(zoo, artifact)
    got, want = parse_model_file(path), j_parse(path)
    assert list(got.nodes) == list(want.nodes)
    for name, node in want.nodes.items():
        assert sorted(got.nodes[name].params) == sorted(node.params), name
        for k, v in node.params.items():
            np.testing.assert_array_equal(got.nodes[name].params[k], np.asarray(v),
                                          err_msg=f"{name}.{k}")
