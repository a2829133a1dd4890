"""The port's image modules (shadernn_tpu_torch/image/) against the JAX
package's on the CPU: host color conversions and Image I/O bit-equal to
JAX's, the device ingest (normalize, resize, NV12) against JAX's jitted
ingest on the same uint8 frames. Tolerances: 1e-6 without a resize, 1e-4
(on 0-1 data) with a bilinear resize, one bf16 rounding (2^-8 relative)
where the dtype is bfloat16, exact for nearest."""

import dataclasses

import numpy as np
import pytest
import torch

from shadernn_tpu.image import color as jcolor
from shadernn_tpu.image.image import Image as JImage
from shadernn_tpu.image.image import load_and_preprocess as j_load
from shadernn_tpu.image.ingest import ingest_frames as j_ingest
from shadernn_tpu.image.ingest import nv12_to_rgb_device as j_nv12

from shadernn_tpu_torch.image import color as pcolor
from shadernn_tpu_torch.image.image import Image, load_and_preprocess
from shadernn_tpu_torch.image.ingest import ingest_frames, nv12_to_rgb_device


def test_color_roundtrip_and_formats(rng):
    rgb = (rng.random((8, 10, 3)) * 255).astype(np.uint8)
    img = Image(rgb, pcolor.ColorFormat.RGB8)
    f = img.to_float()
    assert f.pixels.dtype == np.float32 and f.pixels.max() <= 1.0
    back = f.to_format(pcolor.ColorFormat.RGB8)
    assert np.abs(back.pixels.astype(int) - rgb.astype(int)).max() <= 1
    assert [c.value for c in pcolor.ColorFormat] == [c.value for c in jcolor.ColorFormat]
    for fmt, desc in pcolor.FORMAT_DESC.items():
        jdesc = jcolor.FORMAT_DESC[jcolor.ColorFormat(fmt.value)]
        assert dataclasses.astuple(desc) == dataclasses.astuple(jdesc), fmt
    for src, dst in ((pcolor.ColorFormat.RGB8, pcolor.ColorFormat.RGBA32F),
                     (pcolor.ColorFormat.RGB8, pcolor.ColorFormat.R8),
                     (pcolor.ColorFormat.RGB8, pcolor.ColorFormat.RGBA8)):
        got = pcolor.convert(rgb, src, dst)
        want = jcolor.convert(rgb, jcolor.ColorFormat(src.value), jcolor.ColorFormat(dst.value))
        assert got.dtype == want.dtype and np.array_equal(got, want), (src, dst)


def test_luma_matches_reference_coefficients(rng):
    rgb = np.zeros((2, 2, 3), np.uint8)
    rgb[..., 0] = 255  # pure red
    y = Image(rgb, pcolor.ColorFormat.RGB8).luma()
    np.testing.assert_allclose(y.pixels, 0.299, atol=1e-3)
    rgb = (rng.random((6, 5, 3)) * 255).astype(np.uint8)
    assert np.array_equal(pcolor.rgb_to_y(rgb), jcolor.rgb_to_y(rgb))
    assert np.array_equal(Image(rgb, pcolor.ColorFormat.RGB8).luma().pixels,
                          JImage(rgb, jcolor.ColorFormat.RGB8).luma().pixels)


@pytest.mark.parametrize("nv21", [False, True])
def test_nv12_grey_and_host_decode(rng, nv21):
    h, w = 8, 8
    y_plane = np.full((h, w), 128, np.uint8)
    uv = np.full((h // 2, w // 2, 2), 128, np.uint8)  # neutral chroma
    rgb = pcolor.nv12_to_rgb(np.concatenate([y_plane.reshape(-1), uv.reshape(-1)]), h, w, nv21)
    assert np.abs(rgb.astype(int) - rgb[0, 0, 0].astype(int)).max() <= 1
    assert abs(int(rgb[0, 0, 0]) - 130) <= 3  # 1.164*(128-16) ~ 130
    data = (rng.random(h * w * 3 // 2) * 255).astype(np.uint8)
    assert np.array_equal(pcolor.nv12_to_rgb(data, h, w, nv21),
                          jcolor.nv12_to_rgb(data, h, w, nv21))


def test_image_save_load_and_preprocess_match_jax(tmp_path, rng):
    rgb = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    p = tmp_path / "in.png"
    Image(rgb, pcolor.ColorFormat.RGB8).save(str(p))
    back = Image.load(str(p))
    assert back.format == pcolor.ColorFormat.RGB8
    np.testing.assert_array_equal(back.pixels, rgb)
    np.testing.assert_array_equal(back.pixels, JImage.load(str(p)).pixels)
    f = tmp_path / "f.bin"
    Image(rgb.astype(np.float32) / 255, pcolor.ColorFormat.RGB32F).save(str(f))
    np.testing.assert_array_equal(Image.load(str(f)).pixels, JImage.load(str(f)).pixels)
    for kw in (dict(luma_only=True, batch=2), dict(means=(127.5,) * 3, norms=(1 / 127.5,) * 3),
               dict(height=12, width=17)):
        hw = (kw.pop("height", 10), kw.pop("width", 15))
        got = load_and_preprocess(str(p), *hw, **kw)
        want = j_load(str(p), *hw, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), kw


def _both(frames, **kw):
    got = ingest_frames(torch.from_numpy(frames), **kw).float().numpy()
    want = np.asarray(j_ingest(frames, **kw)).astype(np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return got, want


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ingest_frames_match_jax(rng, dtype_name):
    frames = (rng.random((2, 12, 16, 3)) * 255).astype(np.uint8)
    means, norms = (127.5, 127.5, 127.5), (1 / 127.5,) * 3
    got, want = _both(frames, means=means, norms=norms, dtype_name=dtype_name)
    tol = 1e-6 if dtype_name == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=tol)
    host = (frames.astype(np.float32) - 127.5) / 127.5
    np.testing.assert_allclose(got, host, atol=max(tol, 1e-5))


@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)), ((60, 100), (45, 70)),
                                     ((30, 50), (41, 77)), ((16, 24), (32, 48))])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ingest_bilinear_resize_matches_jax(rng, src, dst, dtype_name):
    frames = (rng.random((2, *src, 3)) * 255).astype(np.uint8)
    got, want = _both(frames, target_hw=dst, dtype_name=dtype_name)
    tol = 1e-4 if dtype_name == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ingest_nearest_resize_matches_jax(rng, dtype_name):
    """Exact at every output row and column but where (i + 0.5) * m / n is
    an exact integer: there JAX's float32 division on the CPU can land an
    ulp under it and take the source pixel before, and the port takes the
    exact floor (image/ingest.py _nearest_index)."""
    (m_h, m_w), (n_h, n_w) = (30, 50), (41, 77)
    frames = (rng.random((2, m_h, m_w, 3)) * 255).astype(np.uint8)
    got, want = _both(frames, target_hw=(n_h, n_w), dtype_name=dtype_name,
                      resize_method="nearest")
    exact_rows = {i for i in range(n_h) if (2 * i + 1) * m_h % (2 * n_h) == 0}
    exact_cols = {j for j in range(n_w) if (2 * j + 1) * m_w % (2 * n_w) == 0}
    assert exact_rows == {20} and exact_cols == {38}  # 41 * 30 / 82 = 15, 77 * 50 / 154 = 25
    diff = np.argwhere((got != want).any(axis=(0, 3)))
    assert all(r in exact_rows or c in exact_cols for r, c in diff), diff
    # row 20 is source row 15, resized along the width as JAX resizes it
    row = np.asarray(j_ingest(frames[:, 15:16], target_hw=(1, n_w), dtype_name=dtype_name,
                              resize_method="nearest")).astype(np.float32)
    np.testing.assert_array_equal(got[:, 20:21], row)
    for m, n in ((64, 32), (32, 64), (1080, 540), (7, 3)):  # integer and other factors
        f = (rng.random((1, m, 4, 1)) * 255).astype(np.uint8)
        g, w = _both(f, target_hw=(n, 4), dtype_name=dtype_name, resize_method="nearest")
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nv21", [False, True])
def test_nv12_to_rgb_device_matches_jax(rng, nv21):
    h, w = 8, 12
    y_plane = (rng.random((2, h, w)) * 255).astype(np.uint8)
    uv = (rng.random((2, h // 2, w // 2, 2)) * 255).astype(np.uint8)
    got = nv12_to_rgb_device(torch.from_numpy(y_plane), torch.from_numpy(uv), nv21).numpy()
    want = np.asarray(j_nv12(y_plane, uv, nv21))
    assert got.dtype == np.float32 and got.shape == (2, h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    data = np.concatenate([y_plane[0].reshape(-1), uv[0].reshape(-1)])
    assert np.abs(got[0] - pcolor.nv12_to_rgb(data, h, w, nv21).astype(np.float32)).max() <= 1.0
