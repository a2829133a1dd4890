"""Train ESPCN 2x on procedural super-resolution pairs and export it
(counterpart of shadernn_tpu/tools/train_espcn.py).

The JAX trainer trains a Keras model (the reference architecture,
demo/modelInferenceESPCN.py), saves it as H5 and converts it. The port
needs no Keras: it trains the same architecture (conv 5x5x16 relu, conv
3x3x16 relu, conv 3x3x4, depth_to_space(2), tanh) through its own FP32
TORCH forward, with Keras's recipe:

- weights from glorot_uniform, biases zero (Keras's Conv2D defaults; drawn
  from a seed here, so not Keras's values);
- Adam at Keras's defaults (eps 1e-7, added to sqrt(v): tools/optim.py
  `TrainState(keras_eps=True)`) under CosineDecay(2e-3, steps), no clip;
- a pool of 4096 patches regenerated every pass, batches taken in order,
  the MSE loss; after each pass the MSE over the pool's first 256 pairs.

`export` writes, with no H5, the graph that the JAX trainer's
`convert_keras(model, input_hw=(540, 960))` gives: the same layer names,
ops and attributes. `bilinear_up2`, the baseline, is PIL's BILINEAR 2x
resize of the uint8-quantized frame written in numpy (8-bit fixed-point
coefficients, a horizontal pass into uint8, then a vertical one), so that
the port needs no Pillow.

Usage: python -m shadernn_tpu_torch.tools.train_espcn [--steps 3000]
       [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from shadernn_tpu_torch.tools.train_resnet18 import OUT_DIR

N_POOL = 4096  # fixed pool, regenerated every pass (cheap, endless data)
PRECISION_BITS = 22  # PIL's 8-bit resample fixed point (32 - 8 - 2)


def synth_hr(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """n synthetic HR luma patches (s x s x 1) in [0, 1].

    Edge-dense by design: hard-edged discs, rotated bars, and thin lines —
    the content where a learned 2x upsampler beats interpolation (linear
    filters must blur a step edge; a trained prior re-sharpens it). A
    couple of low-frequency gratings provide smooth context."""
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    out = np.empty((n, s, s, 1), np.float32)
    for i in range(n):
        img = np.zeros((s, s), np.float64)
        for _ in range(2):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            img += rng.uniform(0.05, 0.2) * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        for _ in range(10):  # hard-edged discs
            cx, cy = rng.uniform(0.0, 1.0, 2)
            r = rng.uniform(0.02, 0.2)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] += rng.uniform(-0.7, 0.7)
        for _ in range(8):  # rotated bars / thin lines
            th = rng.uniform(0, np.pi)
            d = (xx - rng.uniform(0, 1)) * np.cos(th) + (yy - rng.uniform(0, 1)) * np.sin(th)
            img[np.abs(d) < rng.uniform(0.004, 0.05)] += rng.uniform(-0.7, 0.7)
        lo, hi = img.min(), img.max()
        out[i, :, :, 0] = ((img - lo) / (hi - lo + 1e-6)).astype(np.float32)
    return out


def downsample2(hr: np.ndarray) -> np.ndarray:
    """2x box downsample (the LR degradation model)."""
    n, h, w, c = hr.shape
    return hr.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4)).astype(np.float32)


def _pil_bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) int64 fixed-point weights of PIL's BILINEAR resample
    along one axis (Resample.c precompute_coeffs, normalize_coeffs_8bpc)."""
    scale = n_in / n_out
    support = max(scale, 1.0)  # the triangle's support 1.0 times the filter scale
    ss = 1.0 / max(scale, 1.0)
    k = np.zeros((n_out, n_in), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in)
        w = np.array([max(0.0, 1.0 - abs((x - center + 0.5) * ss)) for x in range(xmin, xmax)])
        if w.sum() != 0.0:
            w = w / w.sum()
        k[xx, xmin:xmax] = [int(v * (1 << PRECISION_BITS) + (0.5 if v >= 0 else -0.5)) for v in w]
    return k


def _pil_pass(img: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis`: rounded fixed-point sums, clipped to
    uint8 values."""
    acc = np.moveaxis(np.tensordot(k, np.moveaxis(img, axis, 0), axes=(1, 0)), 0, axis)
    return np.clip((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS, 0, 255)


def bilinear_up2(lr: np.ndarray) -> np.ndarray:
    """Bilinear 2x upsample baseline: PIL's `Image.resize(..., BILINEAR)` of
    each frame quantized to uint8 (x * 255 truncated), in numpy, then / 255."""
    _, h, w, _ = lr.shape
    q = (lr[..., 0] * 255).astype(np.uint8).astype(np.int64)  # (N, H, W)
    tmp = _pil_pass(q, _pil_bilinear_weights(w, 2 * w), axis=2)  # horizontal first
    out = _pil_pass(tmp, _pil_bilinear_weights(h, 2 * h), axis=1)
    return (out.astype(np.float32) / 255.0)[..., None]


def build_graph(weights: dict, input_hw=(None, None)):
    """The ESPCN graph as the JAX trainer's `convert_keras` gives it for
    its Keras model: the same names, ops and attributes. `weights`: layer ->
    {"weight": HWIO, "bias": ...} float32 arrays."""
    from shadernn_tpu_torch.graph.ir import Graph, Node

    h, w = input_hw
    g = Graph("ESPCN_2X_16_16_4")
    g.add(Node("input", "InputLayer", [], {"height": int(h), "width": int(w), "channels": 1}))
    prev = "input"
    for name, k, o, act in (("conv_1", 5, 16, "relu"), ("conv_2", 3, 16, "relu"),
                            ("conv_3", 3, 4, "linear")):
        g.add(Node(name, "Conv2D", [prev], {
            "kernel_size": k, "stride": 1, "padding": "same", "out_channels": o,
            "use_bias": True, "activation": act,
        }, {"weight": np.asarray(weights[name]["weight"], np.float32),
            "bias": np.asarray(weights[name]["bias"], np.float32)}))
        prev = name
    g.add(Node("subpixel", "Subpixel", [prev], {"scale": 2}))
    g.add(Node("tanh_out", "Activation", ["subpixel"], {"activation": "tanh"}))
    g.finalize()
    return g


def glorot_init(seed: int = 0) -> dict:
    """Keras's Conv2D initialization (glorot_uniform kernels, zero biases),
    drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    weights, cin = {}, 1
    for name, k, o in (("conv_1", 5, 16), ("conv_2", 3, 16), ("conv_3", 3, 4)):
        limit = math.sqrt(6.0 / (k * k * cin + k * k * o))
        weights[name] = {"weight": rng.uniform(-limit, limit, (k, k, cin, o)).astype(np.float32),
                         "bias": np.zeros(o, np.float32)}
        cin = o
    return weights


def mse_loss(m, graph):
    (in_name,) = graph.input_names
    out_name = graph.output_names[0]

    def loss(p, x, y):
        return ((m.forward(p, {in_name: x})[out_name] - y) ** 2).mean()

    return loss


def setup(steps: int = 6000, batch: int = 32, patch: int = 64, seed: int = 0,
          device: str = "cuda"):
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.tools.optim import Setup, TrainState, cosine_decay

    graph = build_graph(glorot_init(seed), (patch // 2, patch // 2))
    m = compile_graph(graph, EngineOptions(precision=Precision.FP32, backend=BackendKind.TORCH,
                                           batch_size=batch, device=device))
    state = TrainState(m.params, cosine_decay(2e-3, steps), eps=1e-7, keras_eps=True)

    def one_batch(rng):
        hr = synth_hr(rng, batch, patch)
        return downsample2(hr), hr

    return Setup(graph, m, mse_loss(m, graph), state, one_batch)


def train(steps: int = 6000, batch: int = 32, patch: int = 64, seed: int = 0,
          log=print, device: str = "cuda", stats=None):
    """`steps` counts actual gradient steps (batches seen)."""
    import time

    import torch

    s = setup(steps, batch, patch, seed, device)
    rng = np.random.default_rng(seed)
    data_s, t0, done = 0.0, time.perf_counter(), 0
    while done < steps:
        t1 = time.perf_counter()
        hr = synth_hr(rng, N_POOL, patch)
        lr = downsample2(hr)
        data_s += time.perf_counter() - t1
        epoch_steps = min(N_POOL // batch, steps - done)
        for i in range(epoch_steps):
            sl = slice(i * batch, (i + 1) * batch)
            s.state.step(s.loss, *s.to_device((lr[sl], hr[sl])))
        done += epoch_steps
        with torch.no_grad():
            loss = float(s.loss(s.params, *s.to_device((lr[:256], hr[:256]))))
        log(f"step {done}: mse {loss:.5f}")
    if stats is not None:
        stats.update(steps=steps, data_s=data_s, wall_s=time.perf_counter() - t0, last_loss=loss)
    return s.graph, s.model, s.params


def psnr(a, b, max_val=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(max_val ** 2 / max(mse, 1e-12))


def evaluate(graph, m, params, seed: int = 123, n: int = 8, size: int = 128, log=print):
    """Held-out PSNR (8 px border crop) of the model and of `bilinear_up2`.
    The forward takes any frame size: its ops are the TORCH backend's."""
    import torch

    rng = np.random.default_rng(seed)
    hr = synth_hr(rng, n, size)
    lr = downsample2(hr)
    with torch.no_grad():
        out = m.forward(params, {graph.input_names[0]: torch.from_numpy(lr).to(m.device)})
    pred = out[graph.output_names[0]].float().cpu().numpy()
    base = bilinear_up2(lr)
    c = 8  # crop conv borders, standard SR practice
    p_model = psnr(pred[:, c:-c, c:-c], hr[:, c:-c, c:-c])
    p_base = psnr(base[:, c:-c, c:-c], hr[:, c:-c, c:-c])
    log(f"held-out PSNR (crop {c}): espcn {p_model:.2f} dB vs bilinear {p_base:.2f} dB")
    return p_model, p_base


def export(params, out_dir: str, log=print) -> str:
    """The trained weights in the reference JSON+bin artifact, pinned to
    the reference's 540p benchmark geometry (Engine.from_json re-targets
    it to other frame sizes)."""
    from shadernn_tpu_torch.graph.serialize import save_model

    weights = {name: {k: v.detach().cpu().numpy() for k, v in d.items()}
               for name, d in params.items()}
    graph = build_graph(weights, (540, 960))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "espcn_2x_trained.json")
    save_model(graph, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    graph, m, params = train(steps=args.steps, device=args.device)
    p_model, p_base = evaluate(graph, m, params)
    if not p_model > p_base + 0.5:
        raise SystemExit(f"trained ESPCN ({p_model:.2f} dB) must beat bilinear ({p_base:.2f} dB)")
    export(params, args.out)


if __name__ == "__main__":
    main()
