"""Train YOLOv3-tiny on procedural box scenes and export it (counterpart of
shadernn_tpu/tools/train_yolo.py).

Scenes hold 1-3 colored shapes (disc, square, triangle: 3 classes) with
exact box ground truth, so the gate is a true mAP@0.5 through the full
pipeline: backbone, heads, decode and NMS (ops/yolo.py). Training runs on
the head-output graph (the YOLO decode node removed: its top-k and NMS are
no loss surface) through the port's FP32 TORCH forward with BatchNorm
unfolded and its statistics frozen, with the JAX trainer's loss: BCE
objectness (positives up-weighted), sigmoid-offset MSE for x/y, log-space
MSE for w/h against the assigned anchor, BCE classes; Adam under
warmup_cosine(1e-3, min(50, steps // 4), steps) with a global-norm clip
of 5.0 (tools/optim.py). Trained and exported at 256x256 (grids 8 and 16):
the decode reads the anchors' pixel sizes against the input size.

`synth_scenes` is a copy of the JAX generator: the same generator state
gives bit-identical scenes and boxes in both packages.

Usage: python -m shadernn_tpu_torch.tools.train_yolo [--steps 500]
       [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shadernn_tpu_torch.ops.yolo import YOLOV3_TINY_ANCHORS, YOLOV3_TINY_MASKS
from shadernn_tpu_torch.tools.train_resnet18 import OUT_DIR

NUM_CLASSES = 3  # disc, square, triangle
HW = 256


def synth_scenes(rng: np.random.Generator, n: int, s: int = HW):
    """n scene images (s,s,3) in [0,1] with 1-3 shapes; ground truth rows
    [class, x, y, w, h] normalized top-left (utils/metrics.py format)."""
    yy, xx = np.mgrid[0:s, 0:s] / float(s)
    imgs = np.empty((n, s, s, 3), np.float32)
    gts = []
    for i in range(n):
        bg = rng.uniform(0.0, 0.5, 3)
        img = np.tile(bg[None, None, :], (s, s, 1)).astype(np.float32)
        rows = []
        for _ in range(rng.integers(1, 4)):
            k = int(rng.integers(0, NUM_CLASSES))
            fg = rng.uniform(0.4, 1.0, 3)
            while np.abs(fg - bg).sum() < 0.7:
                fg = rng.uniform(0.0, 1.0, 3)
            r = rng.uniform(0.1, 0.25)
            cx, cy = rng.uniform(r, 1 - r, 2)
            if k == 0:
                m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            elif k == 1:
                m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            else:
                m = (yy > cy - r) & (yy < cy + r) & (
                    np.abs(xx - cx) < (yy - (cy - r)) / 2
                )
                x0, y0, bw, bh = cx - r, cy - r, 2 * r, 2 * r
            img = np.where(m[..., None], fg, img).astype(np.float32)
            rows.append([k, x0, y0, bw, bh])
        img += rng.normal(0, 0.03, img.shape)
        imgs[i] = np.clip(img, 0, 1)
        gts.append(np.asarray(rows, np.float32))
    return imgs, gts


def _grids(hw: int):
    """(gh, gw, mask) per head, coarse (stride 32) first: the graph's head
    order (models/yolov3_tiny.py)."""
    return [
        (hw // 32, hw // 32, YOLOV3_TINY_MASKS[0]),
        (hw // 16, hw // 16, YOLOV3_TINY_MASKS[1]),
    ]


def encode_targets(gts, hw: int = HW):
    """Per-scale training targets: a list (per head) of (tgt (N,g,g,A,5+C),
    pos_mask (N,g,g,A)). Each gt goes to the scale and slot of its best-IoU
    anchor shape (the finer scale wins the shared anchor), at its center
    cell."""
    anchors = np.asarray(YOLOV3_TINY_ANCHORS, np.float32)  # px of net
    n = len(gts)
    outs = []
    for gh, gw, mask in _grids(hw):
        tgt = np.zeros((n, gh, gw, len(mask), 5 + NUM_CLASSES), np.float32)
        pos = np.zeros((n, gh, gw, len(mask)), bool)
        outs.append((tgt, pos))
    for i, rows in enumerate(gts):
        for k, x0, y0, bw, bh in rows:
            pw, ph = bw * hw, bh * hw  # gt size in pixels
            inter = np.minimum(anchors[:, 0], pw) * np.minimum(anchors[:, 1], ph)
            union = anchors[:, 0] * anchors[:, 1] + pw * ph - inter
            best = int(np.argmax(inter / union))
            # prefer the finer scale (head index 1) when the anchor is in
            # both masks (anchor 3 appears in (3,4,5) and (1,2,3))
            for h_idx in (1, 0):
                gh, gw, mask = _grids(hw)[h_idx]
                if best in mask:
                    a_idx = mask.index(best)
                    cx, cy = x0 + bw / 2, y0 + bh / 2
                    gx = min(int(cx * gw), gw - 1)
                    gy = min(int(cy * gh), gh - 1)
                    tgt, pos = outs[h_idx]
                    tgt[i, gy, gx, a_idx, 0] = cx * gw - gx   # sigmoid(tx)
                    tgt[i, gy, gx, a_idx, 1] = cy * gh - gy   # sigmoid(ty)
                    tgt[i, gy, gx, a_idx, 2] = np.log(max(pw, 1.0) / anchors[best, 0])  # tw
                    tgt[i, gy, gx, a_idx, 3] = np.log(max(ph, 1.0) / anchors[best, 1])  # th
                    tgt[i, gy, gx, a_idx, 4] = 1.0            # obj
                    tgt[i, gy, gx, a_idx, 5 + int(k)] = 1.0   # one-hot cls
                    pos[i, gy, gx, a_idx] = True
                    break
    return outs


def build_trainable(batch: int, hw: int = HW, device: str = "cuda"):
    """Head-output graph (YOLO decode node removed) and its forward for
    training, plus the full graph (with decode) for evaluation and export."""
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.compile import compile_graph
    from shadernn_tpu_torch.models.zoo import build_model

    full = build_model("yolov3-tiny", h=hw, w=hw, num_classes=NUM_CLASSES)
    train_g = build_model("yolov3-tiny", h=hw, w=hw, num_classes=NUM_CLASSES)
    del train_g.nodes["yolo"]
    train_g.finalize(["head1", "head2"])
    train_g.infer_shapes(batch_size=batch)
    m = compile_graph(train_g, EngineOptions(
        precision=Precision.FP32, backend=BackendKind.TORCH, batch_size=batch,
        fold_batchnorm=False, device=device))
    return full, train_g, m


def _bce(logit, target):
    """Numerically stable BCE with logits."""
    import torch

    return torch.clamp(logit, min=0) - logit * target + torch.log1p(torch.exp(-logit.abs()))


def detection_loss(m, graph):
    import torch

    (in_name,) = graph.input_names

    def loss(p, x, tgt1, pos1, tgt2, pos2):
        outs = m.forward(p, {in_name: x})
        total = 0.0
        for head, tgt, pos in (("head1", tgt1, pos1), ("head2", tgt2, pos2)):
            f = outs[head]
            n_, gh, gw, _ = f.shape
            f = f.reshape(n_, gh, gw, 3, 5 + NUM_CLASSES)
            posf = pos.float()
            npos = torch.clamp(posf.sum(), min=1.0)
            # objectness: all cells; positives up-weighted
            lobj = _bce(f[..., 4], tgt[..., 4])
            total = total + 5.0 * (lobj * posf).sum() / npos
            total = total + 0.5 * (lobj * (1 - posf)).sum() / lobj.numel()
            # xy (sigmoid offsets), wh (log space), cls: positives only
            lxy = ((torch.sigmoid(f[..., 0:2]) - tgt[..., 0:2]) ** 2).sum(-1)
            lwh = ((f[..., 2:4] - tgt[..., 2:4]) ** 2).sum(-1)
            lcls = _bce(f[..., 5:], tgt[..., 5:]).sum(-1)
            total = total + ((lxy + 0.5 * lwh + lcls) * posf).sum() / npos
        return total

    return loss


def setup(steps: int = 500, batch: int = 16, hw: int = HW, device: str = "cuda"):
    """The trainer's Setup: `graph` is the head-output graph, `full` the
    full graph for evaluation and export."""
    from shadernn_tpu_torch.tools.optim import FROZEN_BN, Setup, TrainState, warmup_cosine

    full, graph, m = build_trainable(batch, hw, device)
    state = TrainState(m.params, warmup_cosine(1e-3, min(50, steps // 4), steps), clip=5.0,
                       frozen=FROZEN_BN)

    def one_batch(rng):
        x, gts = synth_scenes(rng, batch, hw)
        (t1, p1), (t2, p2) = encode_targets(gts, hw)
        return x, t1, p1, t2, p2

    return Setup(graph, m, detection_loss(m, graph), state, one_batch, full=full)


def train(steps: int = 500, batch: int = 16, seed: int = 0, log=print, device: str = "cuda",
          stats=None):
    from shadernn_tpu_torch.tools.optim import fit

    s = setup(steps, batch, device=device)
    fit(s, steps, np.random.default_rng(seed), log, every=25, stats=stats)
    return s.full, s.graph, s.model, s.params


def evaluate_map(full_graph, params, n=48, seed=777, batch=16, log=print, device: str = "cuda"):
    """True mAP@0.5 through the full engine (TORCH backend, FP32): images ->
    backbone -> decode -> NMS."""
    from shadernn_tpu_torch.config import BackendKind, EngineOptions, Precision
    from shadernn_tpu_torch.engine.engine import Engine
    from shadernn_tpu_torch.tools.optim import write_back
    from shadernn_tpu_torch.utils.metrics import mean_average_precision

    write_back(full_graph, params)
    eng = Engine.from_graph(full_graph, EngineOptions(
        precision=Precision.FP32, backend=BackendKind.TORCH, batch_size=batch, device=device))
    rng = np.random.default_rng(seed)
    dets, gt_all = [], []
    for _ in range(n // batch):
        x, gts = synth_scenes(rng, batch)
        out = eng.run_single(x).float().cpu().numpy()  # (B, 100, 6)
        for b in range(batch):
            d = out[b]
            dets.append(d[d[:, 1] > 0])  # score > 0 rows
            gt_all.append(gts[b])
    m = mean_average_precision(dets, gt_all, NUM_CLASSES)
    log(f"mAP@0.5 over {len(dets)} scenes: {m:.3f}")
    return m


def export(full_graph, out_dir: str, log=print):
    """The full graph (with decode) as it stands: `evaluate_map` has
    written the trained weights into it."""
    from shadernn_tpu_torch.graph.serialize import save_model

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "yolov3_tiny_trained.json")
    save_model(full_graph, path, decouple=True)
    log(f"saved {path} (+ _layers.json/_weights.bin)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    full, graph, m, params = train(args.steps, device=args.device)
    m50 = evaluate_map(full, params, device=args.device)
    print(f"mAP@0.5: {m50:.3f}")
    export(full, args.out)


if __name__ == "__main__":
    main()
