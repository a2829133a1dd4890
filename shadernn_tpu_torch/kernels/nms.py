"""The YOLO head's class-aware greedy suppression in one launch: the
hand-written CUDA kernel (csrc/yolo_nms.cu), its wrapper and a plain model
of its sweep.

`ops/yolo.py` `nms_fixed` suppresses in a loop of `max_detections` rows,
two launches a row; this kernel takes the same score-sorted rows (the
ATen sort of `top_candidates` before it) and decides exactly as that loop
does: the same float32 IoU, op by op, and the same greedy order. One block
a sample; the suppression mask in shared memory, one bit a pair; the sweep
in one warp, 32 bits a lane, hence `MAX_ROWS`. The entry point is named
after the function it stands for (`kernels.KERNELS["nms_fixed"]`).

On a CUDA tensor `suppress` launches the kernel or raises. `nms_fixed`
stays the CPU path and the kernel's oracle; `sweep_model` is the kernel's
mask and sweep written out in numpy, for the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from shadernn_tpu_torch.kernels import count_launch

MAX_ROWS = 1024  # 32 lanes x 32 bits of the kept set


def suppress(boxes: torch.Tensor, classes: torch.Tensor, top_scores: torch.Tensor,
             idx: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """boxes (N, M, 4) f32, classes (N, M) int64, the score-sorted top
    scores (N, K) f32 and their indices (N, K) int64 -> (N, K, 6) rows
    [class, score, x, y, w, h], a suppressed row's score 0."""
    from shadernn_tpu_torch.kernels._build import kernel_lib

    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if (boxes.dim() != 3 or boxes.shape[2] != 4 or tuple(classes.shape) != tuple(boxes.shape[:2])
            or top_scores.dim() != 2 or tuple(idx.shape) != tuple(top_scores.shape)
            or top_scores.shape[0] != boxes.shape[0] or top_scores.shape[1] > boxes.shape[1]):
        raise ValueError(f"NMS of boxes {tuple(boxes.shape)}, classes {tuple(classes.shape)}, "
                         f"top scores {tuple(top_scores.shape)}, indices {tuple(idx.shape)}")
    if any(t.device != boxes.device for t in (classes, top_scores, idx)):
        raise ValueError("NMS operands on different devices")
    n, m, _ = boxes.shape
    k = int(top_scores.shape[1])
    if k > MAX_ROWS:
        raise ValueError(f"NMS over {k} rows: the kernel's sweep holds {MAX_ROWS}")
    boxes = boxes.float().contiguous()
    classes = classes.to(torch.int64).contiguous()
    top_scores = top_scores.float().contiguous()
    idx = idx.to(torch.int64).contiguous()
    out = torch.empty((n, k, 6), dtype=torch.float32, device=boxes.device)
    if n == 0 or k == 0:
        return out
    lib = kernel_lib()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = lib.snn_yolo_nms(boxes.data_ptr(), classes.data_ptr(), top_scores.data_ptr(),
                          idx.data_ptr(), out.data_ptr(), n, m, k, float(iou_threshold), stream)
    if rc != 0:
        raise RuntimeError(f"yolo_nms launch failed ({rc}): {lib.snn_yolo_nms_error(rc).decode()}")
    count_launch("nms_fixed")
    return out


def sweep_model(suppresses: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """The kernel's steps 2-3 for one sample: `suppresses` (K, K) bool (row
    i removes the later row j) packed into 32-bit words, the kept set as
    one word a lane, and the row-by-row sweep -> the kept rows (K) bool."""
    k = len(keep)
    words = (k + 31) // 32
    bits = np.zeros((k, words * 32), bool)
    bits[:, :k] = suppresses & np.triu(np.ones((k, k), bool), 1)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
    mask = (bits.reshape(k, words, 32).astype(np.uint64) * weights).sum(-1).astype(np.uint32)
    lanes = np.zeros(32, np.uint32)
    padded = np.zeros(words * 32, bool)
    padded[:k] = keep
    lanes[:words] = (padded.reshape(words, 32).astype(np.uint64) * weights).sum(-1)
    for i in range(k):
        if (lanes[i >> 5] >> np.uint32(i & 31)) & np.uint32(1):
            lanes[:words] &= ~mask[i]
    return np.array([(lanes[r >> 5] >> np.uint32(r & 31)) & np.uint32(1) for r in range(k)],
                    bool)
