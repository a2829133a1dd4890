"""The NMS kernel's least time over its device time per step, in percent.

Its least time is the larger of its bytes at the card's memory rate and its
operations at the card's float32 rate on the CUDA cores (data sheet: 67
TFLOP/s SXM, 51 PCIe). Per sample of the step's batch, K = the
configuration's `max_detections` score-sorted rows:

- bytes: each row read once (score f32, index int64, box 4 x f32, class
  int64: 36 bytes) and written once (6 x f32: 24 bytes);
- operations: each row's x + w, y + h and w * h (3), and for each of the
  K (K - 1) / 2 pairs the IoU of `ops/yolo.py` `suppression` (min, max and
  a difference for x and for y, the product, the two sums, the epsilon and
  the quotient: 11); the comparisons are not counted.

Device time: the kernel's events (`kernels.nms_ms`). None where it did not
run."""

F32_CUDA_CORE = {"H100 SXM": 67e12, "H100 PCIe": 51e12}


def cost(batch: int, rows: int):
    """(bytes, operations) of one step's NMS."""
    return batch * rows * (36 + 24), batch * (3 * rows + 11 * rows * (rows - 1) // 2)


def _card() -> str:
    import torch

    from benchmark.harness.cost import peaks_for

    name = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
    return peaks_for(name)[0]


def read(rec):
    from benchmark.harness import spec
    from benchmark.harness.cost import PEAKS

    ms = spec.reader("kernels.nms_ms")(rec)
    if not ms:
        return None
    card = _card()
    nbytes, ops = cost(rec.batch, int(rec.config["max_detections"]))
    least_s = max(nbytes / PEAKS[card].bytes_per_s, ops / F32_CUDA_CORE[card])
    return 100.0 * least_s / (ms * 1e-3)
