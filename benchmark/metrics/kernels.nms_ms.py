"""Device ms per step of the YOLO head's NMS kernel (the program's
`yolo_nms_kernel`, csrc/yolo_nms.cu): the events whose name holds it. The
frozen `HAND_WRITTEN` (harness/trace.py) predates it, so `ops.library_ms`
counts it among the library's events. None where no such event ran (a
program that suppresses in a loop of ATen launches)."""

import re

NAME = re.compile(r"\byolo_nms_kernel\b")


def read(rec):
    t = rec.trace
    if not t or not t["steps"]:
        return None
    us = [r["us"] for key, r in t["rows"].items() if NAME.search(key)]
    return sum(us) / t["steps"] / 1e3 if us else None
