"""Continuous batching of inference frame streams on CUDA streams
(counterpart of shadernn_tpu/engine/streaming.py).

Generalizes the reference's real-time pipeline (demo/android/.../engine.cpp
:30-120 FrameQueue ring, queues.h:26-100 SPSC queues) into a multi-stream
continuous batcher:

- producers (camera streams, video feeds, RPC handlers) push frames into a
  bounded queue from any thread;
- ONE dispatcher thread owns the device. It drains up to `batch_size`
  frames, pads a partial batch to the engine's batch by repeating its last
  frame, and dispatches it without waiting for its outputs, keeping up to
  `max_inflight` batches in flight;
- each batch crosses three CUDA streams of the dispatcher's own (the
  current stream is per thread): the frames are stacked into pinned host
  memory and copied on the UPLOAD stream; the COMPUTE stream waits for that
  copy's event and runs the step (`engine.model`, or ingest fused with it);
  the DOWNLOAD stream waits for the step's event, copies every output into
  pinned host memory and records the batch's done event. So the upload of
  batch k+1, the step of batch k and the download of batch k-1 overlap,
  and the host never waits on a copy from pageable memory;
- between dispatches the same thread asks the oldest batch's done event
  (`query()`, microseconds on a local card) and routes its results once it
  is done; a full window or a closed queue waits on it (`synchronize()`).
  Tensors used on a stream other than the one that allocated them are
  `record_stream`ed, and every batch keeps its tensors until it is done.

Every batch leaves one record (`BatchTrace`; bounded, always kept): the
dispatcher's monotonic stamps of its wait for frames, staging, copies,
step, done wait and routing, the time the dispatcher spent blocked since
the batch before, and its frames' queue waits from `submit()`. `timeline`
and `stats()` are read from these records; while tracing is on
(utils/timer.py) each record also becomes the spans `snn.serve.*` of the
dispatcher's thread.

On a CPU engine the same loop runs with no streams and no pinning, and a
batch is done when its step returns.

The service reads only `engine.model`, `engine.options.batch_size` and
`engine.graph.input_names` (and `engine.model.device`, the CPU if the model
has none), so it serves an `ExportedEngine` (engine/deploy.py) as well.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shadernn_tpu_torch.utils import get_logger, timer

logger = get_logger("snn_torch.streaming")


@dataclasses.dataclass
class Frame:
    stream_id: int
    frame_id: int
    # (H, W, C) array for single-input graphs, or {input_name: array} for
    # multi-input graphs (e.g. a detection head fed per-scale features).
    data: object
    enqueue_time: float = 0.0  # put into the queue
    submit_time: float = 0.0  # submit() entered (put, where the frame was put directly)
    taken_time: float = 0.0  # taken off the queue by the dispatcher


@dataclasses.dataclass
class Result:
    stream_id: int
    frame_id: int
    outputs: dict  # output name -> numpy array (a view of the batch's pinned buffer)
    latency_s: float = 0.0
    batch_fill: int = 0


class FrameQueue:
    """Bounded MPSC frame queue (the reference's FrameQueue ring,
    engine.cpp:66-108, with blocking producer semantics)."""

    def __init__(self, capacity: int = 64):
        self._q: "queue.Queue[Optional[Frame]]" = queue.Queue(maxsize=capacity)

    def put(self, frame: Frame, timeout: Optional[float] = None) -> None:
        frame.enqueue_time = time.monotonic()
        if not frame.submit_time:
            frame.submit_time = frame.enqueue_time
        self._q.put(frame, timeout=timeout)

    def get_batch(self, max_batch: int, wait_s: float,
                  window_s: Optional[float] = None) -> List[Optional[Frame]]:
        """Block up to wait_s for the first frame, then drain greedily up to
        max_batch within window_s (default wait_s): the continuous batching
        window. Each frame's `taken_time` is stamped as it is taken."""
        out: List[Optional[Frame]] = []
        try:
            first = self._q.get(timeout=wait_s if wait_s > 0 else None)
        except queue.Empty:
            return out
        out.append(first)
        if first is not None:
            first.taken_time = time.monotonic()
        deadline = time.monotonic() + (wait_s if window_s is None else window_s)
        while len(out) < max_batch and first is not None:
            remaining = deadline - time.monotonic()
            try:
                item = self._q.get(timeout=max(remaining, 0.0) or 0.001)
            except queue.Empty:
                break
            out.append(item)
            if item is None:
                break
            item.taken_time = time.monotonic()
        return out

    def close(self, timeout: Optional[float] = None) -> None:
        self._q.put(None, timeout=timeout)


class _Done:
    """The done marker of a batch on the CPU: done when made."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class BatchTrace(NamedTuple):
    """One batch's record: the dispatcher's monotonic stamps (seconds) in
    the order they are taken, what it spent blocked since the batch before
    (from that batch's staging to this one's), and the frames' queue
    waits (from `submit()` to being taken off the queue)."""

    wait_began: float  # the get_batch call that returned the batch began
    first_taken: float  # its first frame taken off the queue
    window_closed: float  # get_batch returned
    staging_began: float
    staged: float  # the frames stacked in (pinned) host memory
    upload_queued: float
    step_queued: float  # the step's launches queued on the compute stream
    dispatched: float  # the downloads and the done marker queued
    done_wait_began: float
    drained: float  # the done marker reached
    routed: float  # every result handed on
    blocked_frames_s: float  # in get_batch since the batch before
    blocked_done_s: float  # in synchronize() since the batch before
    frames: int
    queue_wait_sum_s: float
    queue_wait_max_s: float


@dataclasses.dataclass
class _Batch:
    """One dispatched batch: its frames, its host outputs (filled once
    `ready` is done), every tensor its copies and step use, and its record
    so far (`BatchTrace`'s fields up to `dispatched`, and the rest)."""

    frames: List[Frame]
    outputs: Dict[str, torch.Tensor]
    fill: int
    ready: object  # torch.cuda.Event or _Done: query(), synchronize()
    keep: tuple
    head: tuple  # BatchTrace's first eight fields
    tail: tuple  # blocked_frames_s, blocked_done_s, frames, queue waits


class StreamingEngine:
    """Continuous-batching inference service over a compiled Engine."""

    def __init__(
        self,
        engine,
        on_result: Optional[Callable[[Result], None]] = None,
        queue_capacity: int = 64,
        batch_window_s: float = 0.002,
        ingest: Optional[dict] = None,
        max_inflight: int = 4,
    ):
        """ingest: optional {"means": ..., "norms": ...}: producers then
        submit raw uint8 frames, which cross to the card as uint8 and are
        normalized there in the compute stream, before the model
        (image/ingest.py).

        batch_window_s: how long a batch waits for more frames after its
        first.

        max_inflight: the dispatched-but-undrained batch budget. Bounds the
        device and pinned memory held by batches in flight while letting
        dispatch run ahead of the downloads."""
        self.engine = engine
        self.device = torch.device(getattr(engine.model, "device", "cpu"))
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("the engine's device is CUDA but no CUDA device is available")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.queue = FrameQueue(queue_capacity)
        self.on_result = on_result
        self.batch_window_s = batch_window_s
        self.results: "queue.Queue[Result]" = queue.Queue()
        self.batch_size = engine.options.batch_size
        self.in_names = list(engine.graph.input_names)
        self.in_name = self.in_names[0]
        self.max_inflight = max(int(max_inflight), 1)
        # While batches are in flight and no frame arrives, the dispatcher
        # looks at the oldest batch's done event this often. On a local card
        # Event.query() costs microseconds, so probing every 0.2 ms adds at
        # most 0.2 ms to a batch's latency (a fifth of ESPCN 540p b8's step)
        # for a negligible cost. (The JAX package probes every 10 ms: there
        # each probe was an RPC over a remote link.)
        self.poll_interval_s = 0.0002
        self._latencies: List[float] = []  # per-frame seconds (bounded)
        self._trace: List[BatchTrace] = []  # one per batch, in drain order (bounded)
        self._blocked_frames = 0.0  # seconds in get_batch since the last batch staged
        self._blocked_done = 0.0  # seconds in synchronize() since then
        self.padded_frames = 0  # wasted compute: pad slots of partial batches
        self.frames_done = 0
        self.batches_run = 0
        self._inflight: List[_Batch] = []  # owned by the dispatcher thread
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._streams = None  # (upload, compute, download) on the card
        self._t_first_dispatch: Optional[float] = None
        self._t_last_drain: Optional[float] = None
        self._step = None
        if ingest is not None:
            from shadernn_tpu_torch.image.ingest import make_ingest_fn

            self._step = make_ingest_fn(engine, means=tuple(ingest.get("means", (0.0,))),
                                        norms=tuple(ingest.get("norms", (1 / 255.0,))))

    # -- producer API ------------------------------------------------------
    def submit(self, stream_id: int, frame_id: int, data) -> None:
        """Enqueue one frame; blocks while the queue is full. Raises if the
        dispatcher has failed."""
        frame = Frame(stream_id, frame_id, data, submit_time=time.monotonic())
        while True:
            if self._error is not None:
                raise RuntimeError("the streaming dispatcher failed") from self._error
            try:
                self.queue.put(frame, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- service lifecycle -------------------------------------------------
    def start(self) -> "StreamingEngine":
        # A fresh wall window per start(): reusing an engine across runs
        # must not fold the idle time between them into throughput_fps.
        self._t_first_dispatch = None
        self._t_last_drain = None
        self._error = None
        self._stop.clear()
        if self.device.type == "cuda":
            # The engine's parameters and prepared operands may have been made
            # on another stream of another thread: let that work finish.
            torch.cuda.synchronize(self.device)
        self._thread = threading.Thread(target=self._loop, name="snn-dispatch", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Close the queue and join the dispatcher. drain=True serves every
        frame submitted so far; drain=False drops what has not been
        dispatched. Raises RuntimeError if the dispatcher does not end within
        `timeout` seconds, and re-raises (as the cause) an error that ended
        it."""
        if not drain:
            self._stop.set()
        deadline = time.monotonic() + timeout
        thread = self._thread
        while True:
            try:
                self.queue.close(timeout=0.05)
                break
            except queue.Full:  # a dead dispatcher no longer empties the queue
                if thread is None or not thread.is_alive() or time.monotonic() > deadline:
                    break
        if thread is not None:
            thread.join(max(deadline - time.monotonic(), 0.0))
            if thread.is_alive():
                raise RuntimeError(f"the streaming dispatcher did not stop within {timeout} s")
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the streaming dispatcher failed") from err

    # -- dispatcher --------------------------------------------------------
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                self._streams = tuple(torch.cuda.Stream(self.device) for _ in range(3))
            self._serve()
        except BaseException as e:  # re-raised by stop(); the thread ends here
            logger.exception("streaming dispatcher failed")
            self._error = e
            self._inflight.clear()

    def _serve(self) -> None:
        """Dispatch up to max_inflight batches ahead; retire the oldest batch
        when it is done, or wait on it when the window is full or the queue
        is closed."""
        closed = False
        while not self._stop.is_set():
            while self._inflight and self._inflight[0].ready.query():
                self._drain_one(self._inflight.pop(0))
            if self._inflight and (closed or len(self._inflight) >= self.max_inflight):
                self._drain_one(self._inflight.pop(0))
                continue
            if closed:
                break
            wait = self.poll_interval_s if self._inflight else 0.25
            t_wait = time.monotonic()
            frames = self.queue.get_batch(self.batch_size, wait_s=wait,
                                          window_s=self.batch_window_s)
            t_closed = time.monotonic()
            self._blocked_frames += t_closed - t_wait
            if None in frames:
                closed = True
            # drop ALL sentinels: a twice-closed queue (pre-filled, closed,
            # then stop(drain=True)) can yield [None, None], and _run_batch
            # must never see an empty frame list
            frames = [f for f in frames if f is not None]
            if frames:
                self._run_batch(frames, t_wait, t_closed)
        while self._inflight:  # after a hard stop
            self._drain_one(self._inflight.pop(0))

    def _stage(self, arrays: list) -> torch.Tensor:
        """The batch of frames in one host tensor (pinned on the card), the
        last frame repeated into the pad slots."""
        first = np.asarray(arrays[0])
        pinned = self.device.type == "cuda"
        if pinned:
            timer.count("serve.pinned_allocs")
        host = torch.empty((self.batch_size, *first.shape),
                           dtype=torch.from_numpy(first[:0]).dtype, pin_memory=pinned)
        buf = host.numpy()
        np.stack([np.asarray(a) for a in arrays], out=buf[:len(arrays)])
        buf[len(arrays):] = buf[len(arrays) - 1]
        return host

    def _stream(self, i: int):
        return torch.cuda.stream(self._streams[i]) if self._streams else contextlib.nullcontext()

    def _mark(self, i: int):
        """An event recorded on stream i now (None on the CPU)."""
        if not self._streams:
            return None
        ev = torch.cuda.Event()
        ev.record(self._streams[i])
        return ev

    def _wait(self, i: int, event) -> None:
        if event is not None:
            self._streams[i].wait_event(event)

    def _fetch(self, out: torch.Tensor) -> torch.Tensor:
        """Queue the copy of one output to the host on the current stream."""
        if out.dtype == torch.bfloat16:  # numpy has no bfloat16
            out = out.float()
        if not self._streams:
            return out
        out.record_stream(self._streams[2])
        timer.count("serve.pinned_allocs")
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        return host

    def _mark_ready(self):
        """The batch's done marker, once its downloads are queued: an event
        recorded on the download stream, or on the CPU one that is done."""
        return self._mark(2) if self._streams else _Done()

    def _run_batch(self, frames: List[Frame], t_wait: float, t_closed: float) -> None:
        """Dispatch one batch (nothing here waits for the device) and append
        it to the in-flight window. `t_wait` and `t_closed`: when the
        get_batch call that returned the frames began and returned."""
        t_stage = time.monotonic()
        waits = [f.taken_time - f.submit_time for f in frames]
        tail = (self._blocked_frames, self._blocked_done, len(frames), sum(waits), max(waits))
        self._blocked_frames = self._blocked_done = 0.0
        fill = len(frames)
        self.padded_frames += self.batch_size - fill
        multi = isinstance(frames[0].data, dict)
        names = self.in_names if multi else [self.in_name]
        if self._t_first_dispatch is None:
            self._t_first_dispatch = t_stage
        host = {n: self._stage([f.data[n] if multi else f.data for f in frames]) for n in names}
        t_host = time.monotonic()
        with self._stream(0):
            dev = {n: h.to(self.device, non_blocking=True) for n, h in host.items()}
        t_upload = time.monotonic()
        self._wait(1, self._mark(0))
        with self._stream(1):
            if self._streams:
                for t in dev.values():
                    t.record_stream(self._streams[1])
            if self._step is not None and not multi:
                outs = self._step(dev[self.in_name])
            else:
                outs = self.engine.model(dev)
            outs = {k: v for k, v in outs.items() if k != "__dumps__"}
        self._wait(2, self._mark(1))
        t_step = time.monotonic()
        with self._stream(2):
            fetched = {k: self._fetch(v) for k, v in outs.items()}
            ready = self._mark_ready()
        head = (t_wait, frames[0].taken_time, t_closed, t_stage, t_host, t_upload, t_step,
                time.monotonic())
        self._inflight.append(_Batch(frames, fetched, fill, ready, (host, dev, outs), head,
                                     tail))

    # -- drain ---------------------------------------------------------
    def _drain_one(self, batch: _Batch) -> None:
        """Wait for one batch's outputs (at once if it is done) and route
        its results."""
        t0 = time.monotonic()
        batch.ready.synchronize()
        now = time.monotonic()
        self._blocked_done += now - t0
        self._t_last_drain = now
        self.batches_run += 1
        outs = {k: v.numpy() for k, v in batch.outputs.items()}
        for i, f in enumerate(batch.frames):
            res = Result(
                stream_id=f.stream_id,
                frame_id=f.frame_id,
                outputs={k: v[i] for k, v in outs.items()},
                latency_s=now - f.enqueue_time,
                batch_fill=batch.fill,
            )
            if len(self._latencies) < 100_000:  # bounded history
                self._latencies.append(res.latency_s)
            self.frames_done += 1
            if self.on_result:
                self.on_result(res)
            else:
                self.results.put(res)
        rec = BatchTrace(*batch.head, t0, now, time.monotonic(), *batch.tail)
        if len(self._trace) < 100_000:
            self._trace.append(rec)
        if timer.tracing():
            _record_spans(rec)

    # -- records -----------------------------------------------------------
    @property
    def timeline(self) -> List[Tuple[float, float, float, float]]:
        """(staging began, staged, dispatched, drained) monotonic times of
        each batch, in drain order: the host's staging and dispatch time per
        batch, and whether batch k+1 was dispatched before batch k drained."""
        return [(r.staging_began, r.staged, r.dispatched, r.drained) for r in self._trace]

    # -- stats -------------------------------------------------------------
    def stats(self) -> dict:
        # wall window from the first dispatch to the last drained batch: the
        # serving rate with dispatch and download overlapped
        wall = (
            (self._t_last_drain - self._t_first_dispatch)
            if self._t_first_dispatch is not None and self._t_last_drain is not None
            else 0.0
        )
        out = {
            "frames_done": self.frames_done,
            "batches_run": self.batches_run,
            # mean blocking wait for a batch's outputs (near zero once the
            # downloads overlap the steps)
            "mean_fetch_ms": (1e3 * float(np.mean([r.drained - r.done_wait_began
                                                    for r in self._trace]))
                              if self._trace else 0.0),
            "avg_fill": self.frames_done / max(self.batches_run, 1),
            # wasted compute from padding partial batches to the engine's batch
            "padded_frames": self.padded_frames,
            "throughput_fps": self.frames_done / wall if wall else 0.0,
        }
        if self._latencies:
            lat = np.sort(np.asarray(self._latencies))
            out["p50_latency_ms"] = 1e3 * float(lat[len(lat) // 2])
            out["p99_latency_ms"] = 1e3 * float(lat[min(len(lat) - 1, int(len(lat) * 0.99))])
        # every batch's record (BatchTrace), as a dict
        out["trace"] = [r._asdict() for r in self._trace]
        return out


# The spans of a batch's record: (name, first stamp, last stamp).
_SPANS = (("snn.serve.wait_frames", "wait_began", "window_closed"),
          ("snn.serve.stage", "staging_began", "staged"),
          ("snn.serve.step_enqueue", "upload_queued", "step_queued"),
          ("snn.serve.fetch_enqueue", "step_queued", "dispatched"),
          ("snn.serve.wait_done", "done_wait_began", "drained"),
          ("snn.serve.route", "drained", "routed"))


def _record_spans(rec: BatchTrace) -> None:
    """The batch's record as spans of the recorder, on this (the
    dispatcher's) thread."""
    for name, a, b in _SPANS:
        timer.record(name, int(getattr(rec, a) * 1e9), int(getattr(rec, b) * 1e9))
