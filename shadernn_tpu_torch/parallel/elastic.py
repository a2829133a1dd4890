"""Elastic execution: device-failure detection, exclusion and mesh rebuild
(counterpart of shadernn_tpu/parallel/elastic.py).

The reference has no failure story (SNN_RIP aborts, utils.h:58-61; one
device). A multi-device serving deployment needs at least: detect a
failed or HUNG step, drop the failed device, rebuild the mesh over the
survivors, and resume.

`ElasticEngine` wraps engine construction:

- every step runs on a **watchdog thread** (`step_timeout_s`): the upload,
  which copies from pageable memory and so waits for the stream, the
  queueing, and a wait on an event recorded after the step on each device
  it used. A step that never finishes on the device surfaces as
  `StepTimeout` instead of blocking forever. A rebuild after a failure,
  and each engine's first step, run under the recovery deadline (the
  step's, at least 5 s): the rebuild's weight upload waits on the same
  stream as a step that hung, and a first step pays one-time costs
  (operands prepared; in a cold process the kernels' build, so give
  `step_timeout_s` room for it there);
- on a failure the suspect device is **excluded** from the rebuild mesh
  (`mark_failed`, or parsed from the exception where it names a device)
  and a device that was excluded is never used again;
- the data-parallel degree is re-planned over the survivors (the only
  axis whose loss is capacity rather than correctness) and the failed
  batch replays on the new engine.

`devices` lists the devices (every CUDA device by default, never the CPU
unless named); a device's id is its position in that list, so a logical
list such as `[cuda:0] * 4` can lose its entry 3 while the others go on.

A CUDA error such as an illegal address is sticky: every later CUDA call
in the process fails, so each rebuild fails too, the rebuilds run out and
the step's error is raised, as the JAX engine's is when its runtime stays
broken. Such a process must be restarted; this class does not try to
recover from it.

Failures are injectable for testing (`inject_failure(device=...)`).
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from shadernn_tpu_torch.config import EngineOptions
from shadernn_tpu_torch.engine.engine import Engine
from shadernn_tpu_torch.parallel.mesh import as_device, cuda_devices, make_mesh
from shadernn_tpu_torch.utils import get_logger

logger = get_logger("snn_torch.elastic")


class StepTimeout(RuntimeError):
    """A step exceeded the watchdog deadline (hung collective / dead device)."""


class RuntimeWedged(RuntimeError):
    """Too many watchdog waiters stuck inside the runtime: local recovery
    (rebuild/shrink) cannot help; the process must be restarted. Fatal —
    never swallowed by the recovery loop."""


# Exception types treated as device/runtime failures worth a rebuild
# (torch's CUDA and out-of-memory errors are RuntimeErrors).
_FAILURE_TYPES = (RuntimeError, OSError, StepTimeout)

# Runtime errors sometimes name the device ("TPU_3", "device 3", ...);
# best-effort extraction so the right device gets excluded.
_DEVICE_RE = re.compile(r"(?:TPU|device)[ _:]*(\d+)", re.IGNORECASE)


class ElasticEngine:
    def __init__(
        self,
        graph_builder: Callable[[], object],
        options: EngineOptions,
        max_rebuilds: int = 3,
        step_timeout_s: Optional[float] = 120.0,
        devices: Optional[Sequence] = None,
    ):
        """graph_builder: zero-arg callable producing a fresh Graph (graphs
        are consumed by compilation; a rebuild needs a new one).
        step_timeout_s: watchdog deadline per step; None disables.
        devices: the devices to build on (every CUDA device by default); a
        device's id is its position here."""
        self._devices = [as_device(d) for d in
                         (devices if devices is not None else cuda_devices())]
        if not self._devices:
            raise RuntimeError("ElasticEngine needs devices: no CUDA device is available "
                               "(name the CPU in devices= to run there)")
        self._builder = graph_builder
        self._options = options
        self._max_rebuilds = max_rebuilds
        self.step_timeout_s = step_timeout_s
        self.rebuilds = 0
        self.failures = 0
        self.excluded_ids: Set[int] = set()
        self._fail_next = 0  # test hooks
        self._fail_device: Optional[int] = None
        self._leaked: list = []  # watchdog threads stuck in the runtime
        self.engine: Optional[Engine] = self._make_engine()
        self._warm = False  # a step of this engine completed

    # -- mesh / rebuild ------------------------------------------------------
    def healthy_ids(self) -> List[int]:
        return [i for i in range(len(self._devices)) if i not in self.excluded_ids]

    def healthy_devices(self) -> List[torch.device]:
        return [self._devices[i] for i in self.healthy_ids()]

    def mark_failed(self, device_id: int) -> None:
        """Exclude a device from every future mesh (external failure
        detectors — hardware health monitors — call this directly)."""
        self.excluded_ids.add(device_id)
        logger.warning("device %d marked failed; %d healthy remain",
                       device_id, len(self.healthy_devices()))

    def _plan_shrink(self, attributed: bool = False) -> bool:
        """Re-plan the data degree over the surviving devices. Returns
        False when no further shrink is possible. `attributed`: the failed
        device was identified and excluded — keep all capacity the
        survivors support; unattributed failures back off by half."""
        sh = self._options.sharding
        fixed = sh.model * sh.spatial
        avail = len(self.healthy_devices()) // max(fixed, 1)
        if avail < 1:
            return False
        target = min(sh.data, avail)
        if not attributed and target == sh.data and sh.data > 1:
            # unattributed failure (no device excluded): back off capacity
            target = sh.data // 2
        # largest power-of-two data degree <= target
        new_data = 1
        while new_data * 2 <= target:
            new_data *= 2
        if sh.data <= 1 and new_data <= 1:
            # single device left: rebuild in place (process-level retry)
            return self.rebuilds < self._max_rebuilds
        new_sh = dataclasses.replace(sh, data=max(new_data, 1))
        new_batch = max(
            self._options.batch_size * new_sh.data // max(sh.data, 1), 1
        )
        self._options = dataclasses.replace(
            self._options, sharding=new_sh, batch_size=new_batch
        )
        return True

    def _make_engine(self) -> Engine:
        """An engine over the healthy devices. It is returned, not stored: a
        build that outlives its watchdog leaves nothing behind."""
        sharding = self._options.sharding
        healthy = self.healthy_devices()
        if sharding.is_sharded:
            mesh, options = make_mesh(sharding, devices=healthy), self._options
        else:  # one device: the first healthy one
            mesh, options = None, dataclasses.replace(self._options, device=str(healthy[0]))
        engine = Engine.from_graph(self._builder(), options, mesh=mesh)
        logger.info(
            "elastic engine built: %d-way data parallel, batch %d, "
            "%d device(s) excluded",
            sharding.data, self._options.batch_size, len(self.excluded_ids),
        )
        return engine

    def _rebuild(self) -> None:
        """Build the engine anew after a failure, under the recovery
        deadline: the weight upload waits on the stream of a step that may
        still hang."""
        self._warm = False
        if self.step_timeout_s is None:
            self.engine = self._make_engine()
        else:
            self.engine = self._wait_with_deadline(self._make_engine,
                                                   self._recovery_deadline())

    # -- failure classification ----------------------------------------------
    def inject_failure(self, count: int = 1, device: Optional[int] = None) -> None:
        """Make the next `count` steps raise (tests the recovery path);
        `device` simulates the runtime blaming a specific device."""
        self._fail_next += count
        self._fail_device = device

    def _on_failure(self, e: BaseException) -> bool:
        """Record the failure; returns True if a specific device was
        identified (and newly excluded)."""
        self.failures += 1
        attributed = False
        m = _DEVICE_RE.search(str(e))
        if m:
            did = int(m.group(1))
            if did in self.healthy_ids():
                self.mark_failed(did)
                attributed = True
        logger.warning("step failed (%s: %s); rebuilding engine",
                       type(e).__name__, e)
        return attributed

    # -- execution -----------------------------------------------------------
    MAX_LEAKED_WAITERS = 4
    # A probe, a rebuild or an engine's first step may pay a first-time
    # cost, which the step deadline (tuned for steady-state steps) need not
    # cover.
    RECOVERY_DEADLINE_FLOOR_S = 5.0

    def _recovery_deadline(self) -> float:
        return max(self.step_timeout_s or self.RECOVERY_DEADLINE_FLOOR_S,
                   self.RECOVERY_DEADLINE_FLOOR_S)

    def _wait_with_deadline(self, fn, deadline_s: float):
        """Run fn() on a watchdog thread and return its result; StepTimeout
        past the deadline. A timed-out thread cannot be killed (it is
        blocked inside the runtime) — it is tracked in _leaked and reaped
        when it unwedges; past MAX_LEAKED_WAITERS the runtime is declared
        wedged beyond local recovery and the failure is re-raised as
        fatal."""
        self._leaked = [th for th in self._leaked if th.is_alive()]
        done = threading.Event()
        err: list = []
        res: list = []

        def waiter():
            try:
                res.append(fn())
            except BaseException as we:  # surfaces via the main thread
                err.append(we)
            finally:
                done.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        if not done.wait(deadline_s):
            self._leaked.append(t)
            if len(self._leaked) > self.MAX_LEAKED_WAITERS:
                raise RuntimeWedged(
                    f"{len(self._leaked)} watchdog waiters stuck in the "
                    "runtime: wedged beyond local recovery"
                )
            raise StepTimeout(
                f"step exceeded {deadline_s}s watchdog deadline "
                "(hung collective or dead device)"
            )
        if err:
            raise err[0]
        return res[0]

    def _step(self, inputs: Dict[str, np.ndarray]):
        """Queue one engine step: its outputs, and an event after it on
        each CUDA device it used (Engine.dispatch)."""
        return self.engine.dispatch(inputs)

    def _run_step(self, inputs: Dict[str, np.ndarray]):
        """One step, queued and waited for under the watchdog deadline: the
        upload and the queueing too, since both can wait on a hung stream.
        It waits on the step's events, never on a whole-device synchronize
        (that would also wait on other work)."""
        def step():
            out, events = self._step(inputs)
            for ev in events:
                ev.synchronize()
            return out

        if self.step_timeout_s is None:
            return step()
        out = self._wait_with_deadline(
            step, self.step_timeout_s if self._warm else self._recovery_deadline())
        self._warm = True
        return out

    def _reset_backend(self) -> None:
        """Best-effort refresh after a timeout: drop the engine that hung,
        and with it the operands it prepared (its own cache, and the chain
        kernel's packed weights, which live only as long as the tensors
        they were made from: kernels/chain.py). The next step rebuilds it.
        Nothing here frees device memory (no empty_cache): cudaFree waits
        for the device, so this thread would hang behind the hung step.
        The caching allocator reuses the blocks, ordered after the work
        still queued on their streams."""
        self.engine = None
        logger.warning("dropped the engine after a step timeout")

    def _probe_devices(self) -> bool:
        """Actively probe each healthy device with a tiny copy and add, on
        a stream of its own, under a short deadline; exclude the ones that
        hang or fail. Real attribution, replacing trust in the
        error-message regex."""
        timeout = self._recovery_deadline()
        newly_failed = False
        for i in self.healthy_ids():
            def probe(dev=self._devices[i]):
                if dev.type != "cuda":
                    torch.ones(8).to(dev) + 1
                    return
                stream = torch.cuda.Stream(dev)
                with torch.cuda.stream(stream):
                    torch.ones(8).to(dev) + 1
                stream.synchronize()

            try:
                self._wait_with_deadline(probe, timeout)
            except Exception as e:
                logger.warning("device %d failed probe (%s); excluding",
                               i, type(e).__name__)
                self.mark_failed(i)
                newly_failed = True
        return newly_failed

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """One step with failure recovery. The batch is re-bucketed to the
        current (possibly shrunk) batch size."""
        while True:
            try:
                if self.engine is None:  # dropped after a failure
                    self._rebuild()
                if self._fail_next > 0:
                    self._fail_next -= 1
                    dev = f" on device {self._fail_device}" if self._fail_device is not None else ""
                    raise RuntimeError(f"injected device failure{dev}")
                return self._run_bucketed(inputs)
            except _FAILURE_TYPES as e:
                if isinstance(e, RuntimeWedged):
                    raise
                attributed = self._on_failure(e)
                if isinstance(e, StepTimeout):
                    # A hang gives no device in the message: drop the engine
                    # and actively probe for the dead device instead of
                    # blindly shrinking.
                    self._reset_backend()
                    attributed = self._probe_devices() or attributed
                if (self.rebuilds >= self._max_rebuilds
                        or not self._plan_shrink(attributed)):
                    raise
                self.rebuilds += 1
                # Rebuilt at the top of the loop, where a rebuild that hangs
                # is one more failure.
                self.engine = None

    def _run_bucketed(self, inputs: Dict[str, np.ndarray]):
        batch = next(iter(inputs.values())).shape[0]
        step = self._options.batch_size
        if batch == step:
            return self._run_step(inputs)
        # split/pad into fixed-size buckets and reassemble
        outs_parts = []
        for start in range(0, batch, step):
            chunk = {k: v[start: start + step] for k, v in inputs.items()}
            fill = next(iter(chunk.values())).shape[0]
            if fill < step:
                chunk = {
                    k: np.concatenate(
                        [v, np.repeat(v[-1:], step - fill, axis=0)]
                    )
                    for k, v in chunk.items()
                }
            out = self._run_step(chunk)
            outs_parts.append({k: v[:fill] for k, v in out.items() if k != "__dumps__"})
        return {
            k: torch.cat([p[k] for p in outs_parts])
            for k in outs_parts[0]
        }

    @property
    def data_parallel_degree(self) -> int:
        return self._options.sharding.data
