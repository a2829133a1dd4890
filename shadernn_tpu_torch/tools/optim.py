"""The optimizer pieces of the port's trainers: PyTorch counterparts of
the optax transforms that the JAX package's trainers chain, and of Keras's
Adam and CosineDecay for ESPCN, whose JAX trainer trains a Keras model.

- `warmup_cosine(peak, warmup, steps)` is
  `optax.warmup_cosine_decay_schedule(0, peak, warmup, steps)`: linear
  from 0 over `warmup` counts, then cosine to 0 at `steps`. The first
  update reads count 0, whose value is 0.
- `cosine_decay(peak, steps)` is Keras's `CosineDecay(peak, steps)`,
  read at count 0 on the first update as Keras reads it.
- `TrainState` is `optax.multi_transform({"train": chain(
  clip_by_global_norm(c), adam(schedule)), "freeze": set_to_zero()})`:
  `torch.optim.Adam` (b1 0.9, b2 0.999, eps added to sqrt(v-hat), as
  optax adds it) over the trained leaves, `LambdaLR` for the schedule and
  `clip_grad_norm_` over the trained leaves only. Frozen leaves
  (`requires_grad=False`) are in neither. torch's clip divides by the
  norm plus 1e-6, optax's by the norm: a clipped gradient differs by
  about 1e-6 / norm relative.
- `TrainState(keras_eps=True)` is Keras's Adam: Keras adds eps to
  sqrt(v), not to sqrt(v-hat) (its update is lr * sqrt(1 - b2^t) /
  (1 - b1^t) * m / (sqrt(v) + eps)). That equals torch's form with eps /
  sqrt(1 - b2^t) in the place of eps, which the state sets before each
  step.

Every step (`TrainState.step`, `TrainState.grads`) runs forward and
backward with TF32 off (`no_tf32`): cuDNN's `allow_tf32` is on by
default, and the backward convolutions run outside the forward's own
`full_precision` context (ops/conv.py). The JAX trainers take float32
gradients.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from shadernn_tpu_torch.ops.conv import full_precision

# The BatchNorm statistics, which the JAX classifier and detector trainers
# keep frozen ("freeze" label) while gamma and beta train.
FROZEN_BN = ("mean", "variance")
BETAS = (0.9, 0.999)


def warmup_cosine(peak: float, warmup: int, steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps)."""

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        decay = steps - warmup
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


def cosine_decay(peak: float, steps: int) -> Callable[[int], float]:
    """keras.optimizers.schedules.CosineDecay(peak, steps) (alpha 0, no
    warm-up)."""

    def schedule(count: int) -> float:
        return peak * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))

    return schedule


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls, forward and backward: cuDNN
    (ops/conv.py full_precision) and cuBLAS with TF32 off."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with full_precision():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class TrainState:
    """Adam over a model's parameter dict (node -> {name: tensor}), updated
    in place: the leaves keep their identity, and the engine's operand store
    (engine/compile.py `OperandStore`) prepares anew what it derived from a
    leaf whose version moved. Leaves named in `frozen` get
    `requires_grad=False` and no update."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]],
                 schedule: Callable[[int], float], clip: Optional[float] = None,
                 frozen: Iterable[str] = (), eps: float = 1e-8, keras_eps: bool = False):
        self.params = params
        frozen = set(frozen)
        self.trained: List[Tuple[str, str, torch.Tensor]] = []
        for name, d in params.items():
            for k, t in d.items():
                t.requires_grad_(k not in frozen)
                if k not in frozen:
                    self.trained.append((name, k, t))
        self.clip, self.eps, self.keras_eps = clip, eps, keras_eps
        # lr 1.0 times the schedule's value: the value is the learning rate.
        self.opt = torch.optim.Adam([t for _, _, t in self.trained], lr=1.0, betas=BETAS,
                                    eps=eps)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, schedule)

    @property
    def count(self) -> int:
        """Updates taken: the count the schedule reads next."""
        return self.sched.last_epoch

    def grads(self, loss_fn: Callable, *batch) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
        """The loss and the gradient of every trained leaf (before the
        clip), without an update."""
        with no_tf32():
            loss = loss_fn(self.params, *batch)
            gs = torch.autograd.grad(loss, [t for _, _, t in self.trained])
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for (name, k, _), g in zip(self.trained, gs):
            out.setdefault(name, {})[k] = g
        return loss.detach(), out

    def step(self, loss_fn: Callable, *batch) -> torch.Tensor:
        """One update: loss, backward, clip, Adam, schedule. Returns the
        loss (on the device; reading it waits for the step)."""
        with no_tf32():
            self.opt.zero_grad(set_to_none=True)
            loss = loss_fn(self.params, *batch)
            loss.backward()
            if self.clip is not None:
                torch.nn.utils.clip_grad_norm_([t for _, _, t in self.trained], self.clip)
            if self.keras_eps:
                t = self.count + 1
                self.opt.param_groups[0]["eps"] = self.eps / math.sqrt(1.0 - BETAS[1] ** t)
            self.opt.step()
            self.sched.step()
        return loss.detach()


@dataclasses.dataclass
class Setup:
    """What a trainer's `setup` returns: the graph it trains, the compiled
    forward (TORCH backend, FP32, BatchNorm unfolded), the loss over
    (params, *batch tensors), the optimizer state over `model.params`, and
    `batch(rng)`, one batch of its task as numpy arrays. `full`: the graph
    that is evaluated and exported where it is not `graph` (YOLOv3-tiny's,
    with its decode)."""

    graph: object
    model: object
    loss: Callable
    state: TrainState
    batch: Callable[[np.random.Generator], tuple]
    full: object = None

    @property
    def params(self):
        return self.model.params

    def to_device(self, arrays) -> tuple:
        dev = self.model.device
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def fit(setup: Setup, steps: int, rng: np.random.Generator, log=print, every: int = 50,
        metric: str = "loss", fmt: str = ".4f", stats: Optional[dict] = None) -> None:
    """`steps` updates on fresh batches of `setup.batch(rng)`, logging the
    loss every `every` steps and at the last. `stats`, where given, gets the
    steps, the host's batch-making seconds (`data_s`) apart from the whole
    loop's (`wall_s`) and the last loss."""
    data_s = 0.0
    t0 = time.perf_counter()
    loss = None
    for it in range(steps):
        t1 = time.perf_counter()
        batch = setup.to_device(setup.batch(rng))
        data_s += time.perf_counter() - t1
        loss = setup.state.step(setup.loss, *batch)
        if it % every == 0 or it == steps - 1:
            log(f"step {it}: {metric} {float(loss):{fmt}}")
    if stats is not None:
        stats.update(steps=steps, data_s=data_s, wall_s=time.perf_counter() - t0,
                     last_loss=float(loss) if loss is not None else None)


def write_back(graph, params) -> None:
    """Every parameter into its graph node as a float32 numpy array (what
    the JAX trainers' export does with `np.asarray`)."""
    for name, d in params.items():
        node = graph.nodes[name]
        for k, v in d.items():
            node.params[k] = v.detach().cpu().numpy()
