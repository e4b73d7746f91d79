"""The optimizers of TrainConfig: optax's adam, adamw, adagrad and sgd at
a constant learning rate, a linear warmup from 0, or a warmup-cosine
decay, each chained with optax.masked(scale(table_lr_boost)) on the table
updates.

Counterpart of score_tpu/train.py:make_optimizer. Each is written out in
optax's order of operations with ONE step count shared by all parameters,
as optax keeps it: on a step that updates only some parameters (a dense
step of stride-K training) the count still advances, and the others'
values and state stay bit-unchanged. torch.optim's per-parameter step
would give their next update another bias correction and another
learning rate.

Two counts meet in one: Adam's bias correction uses the count after its
increment (ScaleByAdamState), a schedule the count before it
(ScaleByScheduleState starts at 0), so the first step of a warmup moves
nothing. Schedules are evaluated on the host in f32, as optax evaluates
them, and the step's learning rate is one f32 scalar: no device sync.

Every state leaf has its parameter's dtype, as optax's has. A step
updates the parameters a dtype at a time, and against bf16 parameters
(bf16 tables) it does optax's arithmetic in bf16: each constant meets the
tensor rounded to bf16 (JAX's weak-typed constants take the tensor's
dtype, and optax casts its f32 bias corrections and schedule values to
it), and each op rounds its result to bf16, in optax's order. Against f32
parameters the constants are the Python floats themselves, which torch
takes into f32 arithmetic.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .config import Config

_F32 = np.float32


def constant(value: float, dtype: torch.dtype) -> float:
    """`value` as it meets a tensor of `dtype` in optax's arithmetic: as it
    is against f32, rounded (through f32, as JAX converts it) to the
    nearest bf16 against bf16. A bf16 value times or plus a bf16 tensor is
    then exact in torch's f32 arithmetic before the one rounding of the
    result, as in XLA's."""
    if dtype == torch.float32:
        return value
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


def is_table(name: str) -> bool:
    """The reference's path rule for embedding tables (L2, stride-K,
    table_lr_boost): a parameter whose name contains 'table'."""
    return "table" in name


def linear_schedule(init: float, end: float, steps: int
                    ) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps) in f32: init + (end - init)
    * count / steps up to `steps`, then end; constant init if steps <= 0."""
    if steps <= 0:
        return lambda count: float(_F32(init))

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), steps))
        frac = _F32(1) - c / _F32(steps)
        return float(_F32(init - end) * frac + _F32(end))
    return schedule


def cosine_decay(init: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init, steps) (alpha 0, exponent 1) in
    f32: init * (1 + cos(pi * min(count, steps) / steps)) / 2, which
    reaches 0 at `steps` and stays there."""
    if steps <= 0:
        raise ValueError(f"a cosine decay needs decay_steps > warmup_steps; "
                         f"got {steps} steps to decay over")

    def schedule(count: int) -> float:
        c = _F32(min(count, steps))
        cos = np.cos(_F32(math.pi) * c / _F32(steps), dtype=_F32)
        return float(_F32(init) * (_F32(0.5) * (_F32(1) + cos)))
    return schedule


def warmup_cosine_decay(init: float, peak: float, warmup: int,
                        decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps):
    the linear warmup below `warmup`, then the cosine decay of peak over
    decay_steps - warmup steps."""
    warm = linear_schedule(init, peak, warmup)
    cos = cosine_decay(peak, decay_steps - warmup)
    return lambda count: warm(count) if count < warmup else cos(count -
                                                                   warmup)


def make_schedule(cfg: Config, steps_per_epoch: int = 0
                  ) -> Optional[Callable[[int], float]]:
    """TrainConfig's learning rate as a function of the step count, or None
    at a constant rate: 'cosine' decays over decay_steps (or the run's
    steps_per_epoch * num_epochs when it is 0) after a warmup from 0 over
    warmup_steps; 'constant' with warmup_steps > 0 warms up linearly from
    0 and then stays."""
    tc = cfg.train
    lr = tc.learning_rate
    if tc.lr_schedule == "cosine":
        decay = tc.decay_steps or max(steps_per_epoch * tc.num_epochs, 1)
        return warmup_cosine_decay(0.0 if tc.warmup_steps else lr, lr,
                                   tc.warmup_steps, decay)
    if tc.warmup_steps:
        return linear_schedule(0.0, lr, tc.warmup_steps)
    return None


class Optimizer:
    """What every optimizer shares: the parameters by name, the one step
    count, the learning rate of a step (constant, or `schedule(count)` at
    the count before the step), the table boost, and a step on a subset of
    the parameters. A subclass gives `name`, its per-parameter state
    (`state_keys`, each a dict by parameter name) and `direction`, the
    update before the learning rate."""

    name = ""
    state_keys: Sequence[str] = ()

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float,
                 table_lr_boost: float = 1.0,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = dict(params)
        self.lr, self.boost = float(lr), float(table_lr_boost)
        self.schedule = schedule
        self.count = 0

    def learning_rate(self) -> float:
        """The learning rate of the next step (an f32 value)."""
        return self.lr if self.schedule is None else self.schedule(self.count)

    def state(self) -> dict:
        """{name, count, and each state dict}: what a checkpoint holds."""
        return dict(name=self.name, count=self.count,
                    **{k: getattr(self, k) for k in self.state_keys})

    def load_state(self, count: int, **state) -> None:
        """Start from a given count and state (a checkpoint's, or an optax
        state through score_tpu_torch.params.opt_state_from_optax). A
        state that names another optimizer is refused; one with no name
        is taken as this one's if its keys are."""
        name = state.pop("name", self.name)
        if name != self.name or set(state) != set(self.state_keys):
            raise ValueError(
                f"an optimizer state of {name!r} with {sorted(state)} cannot "
                f"load into {self.name!r} ({sorted(self.state_keys)})")
        self.count = int(count)
        for key in self.state_keys:
            mine = getattr(self, key)
            for k, p in self.params.items():
                mine[k] = state[key][k].to(p.device, p.dtype).clone()

    def direction(self, names: Sequence[str], grads: Sequence[torch.Tensor],
                  dtype: torch.dtype) -> Sequence[torch.Tensor]:
        """The update before the learning rate of the parameters `names`,
        all of `dtype`, whose constants are `constant(c, dtype)`."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, names: Sequence[str],
             grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Update the parameters `names` with `grads`, a None gradient
        taken as zeros (a parameter the step does not reach, as optax
        sees it); the count advances once, also with no parameter to
        update. The others and their state stay as they are."""
        lr = self.learning_rate()
        self.count += 1
        groups: Dict[torch.dtype, List[tuple]] = {}
        for k, g in zip(names, grads):
            p = self.params[k]
            groups.setdefault(p.dtype, []).append(
                (k, torch.zeros_like(p) if g is None else g))
        for dtype, group in groups.items():
            names_d = [k for k, _ in group]
            upd = torch._foreach_mul(
                self.direction(names_d, [g for _, g in group], dtype),
                constant(-lr, dtype))
            if self.boost != 1.0:
                tables = [u for k, u in zip(names_d, upd) if is_table(k)]
                if tables:
                    torch._foreach_mul_(tables,
                                        constant(self.boost, dtype))
            torch._foreach_add_([self.params[k] for k in names_d], upd)


class Adam(Optimizer):
    """optax.adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, and the
    direction (mu / bc1) / (sqrt(nu / bc2) + eps), the bias corrections
    1 - b**count at the count after the step's increment, in f32."""

    name = "adam"
    state_keys = ("mu", "nu")

    def __init__(self, params, lr, table_lr_boost=1.0, schedule=None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr, table_lr_boost, schedule)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def _bias_correction(self, decay: float) -> float:
        # 1 - decay**count in f32, as optax computes it (NumPy 2 would
        # promote an f32 base under an int32 power to f64)
        f32 = torch.float32
        return float(1 - torch.tensor(decay, dtype=f32)
                     ** torch.tensor(float(self.count), dtype=f32))

    def direction(self, names, grads, dtype):
        def c(value):
            return constant(value, dtype)
        bc1 = self._bias_correction(self.b1)
        bc2 = self._bias_correction(self.b2)
        mus = [self.mu[k] for k in names]
        nus = [self.nu[k] for k in names]
        torch._foreach_mul_(mus, c(self.b1))
        torch._foreach_add_(mus, torch._foreach_mul(grads, c(1.0 - self.b1)))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, c(1.0 - self.b2))
        torch._foreach_mul_(nus, c(self.b2))
        torch._foreach_add_(nus, g2)
        upd = torch._foreach_div(mus, c(bc1))
        den = torch._foreach_div(nus, c(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, c(self.eps))
        torch._foreach_div_(upd, den)
        return upd


class AdamW(Adam):
    """optax.adamw: Adam's direction plus weight_decay * p (decoupled: it
    is not in the moments), then the learning rate and the table boost,
    which therefore scale the decay too. Every parameter a step updates
    decays, also one with a zero gradient. In bf16 the decay term rounds
    before it is added, as optax's does; in f32 it is one fused op."""

    name = "adamw"

    def __init__(self, params, lr, table_lr_boost=1.0, schedule=None,
                 weight_decay: float = 1e-4, **adam_kw):
        super().__init__(params, lr, table_lr_boost, schedule, **adam_kw)
        self.weight_decay = float(weight_decay)

    def direction(self, names, grads, dtype):
        upd = super().direction(names, grads, dtype)
        params = [self.params[k] for k in names]
        if dtype == torch.float32:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        else:
            torch._foreach_add_(upd, torch._foreach_mul(
                params, constant(self.weight_decay, dtype)))
        return upd


class Adagrad(Optimizer):
    """optax.adagrad: s = g^2 + s from initial_accumulator_value (0.1, not
    0), direction g * rsqrt(s + eps). optax takes where(s > 0, rsqrt(s +
    eps), 0); s >= 0.1 here, so that is rsqrt(s + eps)."""

    name = "adagrad"
    state_keys = ("sum_of_squares",)

    def __init__(self, params, lr, table_lr_boost=1.0, schedule=None,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, lr, table_lr_boost, schedule)
        self.eps = eps
        self.sum_of_squares = {
            k: torch.full_like(p, initial_accumulator_value)
            for k, p in self.params.items()}

    def direction(self, names, grads, dtype):
        sos = [self.sum_of_squares[k] for k in names]
        torch._foreach_add_(sos, torch._foreach_mul(grads, grads))
        inv = torch._foreach_add(sos, constant(self.eps, dtype))
        torch._foreach_rsqrt_(inv)
        torch._foreach_mul_(inv, grads)
        return inv


class SGD(Optimizer):
    """optax.sgd without momentum: the direction is the gradient."""

    name = "sgd"

    def direction(self, names, grads, dtype):
        return grads


OPTIMIZERS: Dict[str, type] = {c.name: c for c in (Adam, AdamW, Adagrad,
                                                    SGD)}


def make_optimizer(cfg: Config, params: Mapping[str, torch.Tensor],
                   steps_per_epoch: int = 0) -> Optimizer:
    """The optimizer of TrainConfig (`optimizer`, `learning_rate`,
    `lr_schedule`, `warmup_steps`, `decay_steps`, `weight_decay`), with
    table_lr_boost on the table updates; `steps_per_epoch` sets a cosine
    decay's horizon when decay_steps is 0."""
    tc = cfg.train
    kw = dict(weight_decay=tc.weight_decay) if tc.optimizer == "adamw" else {}
    return OPTIMIZERS[tc.optimizer](
        params, tc.learning_rate, tc.table_lr_boost,
        make_schedule(cfg, steps_per_epoch), **kw)
