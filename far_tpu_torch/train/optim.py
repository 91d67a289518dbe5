"""Optimizer and learning-rate schedule with optax's semantics.

Counterpart of ``far_tpu/train/optim.py``, whose optimizer is
``apply_if_finite(chain(clip_by_global_norm, adamw | adam [+ decay]))``
over a warm-up-then-decay schedule. ``FarOptimizer`` wraps
``torch.optim.AdamW`` / ``torch.optim.Adam`` and reproduces what differs
from their defaults:

- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  with no epsilon (not ``clip_grad_norm_``);
- a gradient with a non-finite entry drops the whole update and advances
  neither Adam's count nor the schedule's (until 10,000 in a row);
- the schedule is read at the count of updates applied so far, so with a
  linear warm-up from 0 the first update has lr 0; a joined schedule
  hands its decay part ``count - warmup_steps``;
- ``adamw``'s decoupled decay is ``p -= lr * wd * p``, as torch's AdamW
  does; ``adam`` with ``adam_decay`` adds ``adam_decay * p`` to the
  update after the learning rate, as ``optax.add_decayed_weights``
  chained after ``optax.adam`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
MAX_CONSECUTIVE_ERRORS = 10_000


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adamw"          # 'adam' | 'adamw'
    lr: float = 6e-3                  # canonical lr (scaled by caller)
    adam_decay: float = 0.0
    adamw_decay: float = 0.1
    warmup_steps: int = 4800
    warmup_ratio: float = 0.0
    warmup_type: str = "linear"       # 'linear' | 'constant'
    scheduler: str = "multistep"      # 'multistep'|'cosine'|'exponential'|'onecycle'|'none'
    steps_per_epoch: int = 1000       # for epoch-interval schedules
    mslr_milestones: Sequence[int] = (3, 6, 9, 12)   # epochs
    mslr_gamma: float = 0.5
    cosa_tmax: int = 30               # epochs
    elr_gamma: float = 0.999992       # per step
    onecycle_total_steps: int = 120_000
    grad_clip: float = 0.5
    skip_nonfinite: bool = True


def _piecewise_cosine(init: float, boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_interpolate_schedule('cosine', ...)."""
    bounds, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = (0,) + bounds
    values = [init]
    for s in scales:
        values.append(values[-1] * s)

    def schedule(count):
        for i in range(len(bounds) - 1):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if count >= bounds[-1] else 0.0

    return schedule


def build_schedule(cfg: OptimConfig) -> Schedule:
    """count -> lr: warm-up, then the configured decay."""
    base = cfg.lr
    if cfg.scheduler == "multistep":
        steps = sorted({int(m * cfg.steps_per_epoch): cfg.mslr_gamma
                        for m in cfg.mslr_milestones}.items())

        def decay(count):
            v = base
            for boundary, scale in steps:
                if count >= boundary:
                    v *= scale
            return v
    elif cfg.scheduler == "cosine":
        t_max = cfg.cosa_tmax * cfg.steps_per_epoch

        def decay(count):
            return base * 0.5 * (1 + math.cos(math.pi * min(count, t_max) / t_max))
    elif cfg.scheduler == "exponential":
        rate = float(np.float32(cfg.elr_gamma))  # optax's rate is a float32

        def decay(count):
            return base if count <= 0 else base * rate ** count
    elif cfg.scheduler == "onecycle":
        T = cfg.onecycle_total_steps
        decay = _piecewise_cosine(base / 25.0, {int(0.01 * T): 25.0,
                                                int(T): 1.0 / (25.0 * 1e4)})
    else:
        def decay(count):
            return base

    W = cfg.warmup_steps
    if W <= 0 or cfg.scheduler == "onecycle":
        return decay
    if cfg.warmup_type == "constant":
        def warm(count):
            return base * max(cfg.warmup_ratio, 1e-8)
    else:
        def warm(count):
            frac = 1 - min(max(count, 0), W) / W
            return (base * cfg.warmup_ratio - base) * frac + base
    return lambda count: warm(count) if count < W else decay(count - W)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all the tensors (float32)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class FarOptimizer:
    """The JAX package's ``build_optimizer`` over torch's Adam/AdamW; the
    ``torch.optim`` interface (``zero_grad``, ``step``, ``state_dict``).
    ``step`` returns whether the update was applied."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig):
        self.cfg = cfg
        self.params = list(params)
        self.schedule = build_schedule(cfg)
        if cfg.optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.params, lr=0.0, eps=1e-8,
                                           weight_decay=cfg.adamw_decay)
        else:
            self.inner = torch.optim.Adam(self.params, lr=0.0, eps=1e-8)
        self.count = 0            # updates applied: Adam's and the schedule's count
        self.notfinite_count = 0  # consecutive non-finite gradients

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self) -> bool:
        cfg = self.cfg
        for p in self.params:   # a parameter the loss does not reach: zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if cfg.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            if not finite and self.notfinite_count <= MAX_CONSECUTIVE_ERRORS:
                return False
        if cfg.grad_clip:
            norm = global_norm(grads)
            if not bool(norm < cfg.grad_clip):
                for g in grads:
                    g.div_(norm).mul_(cfg.grad_clip)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        decay = cfg.adam_decay if cfg.optimizer != "adamw" else 0.0
        before = [p.clone() for p in self.params] if decay else None
        self.inner.step()
        if decay:
            for p, b in zip(self.params, before):
                p.add_(b, alpha=decay)
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "notfinite_count": self.notfinite_count}

    def load_state_dict(self, state: Dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])


def build_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter]) -> FarOptimizer:
    return FarOptimizer(params, cfg)
