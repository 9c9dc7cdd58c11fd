"""Train state and optimizer of the DKT fine-tune loop
(``dkt_stereo_tpu/train/state.py``).

Optimizer parity with the JAX package (tools/ft_dkt.py:56-63, 244):
gradients clipped to global norm 1.0 with optax's formula, then AdamW
(beta 0.9/0.999, eps 1e-8, weight decay ``wdecay``) at the learning rate of
a linear OneCycle schedule read at the count of *applied* steps. A step
skipped for a non-finite loss leaves the parameters, the optimizer state and
the schedule position as they were.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class DKTHyperParams:
    """CLI defaults from tools/ft_dkt.py:312-344 (the JAX package's fields
    and defaults)."""

    lr: float = 2e-4
    wdecay: float = 1e-5
    num_steps: int = 200_000
    train_iters: int = 16
    valid_iters: int = 32
    teacher_iters: int = 32  # hardcoded at ft_dkt.py:193,199
    ema_decay: float = 0.99999
    tau_gt: float = 3.0
    tau_pl: float = 3.0
    clamp: float = 1.0
    pl_weight: float = 1.0  # ft_dkt.py:234 "loss_PL * 1.0"
    cascade_train: bool = False
    batched_teachers: bool = False


def onecycle_linear(max_lr: float, total_steps: int, pct_start: float = 0.01):
    """torch's OneCycleLR(anneal_strategy='linear', three_phase=False) with
    its exact phase arithmetic, evaluated in fp32 as the JAX package does:
    warm-up from max/25 peaks at step ``pct_start*total - 1``, then the
    anneal reaches max/25/1e4 at step ``total - 1``. ``schedule(count)``
    takes an int or an integer array and returns float(s)."""
    f32 = np.float32
    init = max_lr / 25.0
    min_lr = init / 1e4
    b1 = max(float(pct_start * total_steps) - 1.0, 1e-9)
    span = max(float(total_steps - 1) - b1, 1e-9)
    init_, max_, b1_, span_ = f32(init), f32(max_lr), f32(b1), f32(span)
    rise, fall = f32(max_lr - init), f32(min_lr - max_lr)

    def schedule(count):
        s = np.asarray(count, np.float32)
        up = init_ + rise * np.clip(s / b1_, f32(0), f32(1))
        down = max_ + fall * np.clip((s - b1_) / span_, f32(0), f32(1))
        lr = np.where(s <= b1_, up, down).astype(np.float32)
        return float(lr) if lr.ndim == 0 else lr

    return schedule


def make_schedule(hyper: DKTHyperParams):
    """The OneCycle schedule of the run: ``num_steps + 100`` steps
    (ft_dkt.py:60)."""
    return onecycle_linear(hyper.lr, hyper.num_steps + 100)


def make_optimizer(student: nn.Module, hyper: DKTHyperParams):
    """AdamW over the student's parameters and the schedule that sets its
    learning rate before each applied step."""
    schedule = make_schedule(hyper)
    opt = torch.optim.AdamW(student.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hyper.wdecay)
    return opt, schedule


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float = 1.0) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every ``g`` is divided by
    ``max(norm, max_norm) / max_norm``, which for ``max_norm = 1`` is
    optax's ``g`` below the norm and ``(g / norm) * 1`` above it, to the bit.
    (torch's ``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
    instead.) A handful of foreach launches, no host synchronisation.
    Returns the norm before clipping."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_div_(grads, norm.clamp_min(max_norm) / max_norm)
    return norm


def student_params(optimizer: torch.optim.Optimizer) -> list:
    """The parameters the optimizer steps, in its order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def apply_update_(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The optimizer chain of an applied step: a parameter the forward did
    not use gets a zero gradient (JAX's), the gradients are clipped to
    global norm 1.0, then AdamW steps at ``lr``."""
    params = student_params(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in params], 1.0)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()


def applied_step_count(optimizer: torch.optim.Optimizer) -> int:
    """Number of applied optimizer steps: AdamW's own step count. It differs
    from ``DKTTrainState.step`` once steps were skipped (ok=False), so the
    schedule position is read here."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st:
                return int(st["step"])
    return 0


@dataclasses.dataclass
class DKTTrainState:
    """Student, EMA teacher, frozen teacher and the student's optimizer.

    The frozen teacher (restore_ckpt_T, ft_dkt.py:144-151) never changes; the
    EMA teacher lerps toward the student every step (:179-181). ``step``
    counts attempted steps."""

    student: nn.Module
    ema: nn.Module
    teacher: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def applied_steps(self) -> int:
        return applied_step_count(self.optimizer)
