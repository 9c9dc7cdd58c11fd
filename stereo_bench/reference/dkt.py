"""The DKT teacher-student step (the DKT paper's tools/ft_dkt.py:177-248), in
plain PyTorch over a model reference (:mod:`stereo_bench.harness`: the
module that a configuration's ``reference`` names, with its ``build``,
``disparity``, ``train_forward`` and ``train_loss``).

One step: the EMA teacher lerps toward the student; the frozen teacher and
the EMA teacher predict on the clean pair in test mode; F&E filters and
ensembles the ground truth (with its per-image re-admission draw and a 1 px
clamp) and the frozen teacher's pseudo-label against the EMA's; the student
predicts on the augmented pair in train mode, ``loss = loss_GT + loss_PL``,
each the model's training loss (RAFT's: the gamma-weighted L1 sequence
loss over the valid pixels); when
ground truth and predictions are finite the gradients (zeros for unused
parameters) are clipped to global norm 1 and AdamW (0.9, 0.999, eps 1e-8,
decoupled decay) steps at the linear OneCycle rate of the applied-step
count. Batch norm stays frozen.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    """tools/ft_dkt.py:312-344's defaults."""

    lr: float = 2e-4
    wdecay: float = 1e-5
    num_steps: int = 200_000
    train_iters: int = 16
    teacher_iters: int = 32
    ema_decay: float = 0.99999
    tau: float = 3.0
    clamp: float = 1.0


def onecycle(count: int, hyper: Hyper, pct_start: float = 0.01) -> float:
    """torch's linear, two-phase OneCycleLR over ``num_steps + 100`` steps."""
    total = hyper.num_steps + 100
    init = hyper.lr / 25.0
    peak_at = max(pct_start * total - 1.0, 1e-9)
    if count <= peak_at:
        return init + (hyper.lr - init) * min(count / peak_at, 1.0)
    span = max(total - 1.0 - peak_at, 1e-9)
    return hyper.lr + (init / 1e4 - hyper.lr) * min((count - peak_at) / span, 1.0)


def fande_filter(source, target, valid, u=None, threshold=3.0):
    """Keep source pixels within ``threshold`` of target; with draws ``u``
    (the GT path) image b re-admits all its inconsistent valid pixels when
    ``u[b]`` is below its consistent share."""
    valid = valid.float()
    consistent = ((target - source).abs() < threshold).float() * valid
    if u is None:
        new_valid = consistent
    else:
        share = consistent.flatten(1).sum(-1) / valid.flatten(1).sum(-1).clamp_min(1.0)
        readmit = (u < share).float()[:, None, None] * (1.0 - consistent) * valid
        new_valid = (consistent + (1.0 - consistent) * readmit) * valid
    return source * valid * new_valid, new_valid


def fande_ensemble(source, target, valid, prob, clamp=None, threshold=3.0):
    """Where consistent, move source toward target by ``prob * |s - t|``
    (at most ``clamp``)."""
    valid = valid.float()
    consistent = ((target - source).abs() < threshold).float() * valid
    source, target = source * valid, target * valid
    offset = prob * (source - target).abs()
    if clamp is not None:
        offset = offset.clamp_max(clamp)
    return (source + torch.sign(target - source) * offset * consistent) * valid


class DKTReference:
    """Student, EMA and frozen teacher of model reference ``ref`` from one
    state dict, and AdamW's state. ``precision`` as the model's
    ``set_precision`` takes it."""

    def __init__(self, ref, config: dict, state_dict: dict, hyper: Hyper, device,
                 precision: str = "fp32", remat: bool = True):
        def model():
            m = ref.build(config).to(device)
            m.load_state_dict(state_dict, strict=True)
            return m.set_precision(precision)

        self.ref = ref
        self.student, self.ema, self.teacher = model(), model(), model()
        for m in (self.ema, self.teacher):
            m.requires_grad_(False)
        self.hyper, self.remat = hyper, remat
        self.params = dict(self.student.named_parameters())
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.applied = 0

    @torch.no_grad()
    def _ema(self):
        d = self.hyper.ema_decay
        pairs = list(zip(self.ema.parameters(), self.student.parameters()))
        pairs += [(t, s) for t, s in zip(self.ema.buffers(), self.student.buffers())
                  if t.is_floating_point()]
        for t, s in pairs:
            t.mul_(d).add_(s, alpha=1.0 - d)

    def step(self, batch: dict, draws: dict) -> dict:
        """One step; returns ``loss``, ``ok``, the clipped gradients by
        parameter name (``grads``) and the EMA teacher's largest |disparity|
        (``teacher_px``)."""
        h, ref = self.hyper, self.ref
        self._ema()
        with torch.no_grad():
            disp_pl = ref.disparity(self.teacher, batch["img1_clean"], batch["img2_clean"],
                                    h.teacher_iters)
            disp_ema = ref.disparity(self.ema, batch["img1_clean"], batch["img2_clean"],
                                     h.teacher_iters)
        gt, valid_gt = fande_filter(batch["flow"], disp_ema, batch["valid"], draws["filter_gt"],
                                    h.tau)
        gt = fande_ensemble(gt, disp_ema, valid_gt, draws["ensemble_gt"], h.clamp, h.tau)
        pl, valid_pl = fande_filter(disp_pl, disp_ema, torch.ones_like(disp_pl), None, h.tau)
        pl = fande_ensemble(pl, disp_ema, valid_pl, draws["ensemble_pl"], None, h.tau)

        for p in self.params.values():
            p.grad = None
        preds = ref.train_forward(self.student, batch["img1"], batch["img2"], h.train_iters,
                                  remat=self.remat)
        loss_gt, ok_gt = ref.train_loss(preds, gt, valid_gt)
        loss_pl, ok_pl = ref.train_loss(preds, pl, valid_pl)
        loss = loss_gt + loss_pl
        loss.backward()
        ok = ok_gt and ok_pl
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in self.params.items()}
        if ok:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
            scale = norm.clamp_min(1.0)
            grads = {k: g / scale for k, g in grads.items()}
            self._adamw(grads, onecycle(self.applied, h))
        return {"loss": float(loss.detach()), "ok": ok, "grads": grads,
                "teacher_px": float(disp_ema.abs().max()),
                "loss_parts": [float(loss_gt.detach()), float(loss_pl.detach())]}

    @torch.no_grad()
    def _adamw(self, grads, lr):
        self.applied += 1
        t = self.applied
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1.0 - lr * self.hyper.wdecay)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k] / (1.0 - b2**t)).sqrt() + eps
            p.addcdiv_(self.m[k], denom, value=-lr / (1.0 - b1**t))
