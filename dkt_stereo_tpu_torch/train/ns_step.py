"""The NeRF-Stereo training step (``dkt_stereo_tpu/train/ns_step.py``):
supervised fine-tuning on rendered triplets, with binocular samples beside
them in a static split.

One call of the step function:
  1. EMA <- lerp(EMA, student), before the forward, so that a model trained
     this way starts a DKT fine-tune with its EMA;
  2. the student's train-mode forward on the stacked ``im1_forward`` /
     ``im2_forward`` (``nb`` binocular rows, then ``nt`` trinocular rows),
     passed a fresh U(0, 1) blend weight for ``mix_fmap_image`` (the JAX
     step's ``mix`` rng; other models and modes ignore it);
  3. ``sequence_loss_raft`` on the binocular predictions plus ``ns_loss``
     (confidence-weighted L1 and the trinocular photometric term) on the
     trinocular ones, and the backward;
  4. when ``ok`` (finite targets and predictions): global-norm clip at 1.0
     and AdamW at the OneCycle rate of the applied-step count. Otherwise the
     parameters, the optimizer state and the schedule position stay as they
     were, while the step count and the EMA of 1. advance, as in the JAX
     step.

The state is the DKT step's (``train/dkt_step.py::create_dkt_state``); the
frozen teacher is not read. The model must give RAFT's ``disp_preds``.
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.dkt.ema import ema_update
from dkt_stereo_tpu_torch.losses.nerf import ns_loss
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
from dkt_stereo_tpu_torch.parallel.mesh import rank_and_size, reduce_step
from dkt_stereo_tpu_torch.train.state import (
    DKTHyperParams,
    DKTTrainState,
    applied_step_count,
    apply_update_,
    make_schedule,
    student_params,
)


def make_ns_train_step(config: dict, hyper: DKTHyperParams, nb: int, nt: int,
                       conf_threshold: float = 0.5, disp_threshold: float = 512.0,
                       alpha_photometric: float = 0.1, num_hosts: int | None = None):
    """Returns ``step_fn(state, batch, generator=None, mix_weight=None,
    mark=None) -> (state, metrics)``.

    ``batch`` is ``data/triplet.py::collate_mixed``'s on the state's device:
    ``im1_forward``/``im2_forward`` (nb + nt, H, W, 3), ``bi: {flow,
    valid}`` (nb, H, W), ``tri: {flow, conf}`` (nt, H, W) and ``tri: {im0,
    im1, im2}`` (nt, H, W, 3). ``nb``/``nt`` are the loader's static split
    of the global batch. ``num_hosts`` (by default the process group's size,
    1 without one) must be that size: each rank then holds ``nb /
    num_hosts`` binocular rows and then ``nt / num_hosts`` trinocular ones,
    its block of the JAX step's host-block order
    (``data/loader.py::MixedStereoLoader`` with ``num_hosts``), and the
    losses divide by global counts; the gradients and loss values are
    summed over the ranks and ``ok`` agreed before the update.
    ``mix_weight`` fixes the student's blend weight; otherwise it is one
    U(0, 1) draw a step from ``generator`` (the same on every rank), or from
    the global generator without one.
    ``mark(name)``, when given, is called as each part has been issued
    ("ema", "forward", "loss", "backward", "optimizer"). ``metrics`` are
    Python floats: ``bi_*`` (the binocular loss's epe, 1px, 3px, 5px),
    epe, 1px, 3px, 5px (the trinocular ones when nt > 0), ns_loss, loss,
    ok, learning_rate."""
    if nb < 0 or nt < 0 or nb + nt == 0:
        raise ValueError(f"modality split nb={nb}/nt={nt}")
    size = rank_and_size()[1]
    if num_hosts is None:
        num_hosts = size
    if num_hosts != size:
        raise ValueError(f"num_hosts={num_hosts} needs a process group of {num_hosts} ranks "
                         f"(this process is in one of {size})")
    if nb % num_hosts or nt % num_hosts:
        raise ValueError(f"modality split nb={nb}/nt={nt} must divide across {num_hosts} "
                         "ranks (each rank's rows need the same static composition)")
    nb, nt = nb // num_hosts, nt // num_hosts  # this rank's rows of each modality
    schedule = make_schedule(hyper)

    def step_fn(state: DKTTrainState, batch: dict, generator=None, mix_weight=None, mark=None):
        mark = mark or (lambda name: None)
        student, optimizer = state.student, state.optimizer

        ema_update(state.ema, student, hyper.ema_decay)
        mark("ema")

        optimizer.zero_grad(set_to_none=True)
        if mix_weight is None:
            src = generator.device if generator is not None else batch["im1_forward"].device
            mix_weight = torch.rand((), generator=generator, device=src)
        preds = student(batch["im1_forward"], batch["im2_forward"],
                        mix_weight=mix_weight)["disp_preds"]
        mark("forward")
        loss = torch.zeros((), device=preds.device)
        ok = torch.ones((), dtype=torch.bool, device=preds.device)
        values = {}
        if nb:
            loss_bi, m_bi, _, ok_bi = sequence_loss_raft(preds[:, :nb], batch["bi"]["flow"],
                                                         batch["bi"]["valid"])
            loss, ok = loss + loss_bi, ok & ok_bi
            values.update({f"bi_{k}": v for k, v in m_bi.items()})
            values.update(m_bi)  # the trinocular metrics replace these when nt > 0
        if nt:
            tri = batch["tri"]
            loss_tri, m_tri, _, ok_tri = ns_loss(
                preds[:, nb:], tri["flow"], tri["conf"], tri["im0"], tri["im1"], tri["im2"],
                alpha_photometric=alpha_photometric, conf_threshold=conf_threshold,
                max_flow=disp_threshold)
            loss, ok = loss + loss_tri, ok & ok_tri
            values.update(m_tri)
            values["ns_loss"] = loss_tri
        mark("loss")
        loss.backward()
        mark("backward")

        values["loss"] = loss
        applied, values = reduce_step(student_params(optimizer), ok, values)
        lr = schedule(applied_step_count(optimizer))
        if applied:
            apply_update_(optimizer, lr)
        else:
            optimizer.zero_grad(set_to_none=True)
        mark("optimizer")

        with torch.no_grad():
            numbers = torch.stack([v.detach().float() for v in values.values()]).tolist()
        metrics = dict(zip(values, numbers), ok=float(applied), learning_rate=lr)
        state.step += 1
        return state, metrics

    return step_fn
