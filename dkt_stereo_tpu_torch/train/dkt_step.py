"""The DKT teacher-student fine-tune step (``dkt_stereo_tpu/train/dkt_step.py``;
tools/ft_dkt.py:177-248).

One call of the step function:
  1. EMA teacher <- lerp(EMA, student), before the forwards (:179-181);
  2. the frozen teacher, then the EMA teacher, predict in test mode at
     ``teacher_iters`` on the clean pair, without gradients (:191-201);
     with ``batched_teachers`` both in one forward vmapped over their
     stacked weights (:func:`batched_teachers`);
  3. F&E on the GT (``withprob`` and ``clamp``) and on the pseudo-label
     (plain) (:204-210);
  4. the student's train-mode forward on the augmented pair at
     ``train_iters``, ``loss = loss_GT + pl_weight * loss_PL`` (:227-234),
     and its backward;
  5. when ``ok`` (finite GT and predictions): global-norm clip, AdamW at
     the schedule's rate for the applied-step count (:242-248). Otherwise
     the parameters, the optimizer state and the schedule position stay as
     they were, while the EMA update of 1. stands, as in the JAX step.

Data parallel: in a process group (``parallel/mesh.py``) each rank runs the
step on its rows of the global batch with the same state. The losses divide
by global counts, the gradients and loss values are summed over the ranks
and ``ok`` is agreed before 5., so every rank applies the same update. The
F&E draws of the global batch are made on every rank from one generator
(each rank passes one seeded alike) and each rank takes its rows: N ranks
give one process's step on the global batch.

The state is updated in place. Batch norm is frozen throughout
(``nn/norms.py::FrozenBatchNorm2d``): its running statistics are buffers
that nothing writes, its affine parameters train.
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.dkt.ema import ema_update
from dkt_stereo_tpu_torch.dkt.fande import fande_ensemble, fande_filter
from dkt_stereo_tpu_torch.models.registry import create_model, get_model, make_loss_adapter
from dkt_stereo_tpu_torch.nn.precision import vmapped
from dkt_stereo_tpu_torch.parallel.mesh import rank_and_size, reduce_step
from dkt_stereo_tpu_torch.train.state import (
    DKTHyperParams,
    DKTTrainState,
    applied_step_count,
    apply_update_,
    make_optimizer,
    make_schedule,
    student_params,
)


def create_dkt_state(config: dict, hyper: DKTHyperParams, seed: int | None = 0, params=None,
                     teacher_params=None, device=None) -> DKTTrainState:
    """Student, EMA and frozen teacher of the model ``config`` names, on
    ``device`` (the GPU unless ``device="cpu"`` is passed). The student
    takes ``params`` (a state dict) or random weights from ``seed``; the EMA
    starts as its copy and the teacher takes ``teacher_params`` or the same
    weights (ft_dkt.py:139-150). The student runs in train mode at
    ``train_iters``; the teachers in test mode at ``teacher_iters`` with
    their parameters frozen."""
    dev = resolve_device(device)
    student = create_model(config, hyper.train_iters, dev, None if params is not None else seed,
                           test_mode=False)
    if params is not None:
        student.load_state_dict(params, strict=True)

    def frozen_copy(state_dict):
        m = create_model(config, hyper.teacher_iters, dev, test_mode=True)
        m.load_state_dict(state_dict, strict=True)
        return m.requires_grad_(False)

    ema = frozen_copy(student.state_dict())
    teacher = frozen_copy(teacher_params if teacher_params is not None else student.state_dict())
    optimizer, _ = make_optimizer(student, hyper)
    return DKTTrainState(student=student, ema=ema, teacher=teacher, optimizer=optimizer)


def cascade_upsample2x(out: dict) -> dict:
    """Nearest x2 upsample of a train output's fields, as the JAX package's
    ``_cascade_upsample2x``: the cascade transform the reference applies to
    ``results_dw2['disp_preds']`` (ft_dkt.py:217-219), extended to every
    model's output. Disparity-valued fields are doubled: ``disp_preds``,
    (IGEV) ``init_disp``, and in PCVNet's ``output_list`` the refined and
    per-iteration disparities, mu and sigma; the mixture weights w are
    not."""

    def up(t, ax):
        return t.repeat_interleave(2, ax).repeat_interleave(2, ax + 1)

    out = dict(out)
    for k in ("disp_preds", "init_disp"):
        if k in out:
            out[k] = 2.0 * up(out[k], out[k].dim() - 2)
    if "output_list" in out:
        refined, disp_seq, mu, w, sigma = out["output_list"]
        out["output_list"] = (2.0 * up(refined, 1), 2.0 * up(disp_seq, 2), 2.0 * up(mu, 2),
                              up(w, 2), 2.0 * up(sigma, 2))
    return out


def fande_draws(batch_size: int, device, generator: torch.Generator | None = None) -> dict:
    """The step's U(0, 1) draws, made on ``generator``'s device and moved to
    ``device``: ``filter_gt`` (B,) for the GT filter, ``ensemble_gt`` and
    ``ensemble_pl`` scalars for the two ensembles, and ``mix`` and ``mix_h``
    scalars, the image volume's weight in the student's full-resolution and
    cascade forwards under ``mix_fmap_image`` (the JAX step's ``k_mix`` and
    ``k_mix_h``)."""
    src = generator.device if generator is not None else device
    u = torch.rand(batch_size + 4, generator=generator, device=src).to(device)
    return {"filter_gt": u[:batch_size], "ensemble_gt": u[batch_size],
            "ensemble_pl": u[batch_size + 1], "mix": u[batch_size + 2],
            "mix_h": u[batch_size + 3]}


def batched_teachers(config: dict, hyper: DKTHyperParams):
    """``fn(teacher, ema, img1, img2) -> (disp_pl, disp_ema)``: the two
    teachers' test-mode disparities from ONE forward, vmapped over their
    stacked weights (``torch.func.stack_module_state``, then ``vmap`` of a
    ``functional_call``; the JAX step's ``vmap`` over the stacked trees,
    train/dkt_step.py:147-157). Convolutions batch as grouped
    convolutions; K1 folds the teacher axis into its batch, so one launch
    serves both teachers an iteration; the networks' bf16 autocast is
    applied op by op (``nn/precision.py``). The model runs with
    ``pallas_encoder`` off, as the JAX step's teachers do (:121-134): its
    parameters are the same, so the teachers' own modules feed it."""
    model_cls, cfg_cls = get_model(config["model"])
    with torch.device("meta"):
        base = model_cls(cfg_cls.from_dict({**config, "pallas_encoder": False}),
                         iters=hyper.teacher_iters, test_mode=True).eval()

    def disp(params, buffers, img1, img2):
        return torch.func.functional_call(base, (params, buffers), (img1, img2))[1]

    def fn(teacher, ema, img1, img2):
        params, buffers = torch.func.stack_module_state([teacher, ema])
        with vmapped():
            both = torch.func.vmap(disp, in_dims=(0, 0, None, None))(params, buffers, img1, img2)
        return both[0], both[1]

    fn.model = base  # the mapped module (parameters on the meta device), for hooks
    return fn


def _l2_dist(a: torch.nn.Module, b: torch.nn.Module) -> torch.Tensor:
    """Global L2 distance between two modules' parameters."""
    sq = [(x.float() - y.float()).square().sum() for x, y in zip(a.parameters(), b.parameters())]
    return torch.stack(sq).sum().sqrt()


def make_dkt_train_step(config: dict, hyper: DKTHyperParams):
    """Returns ``step_fn(state, batch, generator=None, draws=None, mark=None)
    -> (state, metrics)``.

    ``batch``: img1/img2/img1_clean/img2_clean (B, H, W, 3) in [0, 255],
    flow (B, H, W) negative disparity, valid (B, H, W) in {0, 1}, all on
    the state's device. ``draws`` (see :func:`fande_draws`) fixes the F&E
    draws and the blend weights that every student forward is passed as
    ``mix_weight`` (only RAFT's ``mix_fmap_image`` reads them; 0.5 where
    ``draws`` lacks them); otherwise they come from ``generator``. ``mark(name)``, when
    given, is called as each part of the step has been issued ("ema",
    "teachers", "fande", "student", "optimizer"), e.g. to record CUDA
    events. ``metrics`` are Python floats: loss, loss_GT, loss_PL, the loss's own
    metrics (epe, 1px, 3px, 5px; IGEV's also init_epe; PCVNet's also bad1,
    bad2, bad5 and the seven ``*_final`` ones), ema_divergence,
    teacher_divergence, ok, learning_rate."""
    if config.get("train_bn"):
        raise NotImplementedError(
            "train_bn in the DKT step: the JAX step applies the student without mutable batch "
            "statistics (dkt_stereo_tpu/train/dkt_step.py), so it does not run there either; "
            "the step freezes batch norm")
    loss_adapter = make_loss_adapter(config["model"], config, config.get("loss_func"))
    schedule = make_schedule(hyper)
    teachers = batched_teachers(config, hyper) if hyper.batched_teachers else None

    def step_fn(state: DKTTrainState, batch: dict, generator=None, draws=None, mark=None):
        mark = mark or (lambda name: None)
        student, optimizer = state.student, state.optimizer
        img1, img2 = batch["img1"], batch["img2"]
        if draws is None:
            # the global batch's draws on every rank, then this rank's rows
            rank, size = rank_and_size()
            B = img1.shape[0]
            draws = fande_draws(B * size, img1.device, generator)
            draws["filter_gt"] = draws["filter_gt"][rank * B:(rank + 1) * B]

        # 1. EMA update, before the forwards (ft_dkt.py:179)
        ema_update(state.ema, student, hyper.ema_decay)
        mark("ema")

        # 2. pseudo-labels of the frozen and the EMA teacher on the clean pair
        with torch.no_grad():
            if teachers is not None:
                disp_pl, disp_ema = teachers(state.teacher, state.ema, batch["img1_clean"],
                                             batch["img2_clean"])
            else:
                _, disp_pl = state.teacher(batch["img1_clean"], batch["img2_clean"])
                _, disp_ema = state.ema(batch["img1_clean"], batch["img2_clean"])
        mark("teachers")

        # 3. F&E
        gt_aug, valid_gt_aug = fande_filter(batch["flow"], disp_ema, batch["valid"],
                                            u=draws["filter_gt"], withprob=True,
                                            threshold=hyper.tau_gt)
        gt_aug = fande_ensemble(gt_aug, disp_ema, valid_gt_aug, prob=draws["ensemble_gt"],
                                clamp=hyper.clamp, threshold=hyper.tau_gt)
        pl_aug, valid_pl_aug = fande_filter(disp_pl, disp_ema, torch.ones_like(disp_pl),
                                            withprob=False, threshold=hyper.tau_pl)
        pl_aug = fande_ensemble(pl_aug, disp_ema, valid_pl_aug, prob=draws["ensemble_pl"],
                                clamp=False, threshold=hyper.tau_pl)
        mark("fande")

        # 4. student forward, combined loss, backward
        optimizer.zero_grad(set_to_none=True)
        flow_init = None
        loss_dw2_gt = loss_dw2_pl = 0.0
        ok_dw2 = True
        if hyper.cascade_train:
            # half-resolution pre-pass (ft_dkt.py:213-219): its last
            # prediction, at the 1/4 grid of the full-resolution pass,
            # starts that pass; its x2-upsampled outputs add 0.5-weighted
            # losses (see the JAX step for why the reference's own cascade
            # code cannot run)
            out_h = student(img1[:, ::2, ::2], img2[:, ::2, ::2], mix_weight=draws.get("mix_h"))
            flow_init = (out_h["disp_preds"][-1][:, ::2, ::2] / 2.0).detach()[..., None]
            out_h_up = cascade_upsample2x(out_h)
            loss_dw2_gt, _, _, ok_dg = loss_adapter(out_h_up, gt_aug, valid_gt_aug)
            loss_dw2_pl, _, _, ok_dp = loss_adapter(out_h_up, pl_aug, valid_pl_aug)
            ok_dw2 = ok_dg & ok_dp
        out = student(img1, img2, flow_init, mix_weight=draws.get("mix"))
        loss_gt, metrics, _, ok_gt = loss_adapter(out, gt_aug, valid_gt_aug)
        loss_pl, _, _, ok_pl = loss_adapter(out, pl_aug, valid_pl_aug)
        loss_gt = loss_gt + 0.5 * loss_dw2_gt  # (:229-233)
        loss_pl = loss_pl + 0.5 * loss_dw2_pl
        loss = loss_gt + hyper.pl_weight * loss_pl
        ok = ok_gt & ok_pl & ok_dw2
        loss.backward()
        mark("student")

        # 5. over the ranks (with a process group): the gradients and the
        # loss values summed, ok agreed; then clip + AdamW, only when ok;
        # the logged rate is the applied one
        values = {**metrics, "loss": loss.detach(), "loss_GT": loss_gt.detach(),
                  "loss_PL": loss_pl.detach()}
        applied, values = reduce_step(student_params(optimizer), ok, values)
        lr = schedule(applied_step_count(optimizer))
        if applied:
            apply_update_(optimizer, lr)
        else:
            optimizer.zero_grad(set_to_none=True)
        mark("optimizer")

        with torch.no_grad():
            values["ema_divergence"] = _l2_dist(student, state.ema)
            values["teacher_divergence"] = _l2_dist(student, state.teacher)
            numbers = torch.stack([v.float() for v in values.values()]).tolist()
        metrics = dict(zip(values, numbers), ok=float(applied), learning_rate=lr)
        state.step += 1
        return state, metrics

    return step_fn

