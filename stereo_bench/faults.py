"""Faults planted in the program underneath a run, to show that the
correctness check fails them: the tests use them at a small size on the
CPU, ``calibrate`` at a cell's own size on the card (a fault's readings
bound a limit from above where the control does not).

- ``altered``: every answer is changed where it is produced (a frame's
  disparity offset by 1 px; a DKT step's loss scaled by 1.5);
- ``half_batch``: the program computes half of each batch and reuses it
  for the rest (frames), or steps on the first half alone, its mean over
  those rows (DKT);
- ``unchanged``: the DKT step runs as it does and returns the student's
  weights as they were before it;
- ``no_bias``: the program's models run without their convolutions'
  biases (zeroed as the model is handed to the program);
- ``bn_stats``: the program's batch norms ignore their running statistics
  (mean 0 and variance 1 in their place), as a wrong fold of frozen batch
  norm would;
- ``teacher_off``: both DKT teachers' disparity is moved by its own
  largest magnitude where it is produced;
- ``ema_frozen``: the DKT step leaves the EMA teacher as it was.
"""

from __future__ import annotations

import contextlib

import torch

MODEL_FAULTS = ("no_bias", "bn_stats")
FRAME_FAULTS = ("altered", "half_batch", *MODEL_FAULTS)
STEP_FAULTS = ("altered", "half_batch", "unchanged", *MODEL_FAULTS, "teacher_off", "ema_frozen")


@contextlib.contextmanager
def _patched(module, name, wrap):
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


@torch.no_grad()
def _break_model(model, kind):
    for m in model.modules():
        if kind == "no_bias" and isinstance(m, torch.nn.modules.conv._ConvNd) \
                and m.bias is not None:
            m.bias.zero_()
        if kind == "bn_stats" and isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def _shift_by_scale(forward):
    def shifted(*args, **kwargs):
        coarse, disp = forward(*args, **kwargs)
        return coarse, disp + disp.abs().amax()

    return shifted


def _broken_state(kind):
    def wrap(create_dkt_state):
        def make(*args, **kwargs):
            state = create_dkt_state(*args, **kwargs)
            for model in (state.student, state.ema, state.teacher):
                if kind in MODEL_FAULTS:
                    _break_model(model, kind)
            if kind == "teacher_off":
                for model in (state.ema, state.teacher):
                    model.forward = _shift_by_scale(model.forward)
            return state

        return make

    return wrap


def _broken_forward(kind):
    def wrap(make_forward_fn):
        def make(model, device=None):
            if kind in MODEL_FAULTS:
                return make_forward_fn(_break_model(model, kind), device)
            forward = make_forward_fn(model, device)

            def broken(x1, x2):
                if kind == "altered":
                    return forward(x1, x2) + 1.0
                half = max(x1.shape[0] // 2, 1)
                out = forward(x1[:half], x2[:half])
                return out.repeat((x1.shape[0] + half - 1) // half, 1, 1)[:x1.shape[0]]

            broken.device = forward.device
            return broken

        return make

    return wrap


def _broken_step(kind):
    def wrap(make_dkt_train_step):
        def make(config, hyper):
            step = make_dkt_train_step(config, hyper)

            def broken(state, batch, generator=None, draws=None, mark=None):
                if kind == "half_batch":
                    half = max(batch["img1"].shape[0] // 2, 1)
                    batch = {k: v[:half] for k, v in batch.items()}
                    draws = {**draws, "filter_gt": draws["filter_gt"][:half]}
                if kind == "unchanged":
                    saved = {k: v.detach().clone() for k, v in state.student.state_dict().items()}
                state, metrics = step(state, batch, generator=generator, draws=draws, mark=mark)
                if kind == "unchanged":
                    with torch.no_grad():
                        state.student.load_state_dict(saved)
                if kind == "altered":
                    metrics = {**metrics, "loss": 1.5 * metrics["loss"]}
                return state, metrics

            return broken

        return make

    return wrap


@contextlib.contextmanager
def planted(kind: str | None):
    """Inside, the program's frame entry and DKT step carry fault ``kind``
    (None: no fault)."""
    if kind is None:
        yield
        return
    from dkt_stereo_tpu_torch.eval import validate
    from dkt_stereo_tpu_torch.train import dkt_step

    with contextlib.ExitStack() as stack:
        if kind in FRAME_FAULTS:
            stack.enter_context(_patched(validate, "make_forward_fn", _broken_forward(kind)))
        if kind in ("altered", "half_batch", "unchanged"):
            stack.enter_context(_patched(dkt_step, "make_dkt_train_step", _broken_step(kind)))
        if kind in (*MODEL_FAULTS, "teacher_off"):
            stack.enter_context(_patched(dkt_step, "create_dkt_state", _broken_state(kind)))
        if kind == "ema_frozen":
            stack.enter_context(_patched(dkt_step, "ema_update", lambda f: lambda *a, **k: None))
        yield
