"""Training logger and TensorBoard scalar/image dumps: the port's copy of
``dkt_stereo_tpu/utils/logging.py``.

The ``Logger`` of tools/ft_dkt.py:66-112 (running means over SUM_FREQ=100
steps, divided by the window's actual length) and ``save_scalars`` /
``save_images`` of utils/experiment.py:61-90. TensorBoard through torch's
``SummaryWriter`` where it imports; otherwise a JSONL event log,
``metrics.jsonl`` in the log directory."""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)


class _JsonlWriter:
    """Minimal SummaryWriter stand-in: scalars to metrics.jsonl."""

    def __init__(self, log_dir):
        os.makedirs(log_dir or ".", exist_ok=True)
        self.path = os.path.join(log_dir or ".", "metrics.jsonl")
        self._f = open(self.path, "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "t": time.time()}) + "\n")
        self._f.flush()

    def add_image(self, tag, img, step, dataformats="CHW"):
        pass  # images only supported with a real TB writer

    def close(self):
        self._f.close()


def make_writer(log_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception as e:  # no (working) TensorBoard here: log to JSONL
        logger.warning("TensorBoard writer unavailable (%r); logging to metrics.jsonl", e)
        return _JsonlWriter(log_dir)


class Logger:
    """tools/ft_dkt.py:66-112: push per-step metric dicts, emit running means
    every SUM_FREQ steps, write validation dicts directly."""

    SUM_FREQ = 100

    def __init__(self, save_root=None, get_lr=None, start_step=0):
        self.save_root = save_root
        self.get_lr = get_lr or (lambda: float("nan"))
        # resumed runs log at their true global step (otherwise post-resume
        # scalars restart at 0 and interleave with pre-preemption history)
        self.total_steps = start_step
        self._window = 0
        self.running_loss: dict[str, float] = {}
        self.writer = make_writer(save_root)

    def _print_training_status(self):
        # divide by the ACTUAL window length: the reference divides its
        # 99-push first window by SUM_FREQ=100, biasing the first means low
        # by 1% (ft_dkt.py:74-84 — bug fixed, README'd)
        n = max(1, self._window)
        keys = sorted(self.running_loss)
        means = [self.running_loss[k] / n for k in keys]
        status = f"[{self.total_steps + 1:6d}, {self.get_lr():10.7f}] " + ", ".join(
            f"{m:10.4f}" for m in means
        )
        logger.info("Training Metrics (%d): %s", self.total_steps, status)
        for k in keys:
            self.writer.add_scalar(k, self.running_loss[k] / n, self.total_steps)
            self.running_loss[k] = 0.0

    def push(self, metrics: dict):
        self.total_steps += 1
        self._window += 1
        for k, v in metrics.items():
            self.running_loss[k] = self.running_loss.get(k, 0.0) + float(v)
        if self.total_steps % Logger.SUM_FREQ == Logger.SUM_FREQ - 1:
            self._print_training_status()
            self.running_loss = {}
            self._window = 0

    def write_dict(self, results: dict):
        for k, v in results.items():
            self.writer.add_scalar(k, v, self.total_steps)

    def close(self):
        self.writer.close()


def save_scalars(writer, mode_tag, scalar_dict, global_step):
    """utils/experiment.py:61-72."""
    for tag, values in scalar_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            scalar_name = f"{mode_tag}/{tag}" + ("" if len(values) == 1 else f"_{idx}")
            writer.add_scalar(scalar_name, float(np.asarray(value)), global_step)


def save_images(writer, mode_tag, images_dict, global_step):
    """utils/experiment.py:73-90: first image of each batch, value range
    normalized to [0,255], CHW."""
    for tag, values in images_dict.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        for idx, value in enumerate(values):
            arr = np.asarray(value, np.float32)
            if arr.ndim == 3:  # (B,H,W) -> add channel
                arr = arr[:, None]
            img = arr[0]  # first in batch, (C,H,W)
            lo, hi = img.min(), img.max()
            if hi > lo:
                img = (img - lo) / (hi - lo) * 255.0
            name = f"{mode_tag}/{tag}" + ("" if len(values) == 1 else f"_{idx}")
            writer.add_image(name, img.astype(np.uint8), global_step, dataformats="CHW")
