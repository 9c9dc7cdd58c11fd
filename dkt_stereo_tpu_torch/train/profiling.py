"""Tracing and step timing (``dkt_stereo_tpu/train/profiling.py``) on
``torch.profiler``.

  - :func:`trace` traces its block: host operations, and the device's
    kernels when the device is CUDA.
  - :class:`TraceWindow` traces a window of training steps, each step a
    ``ProfilerStep#<step>`` range named by its global step, as
    ``cli/train.py --profile_dir`` takes it.
  - :class:`StepTimer` is the JAX class: steps per second with the first
    ``warmup`` samples left out (the reference's FPS protocol,
    tools/evaluate_stereo.py:128-133).

A trace is written as Chrome trace JSON, ``<host>_<pid>.<ms>.pt.trace.json``
in the given directory: the name and format TensorBoard's profiler plugin
reads, and what ``chrome://tracing`` or Perfetto open without it. JAX's
``start_server`` (a live endpoint for TensorBoard to attach to) has no
PyTorch counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _activities(device) -> list:
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, logdir) -> str:
    """Write ``prof``'s trace into ``logdir``; returns the file's path."""
    os.makedirs(logdir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    path = os.path.join(logdir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Trace the block into ``logdir``; the device's kernels too when
    ``device`` is CUDA (the device is synchronized before the trace
    stops). Yields the profiler."""
    dev = torch.device(device)
    with profile(activities=_activities(dev)) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    _export(prof, logdir)


class TraceWindow:
    """A trace of the training steps ``[first, first + steps)``: the loop
    calls :meth:`step` around each step with its global step number, and
    :meth:`close` once a step at or past ``last`` is done (outside the
    step's own timing: writing a trace of two full-size steps takes
    seconds) and at its end. The profiler starts with the window's first
    step; each step in it is the range ``ProfilerStep#<step>``; the device
    is synchronized before the trace stops. A window that the loop never
    reaches writes nothing; one that runs past the loop's end is written by
    the final :meth:`close` with the steps it holds. ``path`` is the
    written trace."""

    def __init__(self, logdir: str, first: int, steps: int, device):
        if steps < 1:
            raise ValueError(f"--profile_steps must be at least 1, got {steps}")
        self.logdir, self.first, self.last = logdir, first, first + steps
        self.device = torch.device(device)
        self.path = None
        self._prof = None

    @contextlib.contextmanager
    def step(self, step: int):
        if self._prof is None and step == self.first and self.path is None:
            self._prof = profile(activities=_activities(self.device))
            self._prof.start()
        if self._prof is None or step >= self.last:
            yield
            return
        with record_function(f"ProfilerStep#{step}"):
            yield

    def close(self) -> None:
        """Stop a running trace and write it (a no-op otherwise)."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        self.path = _export(prof, self.logdir)


class StepTimer:
    """Running steps/s with the first ``warmup`` samples excluded."""

    def __init__(self, warmup: int = 50):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def steps_per_sec(self) -> float:
        n = self.count - self.warmup
        return n / self.total if n > 0 and self.total > 0 else float("nan")
