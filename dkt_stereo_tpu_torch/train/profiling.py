"""Tracing (``dkt_stereo_tpu/train/profiling.py``) on ``torch.profiler``.

  - :func:`span` marks a stage of the program (a frame's forward, a RAFT
    iteration, a part of the DKT step). With no profiler running it costs
    one flag read and records nothing; while one runs, the span is a
    ``record_function`` range in the profiler's trace and is kept in
    memory, with its parent and its unit, for :func:`take_spans`.
  - :class:`TraceWindow` traces a window of training steps, each step a
    ``ProfilerStep#<step>`` range named by its global step, as
    ``cli/train.py --profile_dir`` takes it.

A trace is written as Chrome trace JSON, ``<host>_<pid>.<ms>.pt.trace.json``
in the given directory: the name and format TensorBoard's profiler plugin
reads, and what ``chrome://tracing`` or Perfetto open without it. JAX's
``start_server`` (a live endpoint for TensorBoard to attach to) has no
PyTorch counterpart and is not ported; nor are its ``trace`` and
``StepTimer``, which no path of the port uses.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    """A finished span: its name, its start and end on
    ``time.perf_counter_ns``'s clock, its id, its parent's id (None for a
    root) and its unit, ``"<root's name>#<key>"``: the key a root was given
    (a DKT step's number), else the root's own id. Spans of one frame or
    one step share the unit."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    unit: str


class _Recorder:
    """The spans finished while a profiler ran (``done``) and those open now,
    innermost last (``open``). One stack serves every thread: the autograd
    engine runs a backward (remat's recomputed iterations) on its device
    thread while the caller waits inside its own span."""

    def __init__(self):
        self.done: list[Span] = []
        self.open: list[_Recording] = []
        self.ids = itertools.count(1)


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()  # the one no-op that every span returns while no profiler runs


class _Recording:
    """One span while a profiler runs: a ``record_function`` range on the
    profiler's clock, kept in memory as a :class:`Span` when it ends."""

    __slots__ = ("name", "key", "range", "id", "parent", "unit", "start")

    def __init__(self, name: str, key):
        self.name, self.key = name, key

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        rec = _RECORDER
        self.id = next(rec.ids)
        outer = rec.open[-1] if rec.open else None
        if outer is None:
            self.parent = None
            self.unit = f"{self.name}#{self.id if self.key is None else self.key}"
        else:
            self.parent, self.unit = outer.id, outer.unit
        rec.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = _RECORDER
        rec.open.remove(self)
        rec.done.append(Span(self.name, self.start, end, self.id, self.parent, self.unit))
        self.range.__exit__(*exc)
        return False


def span(name: str, unit=None):
    """A stage of the program, as a context manager: ``with span("raft.iter"):``.
    While no ``torch.profiler`` session runs, one read of PyTorch's flag
    and the shared no-op: nothing is entered, allocated or kept. While one
    runs, a ``record_function(name)`` range and a :class:`Span` for
    :func:`take_spans`. A span opened inside another is its child and
    shares its unit; a root span opens a unit, keyed by ``unit`` when given
    (a DKT step's number) and else by its own id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, unit)


def take_spans() -> list[Span]:
    """The spans finished while a profiler ran, since the last call or the
    opening of a :class:`TraceWindow`, in the order they ended; the buffer
    is emptied."""
    out, _RECORDER.done = _RECORDER.done, []
    return out


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
            take_spans()  # the window's spans alone, whatever an earlier profiler left
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
