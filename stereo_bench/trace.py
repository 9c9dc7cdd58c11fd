"""The traced part of a run: ``torch.profiler`` over a bounded number of
units right after the measured window, reduced in memory (no trace file) to
what the per-layer readers and the breakdown need.

On the card the profiler records the device's activity alone (kernels,
copies, fills, and the CUDA runtime calls that launch them): recording
every host operation as well stretches a B=1 frame from ~114 ms to
~180 ms, and the device's idle share with it. In the CPU rehearsal it
records the host's operations.

- ``span_s``: the traced part on the host's clock, from a synchronised
  start to a synchronised end.
- ``busy_s``: the union of the device operations' intervals, so
  overlapping operations count once.
- ``kernels``: device seconds and count by operation name.
- ``device_ops``: device operations (kernels, copies, fills).
- ``launches``: the program's kernel counters over the traced part.
- ``breakdown``: the 10 operations that took most device time, and the 10
  longest idle gaps between device operations, each labelled by the
  innermost CUDA runtime call open at its middle ("host" where none was:
  the host was dispatching).
"""

from __future__ import annotations

import time

import torch

from stereo_bench import counters

def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(host, t):
    """The innermost host event open at ``t``."""
    inner = None
    for name, s, e in host:
        if s <= t <= e and (inner is None or e - s < inner[1]):
            inner = (name, e - s)
    return inner[0] if inner else "host"


def traced(run_units, units: int, device: torch.device) -> dict:
    """Profile ``run_units(units)``; the summary described above."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    before = counters.read()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run_units(units)
        if cuda:
            torch.cuda.synchronize(device)
        span = time.perf_counter() - t0
    launches = counters.diff(counters.read(), before)

    host, dev = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != DeviceType.CUDA:
            host.append((e.name, s, t))
        elif not getattr(e, "is_user_annotation", False):
            # the device's copies of host ranges are not operations
            dev.append((e.name, s, t))
    kernels = {}
    for n, s, t in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (t - s) / 1e6
        k[1] += 1
    busy = _union((s, t) for _, s, t in dev)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])), reverse=True)[:10]
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "span_s": span,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "units": units,
        "kernels": kernels,
        "device_ops": len(dev),
        "launches": launches,
        "breakdown": {
            "device_ops": [[n[:200], s] for n, (s, _) in ranked],
            "idle_gaps": [[_label(host, s + g / 2), g / 1e6] for g, s in gaps],
        },
    }
