"""The program's spans (``dkt_stereo_tpu_torch/train/profiling.py::span``)
in a run's traced part, for the readers whose source is ``program_span``.

The traced part (:mod:`stereo_bench.trace`) runs under ``torch.profiler``,
so the program keeps every span it opens there in memory. The first reader
of a record takes them (``profiling.take_spans``, once) and stores them
under ``rec["program_spans"]``; they are grouped by unit (a frame's
forward, ``eval.forward``; a DKT step, ``dkt.step``). A run without a trace,
or a program without spans, gives none, and the readers read nothing."""

from __future__ import annotations

from collections import defaultdict


def _take() -> list:
    try:
        from dkt_stereo_tpu_torch.train.profiling import take_spans
    except ImportError:  # a program without spans
        return []
    return take_spans()


def units(rec: dict) -> dict:
    """``{unit: [span, ...]}`` of the record's traced part."""
    if "program_spans" not in rec:
        rec["program_spans"] = _take() if rec.get("trace") else []
    out = defaultdict(list)
    for s in rec["program_spans"]:
        out[s.unit].append(s)
    return dict(out)


def ms(rec: dict, root: str, names) -> float | None:
    """Host ms a unit of the traced part (a frame, where a unit holds
    ``rec["frames_per_unit"]``) in the spans named in ``names``, summed over
    the units whose root span is ``root``; None where there is none."""
    found = [spans for spans in units(rec).values()
             if any(s.parent is None and s.name == root for s in spans)]
    if not found:
        return None
    ns = sum(s.end_ns - s.start_ns for spans in found for s in spans if s.name in names)
    return ns / 1e6 / rec["trace"]["units"] / rec.get("frames_per_unit", 1)
