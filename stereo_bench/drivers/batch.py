"""Batches of recorded pairs back to back, B > 1 a request, each batch
copied in and its disparities copied out before the next (offline depth
for recorded sequences, pseudo-labels for a new domain;
:mod:`stereo_bench.frames`)."""

from __future__ import annotations

from stereo_bench import frames


def unit_flops(cell: dict, config: dict, ref) -> int:
    return frames.unit_flops(cell, config, ref)


def run(ctx) -> dict:
    if ctx.cell["batch"] < 2:
        raise ValueError("a batch holds more than one pair; use the stream driver")
    return frames.run(ctx)
