"""One client in a closed loop, one stereo pair a request (B=1): the newest
pair is sent as soon as the last disparity is back on the host, as a depth
node on a robot or a headset takes its camera's frames
(:mod:`stereo_bench.frames`)."""

from __future__ import annotations

from stereo_bench import frames


def unit_flops(cell: dict, config: dict, ref) -> int:
    return frames.unit_flops(cell, config, ref)


def run(ctx) -> dict:
    if ctx.cell["batch"] != 1:
        raise ValueError("a stream sends one pair a request; use the batch driver")
    return frames.run(ctx)
