"""The window's model FLOPs (the cell's count a frame, from the plain
reference, times the frames) over the window's seconds times the H100's
dense bf16 peak, in percent."""

from stereo_bench.bounds import PEAK_FLOPS


def read(rec):
    if "frames" not in rec:
        return None
    return 100.0 * rec["flops_per_frame"] * rec["frames"] / rec["window_s"] / PEAK_FLOPS["bfloat16"]
