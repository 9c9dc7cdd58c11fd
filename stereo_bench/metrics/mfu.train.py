"""The window's model FLOPs (the cell's count a DKT step: both teachers'
forwards, the student's forward and backward, no recomputation) over the
window's seconds times the H100's dense bf16 peak, in percent."""

from stereo_bench.bounds import PEAK_FLOPS


def read(rec):
    if "flops_per_step" not in rec:
        return None
    return 100.0 * rec["flops_per_step"] * rec["units"] / rec["window_s"] / PEAK_FLOPS["bfloat16"]
