"""K1's forward (``csrc/corr_lookup.cu``) at the frame's 1/4 grid: its
launches in the traced part times one launch's byte bound at the cell's
own coordinates over its device time, in percent
(:func:`stereo_bench.bounds.kernel_roofline`)."""

from stereo_bench.bounds import K1_FWD, kernel_roofline


def read(rec):
    return kernel_roofline(rec, "corr_lookup", K1_FWD)
