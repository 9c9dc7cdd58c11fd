"""K1's backward (``csrc/corr_lookup_bwd.cu``) in the DKT step: launches
times one launch's byte bound at the student's own coordinates over their
device time, in percent (:func:`stereo_bench.bounds.kernel_roofline`)."""

from stereo_bench.bounds import K1_BWD, kernel_roofline


def read(rec):
    return kernel_roofline(rec, "corr_lookup_bwd", K1_BWD)
