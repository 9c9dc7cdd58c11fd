"""K1's forward (``csrc/corr_lookup.cu``) in the DKT step, teachers' and
student's launches alike at the crop's 1/4 grid: launches times one
launch's byte bound at the step's own coordinates over their device time,
in percent (:func:`stereo_bench.bounds.kernel_roofline`)."""

from stereo_bench.bounds import K1_FWD, kernel_roofline


def read(rec):
    return kernel_roofline(rec, "corr_lookup", K1_FWD)
