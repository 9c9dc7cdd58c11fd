"""Seconds from the process's start to the window's: imports, the kernels'
build on a checkout's first run, the model and weights, inputs, warm-up
(for training the first steps, which the correctness check reads)."""


def read(rec):
    return rec["setup_s"]
