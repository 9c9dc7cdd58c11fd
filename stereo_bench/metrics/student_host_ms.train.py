"""Mean host ms a DKT step in the student's part (the span ``dkt.student``:
zero_grad, the forward, the losses and the backward, remat's recomputed
iterations included), over the traced part's steps. Read under the
profiler."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "dkt.step", {"dkt.student"})
