"""Mean host ms a DKT step in the two teachers' forwards (the span
``dkt.teachers``), over the traced part's steps; beside the device ms of
``teachers_ms.train`` it says whether the part is host-bound. Read under
the profiler."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "dkt.step", {"dkt.teachers"})
