"""Mean host ms a DKT step spent waiting for the device: the spans
``dkt.reduce`` (on one card the wait for ``ok``, which ends with the
backward) and ``dkt.read`` (the metrics' copy to the host), over the traced
part's steps. Read under the profiler."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "dkt.step", {"dkt.reduce", "dkt.read"})
