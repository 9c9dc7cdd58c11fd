"""Mean host ms a DKT step in its small parts: the spans ``dkt.ema``,
``dkt.fande``, ``dkt.update`` (clip and AdamW) and ``dkt.divergence``, over
the traced part's steps. Read under the profiler."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "dkt.step", {"dkt.ema", "dkt.fande", "dkt.update", "dkt.divergence"})
