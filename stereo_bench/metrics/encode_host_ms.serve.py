"""Mean host ms a frame in RAFT's encoders (the span ``raft.encode``: the
normalised images, the context and feature encoders with K2, the context
convolutions) inside ``eval.forward``, over the traced part's requests.
Read under the profiler, which stretches each launch."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "eval.forward", {"raft.encode"})
