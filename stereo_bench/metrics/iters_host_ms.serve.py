"""Mean host ms a frame in RAFT's refinement iterations (the sum of the
spans ``raft.iter``, one an iteration: the lookup and the update block)
inside ``eval.forward``, over the traced part's requests. Read under the
profiler, which stretches each launch."""

from stereo_bench.spans import ms


def read(rec):
    return ms(rec, "eval.forward", {"raft.iter"})
