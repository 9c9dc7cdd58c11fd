"""Percent of the traced part's teacher forwards (test-mode RAFT-Stereo,
inside ``dkt.teachers``) whose refinement a CUDA graph's replay served: the
program's spans ``raft.replay`` (``models/raft_stereo.py::
RAFTStereo._replay``; in the DKT step only the teachers replay) over the
``raft.encode`` spans directly inside ``dkt.teachers`` (one a forward; a
batched-teacher forward counts once), in the steps' units (root
``dkt.step``). None where the program has no such graphs
(``models/graphs.py``) or the traced part ran no teacher."""

from stereo_bench.spans import units


def read(rec):
    try:
        import dkt_stereo_tpu_torch.models.graphs  # noqa: F401
    except ImportError:
        return None
    replays = forwards = 0
    for spans in units(rec).values():
        if any(s.parent is None and s.name == "dkt.step" for s in spans):
            teachers = {s.id for s in spans if s.name == "dkt.teachers"}
            replays += sum(s.name == "raft.replay" for s in spans)
            forwards += sum(s.name == "raft.encode" and s.parent in teachers for s in spans)
    return 100.0 * replays / forwards if forwards else None
