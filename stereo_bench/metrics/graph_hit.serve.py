"""Percent of the traced part's test-mode RAFT-Stereo forwards whose
refinement a CUDA graph's replay served: the program's spans
``raft.replay`` (``models/raft_stereo.py::RAFTStereo._replay``) over its
``raft.encode`` spans (one a forward, eager or replayed), in the frames'
units (root ``eval.forward``). None where the program has no such graphs
(``models/graphs.py``) or the traced part ran no forward."""

from stereo_bench.spans import units


def read(rec):
    try:
        import dkt_stereo_tpu_torch.models.graphs  # noqa: F401
    except ImportError:
        return None
    replays = forwards = 0
    for spans in units(rec).values():
        if any(s.parent is None and s.name == "eval.forward" for s in spans):
            replays += sum(s.name == "raft.replay" for s in spans)
            forwards += sum(s.name == "raft.encode" for s in spans)
    return 100.0 * replays / forwards if forwards else None
