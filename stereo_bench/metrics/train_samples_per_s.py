"""Samples (batch rows) of the training steps completed in the window over
the window's seconds (host clock)."""


def read(rec):
    return rec["samples"] / rec["window_s"] if "samples" in rec else None
