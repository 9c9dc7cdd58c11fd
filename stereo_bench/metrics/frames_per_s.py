"""Frames completed in the window over the window's seconds (host clock)."""


def read(rec):
    return rec["frames"] / rec["window_s"] if "frames" in rec else None
