"""Config handling: reference-JSON-compatible model configs + CLI merge.

Copy of ``dkt_stereo_tpu/cli/config.py``: the reference merges
``configs/<model>/<v>.json`` into the argparse namespace with a flat union
that crashes on duplicate keys (tools/ft_dkt.py:347-350); the strict-disjoint
check is kept, with a clear error message."""

from __future__ import annotations

import argparse
import json


def load_model_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_config(args: argparse.Namespace, config: dict, allow: tuple = ()) -> argparse.Namespace:
    """``allow`` names keys a CLI deliberately overrides — excluded from the
    clash check."""
    clash = (set(vars(args)) & set(config)) - set(allow)
    if clash:
        raise ValueError(
            f"config keys clash with CLI flags (the reference raises TypeError "
            f"here too): {sorted(clash)}"
        )
    merged = {**vars(args), **{k: v for k, v in config.items() if k not in vars(args)}}
    return argparse.Namespace(**merged)
