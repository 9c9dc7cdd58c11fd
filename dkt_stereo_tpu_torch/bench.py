"""Benchmark: RAFT-Stereo inference throughput at 736×1280 on one GPU, the
port's counterpart of the root ``bench.py``:

  python -m dkt_stereo_tpu_torch.bench

``configs/raft_stereo/pallas.json`` as shipped (bf16, ``reg_cuda`` through
K1, the fused encoder through K2), batch 1, 32 GRU iterations, seeded random
images and weights: 3 warm-up frames, then 5 batches of 10 frames, each
batch ended by a copy of its last disparity to the host. Prints one JSON
line with the best batch's frames per second (``value``), the mean over all
batches (``mean_fps``) and the card's name and power limit, and returns it
as a dict. The JAX bench's 5 frames/s is a target for a TPU, not for this
card, so no ratio to it is printed.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "raft_stereo" / "pallas.json"
SHAPE = (1, 736, 1280)
ITERS = 32
WARMUP, BATCHES, FRAMES = 3, 5, 10


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(device=None):
    """Time the forward; returns the JSON line's fields."""
    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.device import resolve_device
    from dkt_stereo_tpu_torch.eval.validate import make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    dev = resolve_device(device)
    model = create_model(load_model_config(str(CONFIG)), iters=ITERS, device=dev, seed=0)
    forward = make_forward_fn(model, dev)
    rng = np.random.default_rng(0)
    B, H, W = SHAPE
    img1, img2 = (torch.as_tensor(rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
                                  device=dev) for _ in range(2))
    for _ in range(WARMUP):
        forward(img1, img2).cpu()
    times = []
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            out = forward(img1, img2)
        out.cpu()
        times.append((time.perf_counter() - t0) / FRAMES)
    res = {"metric": f"raft_stereo_fps_{H}x{W}_iters{ITERS}",
           "value": round(1.0 / min(times), 3), "unit": "frames/s/gpu",
           "mean_fps": round(len(times) / sum(times), 3)}
    if dev.type == "cuda":
        name, limit = (s.strip() for s in card_line().split(",", 1))
        res.update(device=name, power_limit=limit)
    return res


def main():
    res = run()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
