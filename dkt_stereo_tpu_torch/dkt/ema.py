"""EMA teacher update (``dkt_stereo_tpu/dkt/ema.py``; tools/ft_dkt.py:179-181)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(ema: nn.Module, student: nn.Module, decay: float) -> None:
    """In place, ``t <- decay*t + (1-decay)*s`` over every parameter and
    every floating-point buffer (the JAX package lerps the whole variable
    tree, batch statistics included); integer buffers such as
    ``num_batches_tracked`` are left as they are."""
    pairs = list(zip(ema.parameters(), student.parameters()))
    pairs += [(t, s) for t, s in zip(ema.buffers(), student.buffers()) if t.is_floating_point()]
    for t, s in pairs:
        t.mul_(decay).add_(s, alpha=1.0 - decay)
