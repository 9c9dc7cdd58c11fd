"""1-D row sampling with ``grid_sample(align_corners=True)`` zero-padding
semantics, and the stereo x-coordinate grid (``dkt_stereo_tpu/ops/sampler.py``)."""

from __future__ import annotations

import torch


def sample_row_1d(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1-D linear sample along the last axis with zero padding.

    ``rows``: (..., S) values (fp32 or bf16); ``x``: (..., K) pixel positions
    with the same leading dims. Returns (..., K) fp32. A tap outside
    [0, S-1] contributes 0, so x in (-1, 0] reads only index 0 with weight
    1 + x (core/corr.py:127-146, where the volume rows have height 1)."""
    S = rows.shape[-1]
    x = x.float()
    x0 = torch.floor(x)
    w = x - x0

    def tap(ix):
        inb = (ix >= 0) & (ix <= S - 1)
        idx = ix.clamp(0, S - 1).long()
        # interpolation always in fp32 (rows may be a bf16 volume)
        return torch.gather(rows, -1, idx).float() * inb

    return tap(x0) * (1 - w) + tap(x0 + 1) * w


def coords_grid_x(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """(B, H, W, 1) contiguous fp32 grid of x-coordinates. The reference
    tracks an (x, y) grid but zeroes every vertical update
    (raft_stereo.py:164), so only x is kept."""
    x = torch.arange(wd, dtype=torch.float32, device=device)
    return x.view(1, 1, wd, 1).expand(batch, ht, wd, 1).contiguous()
