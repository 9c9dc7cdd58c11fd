"""Bilinear and 1-D row sampling with ``grid_sample(align_corners=True)``
zero-padding semantics, and the stereo x-coordinate grid
(``dkt_stereo_tpu/ops/sampler.py``)."""

from __future__ import annotations

import torch


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor, mask: bool = False):
    """Sample NCHW ``img`` at ``coords`` (B, Ho, Wo, 2), (x, y) in pixels,
    with the semantics of the reference's ``bilinear_sampler``
    (core/utils/utils.py:59-74), ``F.grid_sample(align_corners=True)`` with
    zero padding: pixel i sits at coordinate i and a tap outside the image
    reads 0. Returns (B, C, Ho, Wo). The four taps are gathered in pixel
    space, in the JAX form's order of operations: ``grid_sample``'s round
    trip through [-1, 1] moves a coordinate by up to ~W * 2^-24 px, which at
    W = 320 changes a sample of a rough map by ~1e-4 of its scale between
    two devices, and divides by 0 on an axis of size 1. A NaN coordinate
    gives NaN. With ``mask`` also returns the (B, Ho, Wo) mask, in
    ``img``'s dtype, of coordinates strictly inside the image on the
    normalised scale (:71-72), where an image one row high leaves y as it
    is, as the reference does."""
    B, C, H, W = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(B, C, H * W)

    def tap(ix, iy):
        inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        ixc = ix.nan_to_num(0.0).clamp(0, W - 1).long()
        iyc = iy.nan_to_num(0.0).clamp(0, H - 1).long()
        idx = (iyc * W + ixc).reshape(B, 1, -1).expand(B, C, -1)
        vals = torch.gather(flat, 2, idx).reshape(B, C, *ix.shape[1:])
        return vals * inb.unsqueeze(1).to(img.dtype)

    wx = (x - x0).unsqueeze(1).to(img.dtype)
    wy = (y - y0).unsqueeze(1).to(img.dtype)
    out = (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x0 + 1, y0) * wx * (1 - wy)
           + tap(x0, y0 + 1) * (1 - wx) * wy + tap(x0 + 1, y0 + 1) * wx * wy)
    if not mask:
        return out
    xn = 2 * x / (W - 1) - 1 if W > 1 else x
    yn = 2 * y / (H - 1) - 1 if H > 1 else y
    m = (xn > -1) & (xn < 1) & (yn > -1) & (yn < 1)
    return out, m.to(img.dtype)


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
        # a NaN position reads index 0 with weight 0 (its output is NaN)
        idx = ix.nan_to_num(0.0).clamp(0, S - 1).long()
        # interpolation always in fp32 (rows may be a bf16 volume)
        return torch.gather(rows, -1, idx).float() * inb

    return tap(x0) * (1 - w) + tap(x0 + 1) * w


def coords_grid_x(batch: int, ht: int, wd: int, device=None) -> torch.Tensor:
    """(B, H, W, 1) contiguous fp32 grid of x-coordinates. The reference
    tracks an (x, y) grid but zeroes every vertical update
    (raft_stereo.py:164), so only x is kept."""
    x = torch.arange(wd, dtype=torch.float32, device=device)
    return x.view(1, 1, wd, 1).expand(batch, ht, wd, 1).contiguous()
