"""Disparity warping and SSIM of the photometric losses
(``dkt_stereo_tpu/ops/warp.py``; the reference's
meta_arch/nerf_stereo/loss.py:5-27, 73-84), over NHWC tensors.

The sampling is torch ``grid_sample``'s with ``align_corners=False`` (the
reference calls it with its defaults), written as the JAX package writes
it: four taps gathered at the floor of the coordinate and the next index,
each index clamped to the image (``border``) or its tap zeroed outside
(``zeros``), and the bilinear weights ``x - floor(x)``. The gradient with
respect to the coordinates is then the JAX package's everywhere, at the
borders too: ``F.grid_sample`` clips the coordinate in ``border`` mode and
gives a zero gradient at exactly ``x = 0``, where the clamped taps give
``img[1] - img[0]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, coords: torch.Tensor, align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """``grid_sample`` of NHWC ``img`` (B, H, W, C) at normalized ``coords``
    (B, Ho, Wo, 2) in [-1, 1], (x, y) order; returns (B, Ho, Wo, C).
    ``padding_mode`` is ``"zeros"`` or ``"border"``."""
    B, H, W, C = img.shape
    xn, yn = coords[..., 0], coords[..., 1]
    if align_corners:
        x = (xn + 1) * 0.5 * (W - 1)
        y = (yn + 1) * 0.5 * (H - 1)
    else:
        x = ((xn + 1) * W - 1) * 0.5
        y = ((yn + 1) * H - 1) * 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0)[..., None].to(img.dtype)
    wy = (y - y0)[..., None].to(img.dtype)
    flat_img = img.reshape(B, H * W, C)

    def index(v, size):
        # a NaN coordinate reads index 0; its loss is gated off by ``ok``
        return torch.nan_to_num(v.clamp(0, size - 1), nan=0.0).long()

    xs, ys = (x0, x0 + 1), (y0, y0 + 1)
    cols = [index(v, W) for v in xs]
    rows = [index(v, H) * W for v in ys]

    def tap(i, j):
        flat = (rows[j] + cols[i]).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat_img, 1, flat).reshape(*x.shape, C)
        if padding_mode == "zeros":
            inb = (xs[i] >= 0) & (xs[i] <= W - 1) & (ys[j] >= 0) & (ys[j] <= H - 1)
            vals = vals * inb[..., None].to(img.dtype)
        return vals

    return (tap(0, 0) * (1 - wx) * (1 - wy) + tap(1, 0) * wx * (1 - wy)
            + tap(0, 1) * (1 - wx) * wy + tap(1, 1) * wx * wy)


def disp_warp(x: torch.Tensor, disp: torch.Tensor, r2l: bool = False, pad: str = "border"):
    """Warp NHWC ``x`` (B, H, W, C) by the disparity ``disp`` (B, H, W, 1):
    pixel ``w`` samples ``x`` at ``w - disp`` (``w + disp`` when ``r2l``).
    Returns ``(warped, mask)`` as loss.py:73-84: the warp with ``pad``
    padding and the warp of ones with zero padding (sampled once, in one
    channel, and broadcast to C)."""
    B, H, W, C = x.shape
    offset = 1.0 if r2l else -1.0
    gx = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, None, :, None] + offset * disp
    gy = torch.arange(H, dtype=disp.dtype, device=disp.device)[None, :, None, None].expand(
        gx.shape)
    grid = torch.cat([2.0 * gx / (W - 1) - 1.0, 2.0 * gy / (H - 1) - 1.0], dim=-1)
    warped = grid_sample_2d(x, grid, align_corners=False, padding_mode=pad)
    ones = torch.ones((B, H, W, 1), dtype=x.dtype, device=x.device)
    mask = grid_sample_2d(ones, grid, align_corners=False, padding_mode="zeros")
    return warped, mask.expand(-1, -1, -1, C)


def ssim(x: torch.Tensor, y: torch.Tensor, md: int = 3) -> torch.Tensor:
    """SSIM distance ``(1 - SSIM) / 2`` in [0, 1] of NHWC ``x`` and ``y``
    (loss.py:5-27): reflection padding by ``md``, (2 md + 1)^2 average
    pools, C1 = 1e-4, C2 = 9e-4. The clip is ``min(max(v, 0), 1)``, whose
    gradient at a bound is the JAX package's half."""
    patch = 2 * md + 1
    C1, C2 = 0.01**2, 0.03**2
    xp = F.pad(x.permute(0, 3, 1, 2), (md, md, md, md), mode="reflect")
    yp = F.pad(y.permute(0, 3, 1, 2), (md, md, md, md), mode="reflect")

    def pool(v):
        return F.avg_pool2d(v, patch, 1)

    mu_x, mu_y = pool(xp), pool(yp)
    sigma_x = pool(xp * xp) - mu_x**2
    sigma_y = pool(yp * yp) - mu_y**2
    sigma_xy = pool(xp * yp) - mu_x * mu_y
    num = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    den = (mu_x**2 + mu_y**2 + C1) * (sigma_x + sigma_y + C2)
    d = (1 - num / den) / 2
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.minimum(torch.maximum(d, zero), zero + 1).permute(0, 2, 3, 1)
