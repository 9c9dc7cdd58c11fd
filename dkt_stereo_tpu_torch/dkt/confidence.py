"""Confidence tools (``dkt_stereo_tpu/dkt/confidence.py``; the reference's
utils/confidence.py), over NHWC tensors in plain PyTorch: Gaussian-window
SSIM (:23-60), the disparity-warp reprojection error (:67-103), left-right
uniqueness (:113-127) and neighbourhood agreement (:129-143). The DKT loop
does not call them; they are the reference's tools for confidence maps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dkt_stereo_tpu_torch.ops.warp import disp_warp


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalised outer product of a 1-D Gaussian (utils/confidence.py:23-31),
    (size, size) float32."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim_gaussian(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM map of NHWC images (utils/confidence.py:33-60):
    each channel filtered on its own by the window, 'same' zero padding."""
    C = img1.shape[-1]
    w = torch.as_tensor(gaussian_window(window_size), device=img1.device, dtype=img1.dtype)
    w = w.expand(C, 1, window_size, window_size)
    p = window_size // 2

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=p, groups=C).permute(0, 2, 3, 1)

    mu1, mu2 = filt(img1), filt(img2)
    s1 = filt(img1 * img1) - mu1**2
    s2 = filt(img2 * img2) - mu2**2
    s12 = filt(img1 * img2) - mu1 * mu2
    C1, C2 = 0.01**2, 0.03**2
    return ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1**2 + mu2**2 + C1) * (s1 + s2 + C2))


def reprojection_error(img_left: torch.Tensor, img_right: torch.Tensor,
                       disp: torch.Tensor | None = None,
                       valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """utils/confidence.py:86-103: the right image warped by ``-disp`` (B, H,
    W, 1), negative disparity as everywhere in this package, then ``0.15 *
    L1 + 0.85 * (1 - SSIM) / 2`` per pixel (B, H, W), the L1 the masked
    images' mean. The warp is ``ops/warp.py::disp_warp``, as in JAX (whose
    docstring states its difference from the reference's warp)."""
    warped = disp_warp(img_right, -disp)[0] if disp is not None else img_right
    if valid_mask is None:
        valid_mask = torch.ones_like(img_left[..., :1])
    l1 = (warped * valid_mask - img_left * valid_mask).abs().mean()
    s = (valid_mask * (1.0 - ssim_gaussian(img_left, warped)) / 2.0).mean(dim=-1)
    return 0.15 * l1 + 0.85 * s


def uniqueness(disparity: torch.Tensor) -> torch.Tensor:
    """Left-right uniqueness (utils/confidence.py:113-127) of a (B, H, W)
    disparity: 1 where the pixel is the first, in raster order, of the left
    pixels landing on its right-image position ``x - int(d)``, else 0.

    The first is a scatter-min of raster indices over the landing
    positions, shifted by W, as JAX's ``.at[].min``: a negative slot counts
    from the end and a slot out of range drops its update and reads the
    nearest slot."""
    d = disparity.to(torch.int64)
    B, H, W = d.shape
    n = B * H * W
    idx = torch.arange(n, device=d.device)
    slots = idx - d.reshape(-1) + W
    size = n + W
    slots = torch.where(slots < 0, slots + size, slots)
    inside = (slots >= 0) & (slots < size)
    winner = torch.full((size,), n, dtype=torch.int64, device=d.device)
    winner.scatter_reduce_(0, slots[inside], idx[inside], reduce="amin")
    out = winner[slots.clamp(0, size - 1)] == idx
    return out.reshape(B, H, W).float()


def agreement(disparity: torch.Tensor, r: int, tau: float = 1.0) -> torch.Tensor:
    """Neighbourhood agreement (utils/confidence.py:129-143): how many of the
    (2r+1)^2 - 1 neighbours of each pixel, zero outside the image, lie within
    ``tau`` of it."""
    d = disparity.float()
    B, H, W = d.shape
    p = F.pad(d, (r, r, r, r))
    wind = 2 * r + 1
    count = torch.zeros_like(d)
    for k in range(wind * wind):
        if k == wind * wind // 2:
            continue
        nb = p[:, k // wind:k // wind + H, k % wind:k % wind + W]
        count = count + ((d - nb).abs() < tau).float()
    return count
