"""The reference's remaining image utilities (``dkt_stereo_tpu/ops/misc.py``;
core/utils/utils.py): ``gauss_blur`` (:87-94) over NCHW tensors and
``forward_interpolate`` (:28-56) over a host numpy flow. Neither is on a
model's path; both are part of the reference's public surface."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gauss_blur(x: torch.Tensor, N: int = 5, std: float = 1.0) -> torch.Tensor:
    """Per-channel Gaussian blur of NCHW ``x``: an N x N window
    ``exp(-(i^2 + j^2) / (2 std^2))`` divided by its sum clamped at 1e-4, as
    a depthwise convolution with 'same' zero padding."""
    g1 = np.arange(N, dtype=np.float64) - N // 2
    gx, gy = np.meshgrid(g1, g1, indexing="ij")
    w = np.exp(-(gx**2 + gy**2) / (2 * std**2))
    w = w / max(w.sum(), 1e-4)
    C = x.shape[1]
    weight = torch.tensor(w, dtype=x.dtype, device=x.device).expand(C, 1, N, N).contiguous()
    return F.conv2d(x, weight, padding=N // 2, groups=C)


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward splat of a (2, H, W) flow to where it points, then a nearest
    fill of every pixel from the splatted samples that land strictly inside
    the image (``scipy.interpolate.griddata(method="nearest")``, imported
    here, as the reference does). Returns (2, H, W) float32."""
    from scipy import interpolate

    dx, dy = flow[0], flow[1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=0).astype(np.float32)
