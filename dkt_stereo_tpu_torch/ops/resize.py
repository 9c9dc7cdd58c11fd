"""Resizing / pooling with torch semantics, over NCHW tensors and NCDHW
volumes (``dkt_stereo_tpu/ops/resize.py``: ``interp_bilinear_align``,
``interp_bilinear_halfpix``, ``interp_trilinear_halfpix``,
``interp_nearest``, ``avg_pool2d``, ``pool2x``). The JAX package writes
these as matmuls and a depthwise conv for the TPU; here they are PyTorch
operators and an index gather."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interp_bilinear_align(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of NCHW ``x`` to (Ho, Wo)
    (core/update.py:93-95)."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def interp_bilinear_halfpix(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear ``align_corners=False`` resize of NCHW ``x`` (torch's
    default)."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def interp_trilinear_halfpix(x: torch.Tensor, out_dhw) -> torch.Tensor:
    """Trilinear ``align_corners=False`` resize of NCDHW ``x`` to (Do, Ho,
    Wo): GWCNet's cost upsample (gwc_main.py:248-263)."""
    if tuple(out_dhw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=False)


def interp_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to (Ho, Wo): output row i reads input row
    ``floor(i * H / Ho)`` in integer arithmetic, as the JAX form does (torch's
    ``mode="nearest"`` computes the same index in floating point)."""
    H, W = x.shape[2:]
    Ho, Wo = out_hw
    rows = torch.arange(Ho, device=x.device) * H // Ho
    cols = torch.arange(Wo, device=x.device) * W // Wo
    return x.index_select(2, rows).index_select(3, cols)


def avg_pool2d(x: torch.Tensor, window, stride, padding=(0, 0)) -> torch.Tensor:
    """torch average pool over NCHW, ``count_include_pad=True``."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool (core/update.py:87-88)."""
    return avg_pool2d(x, (3, 3), (2, 2), (1, 1))
