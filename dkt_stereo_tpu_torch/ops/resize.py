"""Resizing / pooling with torch semantics, over NCHW tensors
(``dkt_stereo_tpu/ops/resize.py``: ``interp_bilinear_align``, ``avg_pool2d``,
``pool2x``). The JAX package writes these as matmuls and a depthwise conv for
the TPU; here they are the PyTorch operators they reproduce."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interp_bilinear_align(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of NCHW ``x`` to (Ho, Wo)
    (core/update.py:93-95)."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def avg_pool2d(x: torch.Tensor, window, stride, padding=(0, 0)) -> torch.Tensor:
    """torch average pool over NCHW, ``count_include_pad=True``."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool (core/update.py:87-88)."""
    return avg_pool2d(x, (3, 3), (2, 2), (1, 1))
