"""RAFT convex upsampling (``dkt_stereo_tpu/ops/upsample.py::convex_upsample``;
meta_arch/raft_stereo/raft_stereo.py:70-82), over NCHW tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    """``flow``: (B, D, H, W) coarse field; ``mask``: (B, 9*f*f, H, W) logits
    with channel layout ``c = (k*f + fy)*f + fx`` (the reference's
    ``view(N, 1, 9, f, f, H, W)``). Each fine pixel is a softmax-weighted
    (over the 9 taps) combination of the zero-padded 3x3 neighbourhood of the
    coarse field, scaled by ``f``. Runs in fp32; returns (B, D, f*H, f*W)."""
    B, D, H, W = flow.shape
    f = factor
    m = mask.float().view(B, 1, 9, f, f, H, W).softmax(dim=2)
    nb = F.unfold(flow.float() * f, [3, 3], padding=1).view(B, D, 9, 1, 1, H, W)
    out = (m * nb).sum(dim=2)  # (B, D, f, f, H, W)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(B, D, f * H, f * W)
