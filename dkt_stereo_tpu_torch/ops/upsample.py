"""Learned upsampling of a coarse disparity (``dkt_stereo_tpu/ops/upsample.py``),
over NCHW tensors: RAFT's convex upsampling
(meta_arch/raft_stereo/raft_stereo.py:70-82) and IGEV's context upsampling
(meta_arch/igev_stereo/submodule.py:242-254)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int,
                    scale: bool = True) -> torch.Tensor:
    """``flow``: (B, D, H, W) coarse field; ``mask``: (B, 9*f*f, H, W) logits
    with channel layout ``c = (k*f + fy)*f + fx`` (the reference's
    ``view(N, 1, 9, f, f, H, W)``). Each fine pixel is a softmax-weighted
    (over the 9 taps) combination of the zero-padded 3x3 neighbourhood of the
    coarse field, scaled by ``f`` unless ``scale=False`` (PCVNet upsamples
    its mixture weights unscaled, pcvnet/model.py:62-73). Runs in fp32;
    returns (B, D, f*H, f*W)."""
    B, D, H, W = flow.shape
    f = factor
    m = mask.float().view(B, 1, 9, f, f, H, W).softmax(dim=2)
    nb = F.unfold(flow.float() * (f if scale else 1), [3, 3], padding=1).view(B, D, 9, 1, 1, H, W)
    out = (m * nb).sum(dim=2)  # (B, D, f, f, H, W)
    return out.permute(0, 1, 4, 2, 5, 3).reshape(B, D, f * H, f * W)


def context_upsample(disp_low: torch.Tensor, up_weights: torch.Tensor) -> torch.Tensor:
    """IGEV's x4 upsample. ``disp_low``: (B, 1, H, W); ``up_weights``:
    (B, 9, 4H, 4W), already softmaxed over the 9 taps. The zero-padded 3x3
    neighbourhood of each coarse pixel is repeated over its 4x4 fine pixels
    (a nearest x4 resize) and summed with the weights. Returns (B, 4H, 4W)
    in the inputs' dtype."""
    B, _, H, W = disp_low.shape
    nb = F.unfold(disp_low, [3, 3], padding=1).view(B, 9, H, W)
    nb = nb.repeat_interleave(4, dim=2).repeat_interleave(4, dim=3)
    return (nb * up_weights).sum(dim=1)
