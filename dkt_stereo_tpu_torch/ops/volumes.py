"""Disparity cost volumes and soft-argmin regression
(``dkt_stereo_tpu/ops/volumes.py``; the reference's
meta_arch/igev_stereo/submodule.py:152-224), over NCHW features and NCDHW
volumes. Only IGEV's group-wise correlation volume is ported; the concat
and norm-correlation volumes and ``regression_topk`` wait for GWCNet/CGI
(ROADMAP.md Queue 1 item 9)."""

from __future__ import annotations

import torch


def build_gwc_volume(fmap1: torch.Tensor, fmap2: torch.Tensor, maxdisp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume: (B, C, H, W) x2 -> (B, G, D, H, W) with
    ``cost[b, g, d, h, w]`` the mean over group g's channels of
    ``f1[..., w] * f2[..., w - d]``, and 0 where ``w < d``. Built in the
    features' dtype (the group mean accumulates in fp32)."""
    B, C, H, W = fmap1.shape
    G = num_groups
    if C % G:
        raise ValueError(f"build_gwc_volume: {C} channels do not split into {G} groups")
    vol = fmap1.new_zeros((B, G, maxdisp, H, W))
    for d in range(min(maxdisp, W)):
        prod = fmap1[..., d:] * fmap2[..., : W - d]
        vol[:, :, d, :, d:] = prod.view(B, G, C // G, H, W - d).mean(dim=2)
    return vol


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Soft-argmin: (B, D, H, W) probabilities -> (B, 1, H, W) expected
    disparity, in the probabilities' dtype."""
    d = torch.arange(maxdisp, dtype=prob.dtype, device=prob.device).view(1, maxdisp, 1, 1)
    return (prob * d).sum(dim=1, keepdim=True)
