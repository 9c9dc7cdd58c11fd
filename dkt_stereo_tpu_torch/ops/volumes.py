"""Disparity cost volumes and soft-argmin regressions
(``dkt_stereo_tpu/ops/volumes.py``; the reference's
meta_arch/gwcnet/submodules.py:25-58, meta_arch/igev_stereo/submodule.py:152-224
and meta_arch/cgi/submodule.py:165-228), over NCHW features and NCDHW
volumes. The JAX package scans over a traced disparity with roll and mask;
here each volume is a Python loop over disparities that writes the
``w >= d`` columns of a zero volume, as the reference does."""

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


def build_concat_volume(fmap1: torch.Tensor, fmap2: torch.Tensor, maxdisp: int,
                        mask_ref: bool = True) -> torch.Tensor:
    """Concat volume: (B, C, H, W) x2 -> (B, 2C, D, H, W), the reference
    features in the first C channels and the target's shifted right by d in
    the last C, zero where ``w < d``. ``mask_ref`` zeroes the reference
    features there too (GWCNet, gwcnet/submodules.py:29-31); without it they
    are kept whole (IGEV's and CGI's variant, igev_stereo/submodule.py:211)."""
    B, C, H, W = fmap1.shape
    vol = fmap1.new_zeros((B, 2 * C, maxdisp, H, W))
    if not mask_ref:
        vol[:, :C] = fmap1[:, :, None]
    for d in range(min(maxdisp, W)):
        if mask_ref:
            vol[:, :C, d, :, d:] = fmap1[..., d:]
        vol[:, C:, d, :, d:] = fmap2[..., : W - d]
    return vol


def build_norm_correlation_volume(fmap1: torch.Tensor, fmap2: torch.Tensor,
                                  maxdisp: int) -> torch.Tensor:
    """Single-channel cosine volume (B, 1, D, H, W): each feature divided by
    its L2 norm over channels plus 1e-5, then the channel mean of
    ``f1[..., w] * f2[..., w - d]``, zero where ``w < d``
    (cgi/submodule.py:165-180)."""
    B, C, H, W = fmap1.shape
    f1 = fmap1 / (fmap1.norm(dim=1, keepdim=True) + 1e-5)
    f2 = fmap2 / (fmap2.norm(dim=1, keepdim=True) + 1e-5)
    vol = fmap1.new_zeros((B, 1, maxdisp, H, W))
    for d in range(min(maxdisp, W)):
        vol[:, 0, d, :, d:] = (f1[..., d:] * f2[..., : W - d]).mean(dim=1)
    return vol


def disparity_regression(prob: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Soft-argmin: (B, D, H, W) probabilities -> (B, 1, H, W) expected
    disparity, in the probabilities' dtype."""
    d = torch.arange(maxdisp, dtype=prob.dtype, device=prob.device).view(1, maxdisp, 1, 1)
    return (prob * d).sum(dim=1, keepdim=True)


def regression_topk(cost: torch.Tensor, disparity_samples: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k soft-argmin (cgi/submodule.py:220-228): a softmax over the k
    largest entries of ``cost`` along dim 1, weighting the disparities
    ``disparity_samples`` holds at those entries. (B, D, H, W) x2 ->
    (B, 1, H, W). Ties between entries within rounding of each other are
    broken as ``torch.topk`` breaks them."""
    topv, topi = cost.topk(k, dim=1)
    prob = torch.softmax(topv, dim=1)
    return (disparity_samples.gather(1, topi) * prob).sum(dim=1, keepdim=True)
