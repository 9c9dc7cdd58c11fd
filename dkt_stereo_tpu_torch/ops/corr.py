"""All-pairs 1-D correlation pyramid and its plain lookup
(``dkt_stereo_tpu/ops/corr.py``; the reference's ``CorrBlock1D``,
core/corr.py:110-156).

  - pyramid level i: ``f1 @ pool_i(f2)^T / sqrt(D)`` with the right features
    mean-pooled in pairs along width i times (odd trailing widths drop the
    last column). Products accumulate in fp32 whatever the feature dtype;
    the level is stored in ``out_dtype`` (bf16 under mixed precision).
  - lookup: at level i, 2r+1 linear taps around ``x / 2^i`` with zero
    padding, concatenated over levels -> (B, H, W, L*(2r+1)) fp32.

:func:`corr_lookup` is the plain twin of the CUDA kernel
``ops/cuda/corr_lookup.py`` (the port of the Pallas ``corr_lookup_pallas``).
"""

from __future__ import annotations

import math

import torch

from dkt_stereo_tpu_torch.ops.sampler import sample_row_1d


def fmap_pyramid(fmap2: torch.Tensor, num_levels: int, factor: int = 2) -> list[torch.Tensor]:
    """Width-pooled right-feature pyramid of (B, H, W, D) features
    (core/corr.py:104: ``avg_pool2d(fmap2, [1, 2])`` per level)."""
    pyr = [fmap2]
    f = fmap2
    for _ in range(num_levels - 1):
        B, H, w, D = f.shape
        keep = (w // factor) * factor
        f = f[:, :, :keep].reshape(B, H, w // factor, factor, D).mean(3)
        pyr.append(f)
    return pyr


def corr_pyramid_fused(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, out_dtype=None
) -> list[torch.Tensor]:
    """Correlation pyramid built level by level as ``f1 @ pooled(f2)``:
    (B, H, W1, D), (B, H, W2, D) -> [(B, H, W1, W2 / 2^i)].

    Equal to pooling the full volume, because the [1, 2] average pool is
    linear in fmap2. The products run in fp32 on the (possibly bf16-rounded)
    features — the JAX einsum's fp32 accumulation — and each level is then
    stored in ``out_dtype``."""
    scale = 1.0 / math.sqrt(fmap1.shape[-1])
    f1 = fmap1.float()
    pyramid = []
    for f2l in fmap_pyramid(fmap2, num_levels):
        corr = torch.matmul(f1, f2l.float().transpose(-1, -2)) * scale
        pyramid.append(corr.to(out_dtype) if out_dtype is not None else corr)
    return pyramid


def corr_lookup(pyramid, coords_x: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample the pyramid at ``coords_x`` (B, H, W, 1) ->
    (B, H, W, L*(2r+1)) fp32. Channel order is [level0 taps -r..r, level1
    taps, ...] (core/corr.py:135-145)."""
    dx = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords_x.device)
    out = []
    for i, vol in enumerate(pyramid):
        x = coords_x.float() / (2**i) + dx
        out.append(sample_row_1d(vol, x))
    return torch.cat(out, dim=-1)
