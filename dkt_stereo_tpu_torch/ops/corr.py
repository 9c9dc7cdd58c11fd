"""All-pairs 1-D correlation pyramid and its plain lookup
(``dkt_stereo_tpu/ops/corr.py``; the reference's ``CorrBlock1D``,
core/corr.py:110-156).

  - pyramid level i: ``f1 @ pool_i(f2)^T / sqrt(D)`` with the right features
    mean-pooled in pairs along width i times (odd trailing widths drop the
    last column). Products accumulate in fp32 whatever the feature dtype;
    the level is stored in ``out_dtype`` (bf16 under mixed precision).
  - lookup: at level i, 2r+1 linear taps around ``x / 2^i`` with zero
    padding, concatenated over levels -> (B, H, W, L*(2r+1)) fp32.

The memory-efficient "alt" lookup (core/corr.py:64-107) builds no volume:
:func:`corr_lookup_alt` samples the pooled right features at the taps and
dots them with the left features, equal to the materialized lookup because
the pool is linear in fmap2.

:func:`corr_lookup` is the plain twin of the CUDA kernel
``ops/cuda/corr_lookup.py`` (the port of the Pallas ``corr_lookup_pallas``);
:func:`corr_lookup_alt` that of ``ops/cuda/corr_alt.py`` (the port of
``corr_lookup_alt_pallas``).
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
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, out_dtype=None,
    scaled: bool = True, pool_factor: int = 2,
) -> list[torch.Tensor]:
    """Correlation pyramid built level by level as ``f1 @ pooled(f2)``:
    (B, H, W1, D), (B, H, W2, D) -> [(B, H, W1, W2 / f^i)] with f =
    ``pool_factor`` (PCVNet pools by its compress factor,
    meta_arch/pcvnet/corr.py:24-31). ``scaled=False`` omits the 1/sqrt(D)
    factor (IGEV's init correlation, meta_arch/igev_stereo/geometry.py:62-69).

    Equal to pooling the full volume, because the [1, f] average pool is
    linear in fmap2. The products run in fp32 on the (possibly bf16-rounded)
    features — the JAX einsum's fp32 accumulation — and each level is then
    stored in ``out_dtype``."""
    scale = 1.0 / math.sqrt(fmap1.shape[-1])
    f1 = fmap1.float()
    pyramid = []
    for f2l in fmap_pyramid(fmap2, num_levels, pool_factor):
        corr = torch.matmul(f1, f2l.float().transpose(-1, -2))
        if scaled:
            corr = corr * scale
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


def corr_lookup_alt(fmap1: torch.Tensor, f2_pyramid, coords_x: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """No-volume lookup (``dkt_stereo_tpu/ops/corr.py::corr_lookup_alt``):
    at level i the pooled right features (B, H, W2_i, D) are sampled at the
    2r+1 taps ``x / 2^i + k - r`` (linear, zero padding) and dotted with
    fmap1 (B, H, W1, D), in fp32, then divided by sqrt(D). Returns
    (B, H, W1, L*(2r+1)) fp32, channel order as :func:`corr_lookup`.

    Level by level, as the JAX function: each gathers (B, H, W1, 2r+1, D)
    fp32 taps twice. A NaN position reads a clamped index with weight 0, so
    its output is NaN, as in :func:`sample_row_1d`."""
    B, H, W, D = fmap1.shape
    dx = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords_x.device)
    K = dx.numel()
    f1 = fmap1.float()
    out = []
    for i, f2 in enumerate(f2_pyramid):
        S = f2.shape[2]
        f2 = f2.float()
        x = coords_x.float() / (2**i) + dx  # (B, H, W, K)
        x0 = torch.floor(x)
        w = (x - x0)[..., None]

        def tap(ix):
            inb = ((ix >= 0) & (ix <= S - 1))[..., None]
            idx = ix.nan_to_num(0.0).clamp(0, S - 1).long().reshape(B, H, W * K, 1)
            return torch.take_along_dim(f2, idx, dim=2).reshape(B, H, W, K, D) * inb

        sampled = tap(x0) * (1 - w) + tap(x0 + 1) * w
        out.append(torch.einsum("bhwkd,bhwd->bhwk", sampled, f1) / math.sqrt(D))
        del sampled
    return torch.cat(out, dim=-1)
