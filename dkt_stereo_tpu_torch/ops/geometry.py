"""IGEV's combined geometry-encoding volume and its plain lookup
(``dkt_stereo_tpu/ops/geometry.py``; the reference's
meta_arch/igev_stereo/geometry.py:6-58).

Two pyramids are sampled per GRU iteration:
  - the aggregated C-channel geo volume, level i (B, H, W, D_i, C), along
    disparity at ``disp/2^i + k - r``; each level averages pairs of the
    previous one along D (an odd last slot is dropped);
  - the unscaled init correlation ``f1 @ pooled(f2)``, level i
    (B, H, W, W2_i), along the right image's width at
    ``(coords - disp)/2^i + k - r``.
Per level the output channels are [geo C-major, taps fast (C*(2r+1)) |
corr (2r+1)], concatenated over levels -> (B, H, W, L*(C+1)*(2r+1)) fp32.

:func:`geo_lookup` is the plain twin of the CUDA kernel
``ops/cuda/geo_lookup.py`` (the port of the Pallas ``geo_lookup_pallas``).
"""

from __future__ import annotations

import torch

from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused
from dkt_stereo_tpu_torch.ops.sampler import sample_row_1d


def geo_lookup(geo_pyramid, corr_pyramid, disp: torch.Tensor, coords: torch.Tensor,
               radius: int) -> torch.Tensor:
    """``geo_pyramid``: per level (B, H, W, D_i, C); ``corr_pyramid``: per
    level (B, H, W, W2_i); ``disp``, ``coords``: (B, H, W, 1) ->
    (B, H, W, L*(C+1)*(2r+1)) fp32."""
    dx = torch.arange(-radius, radius + 1, dtype=torch.float32, device=disp.device)
    d = disp.float()
    out = []
    for i, (geo, corr) in enumerate(zip(geo_pyramid, corr_pyramid)):
        B, H, W, _, C = geo.shape
        # channels in front of D, then sample each channel's row along D
        x_geo = (d / 2**i + dx)[:, :, :, None, :].expand(B, H, W, C, dx.numel())
        out.append(sample_row_1d(geo.transpose(3, 4), x_geo).reshape(B, H, W, -1))
        out.append(sample_row_1d(corr, (coords.float() - d) / 2**i + dx))
    return torch.cat(out, dim=-1)


class CombinedGeoEncodingVolume:
    """The two pyramids, built once per forward.

    ``fmap1``, ``fmap2``: (B, H, W, D) descriptors; ``geo_volume``: the
    aggregated volume in the port's layout (B, C, D, H, W). The pyramids are
    built in the inputs' dtype (the model passes fp32); the lookup is
    :func:`geo_lookup` or the K4 kernel over ``geo_pyramid`` and
    ``corr_pyramid``."""

    def __init__(self, fmap1, fmap2, geo_volume, num_levels: int = 2, radius: int = 4):
        self.num_levels, self.radius = num_levels, radius
        # no 1/sqrt(D): the reference's init correlation is unscaled
        self.corr_pyramid = corr_pyramid_fused(fmap1, fmap2, num_levels, scaled=False)
        g = geo_volume.permute(0, 3, 4, 1, 2)  # (B, H, W, C, D)
        self.geo_pyramid = [g.transpose(3, 4).contiguous()]
        for _ in range(num_levels - 1):
            D = g.shape[-1]
            g = g[..., : (D // 2) * 2].unflatten(-1, (D // 2, 2)).mean(-1)
            self.geo_pyramid.append(g.transpose(3, 4).contiguous())

    def __call__(self, disp: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        return geo_lookup(self.geo_pyramid, self.corr_pyramid, disp, coords, self.radius)
