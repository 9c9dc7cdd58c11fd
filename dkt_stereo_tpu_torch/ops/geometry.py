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
``ops/cuda/geo_lookup.py`` (the port of the Pallas ``geo_lookup_pallas``),
:func:`geo_lookup_bwd_plain` that of its backward kernels.
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


def geo_lookup_bwd_plain(geo_shapes_dtypes, corr_shapes_dtypes, disp: torch.Tensor,
                         coords: torch.Tensor, g: torch.Tensor, radius: int = 4,
                         need_geo: bool = True, need_corr: bool = True):
    """Plain version of the backward (the counterpart of the Pallas
    ``_geo_bwd_impl``, geo_lookup.py:223-298): the gradient of the plain
    forward, which is linear in the levels, taken by autograd at fp32 zero
    levels, so that each level's sum runs in fp32 and is rounded once to the
    level's dtype. Returns ``(dgeo, dcorr)``: per level (B, H, W, D_i, C)
    and (B, H, W, W2_i), or None per level where ``need_geo`` /
    ``need_corr`` is false. Nothing flows to disp or coords. A NaN position
    gives NaN in its pixel's whole row, as the JAX kernels' relu(1 - |j -
    NaN|) weights do: a NaN disparity in every level of both pyramids, a NaN
    coordinate in the corr levels.

    ``*_shapes_dtypes``: one ``(shape, dtype)`` per level; ``disp``,
    ``coords``: (B, H, W, 1); ``g``: (B, H, W, L*(C+1)*(2r+1))."""
    def zeros(meta, need):
        return [torch.zeros(s, dtype=torch.float32, device=g.device, requires_grad=need)
                for s, _ in meta]

    geo, corr = zeros(geo_shapes_dtypes, need_geo), zeros(corr_shapes_dtypes, need_corr)
    wrt = (geo if need_geo else []) + (corr if need_corr else [])
    grads = iter(())
    if wrt:
        with torch.enable_grad():
            out = geo_lookup(geo, corr, disp.detach(), coords.detach(), radius)
            grads = iter(torch.autograd.grad(out, wrt, g.float()))
    nan_geo = torch.isnan(disp.float())[..., None]  # (B, H, W, 1, 1)
    nan_corr = torch.isnan(coords.float() - disp.float())  # (B, H, W, 1)
    dgeo = [next(grads).masked_fill(nan_geo, float("nan")).to(dt) if need_geo else None
            for _, dt in geo_shapes_dtypes]
    dcorr = [next(grads).masked_fill(nan_corr, float("nan")).to(dt) if need_corr else None
             for _, dt in corr_shapes_dtypes]
    return dgeo, dcorr


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
