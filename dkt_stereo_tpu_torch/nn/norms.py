"""Normalization layers (``dkt_stereo_tpu/nn/norms.py``), NCHW.

The reference selects norms by string (core/extractor.py). On this slice:
  - ``"instance"``: InstanceNorm2d, eps 1e-5, no affine, no running stats.
  - ``"batch"``: BatchNorm2d with eval-mode running statistics (the DKT
    recipe always freezes BN; raft_stereo.py:56-59).
"""

from __future__ import annotations

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H and W.

    fp32 inputs use the centred two-pass variance. bf16 inputs take the
    single-pass ``E[x^2] - mean^2`` form with fp32 sums (the JAX package's
    bf16 path) and keep the elementwise math in bf16. The single-pass
    variance is clamped at 0 before ``rsqrt``: cancellation can make it
    slightly negative, where the JAX form gives NaN (a deliberate divergence,
    logged in ROADMAP.md Queue 3)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            xf = x.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
            scale = torch.rsqrt(var + self.eps).to(x.dtype)
            return (x - mean.to(x.dtype)) * scale
        mean = x.mean(dim=(2, 3), keepdim=True)
        c = x - mean
        var = c.square().mean(dim=(2, 3), keepdim=True)
        return c * torch.rsqrt(var + self.eps)


def Norm(norm_fn: str, channels: int) -> nn.Module:
    """String-dispatched norm module. A factory rather than a wrapper, so
    the BatchNorm's parameters sit at the reference's names (``norm1.weight``,
    not ``norm1.bn.weight``)."""
    if norm_fn == "batch":
        return nn.BatchNorm2d(channels)
    if norm_fn == "instance":
        return InstanceNorm()
    raise NotImplementedError(
        f"norm_fn {norm_fn!r} is not on the ported slice (ROADMAP.md Queue 1)"
    )
