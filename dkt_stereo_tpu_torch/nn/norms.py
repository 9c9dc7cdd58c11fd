"""Normalization layers (``dkt_stereo_tpu/nn/norms.py``), NCHW.

The reference selects norms by string (core/extractor.py); :func:`Norm`
builds all five of the JAX package's:
  - ``"instance"``: InstanceNorm2d, eps 1e-5, no affine, no running stats;
    ``"instance_fast"`` the same with its statistics taken from every 4th
    row and column (the JAX ``InstanceNorm(stats_stride=4)``).
  - ``"batch"``: :class:`FrozenBatchNorm2d`, BatchNorm with its running
    statistics in train and eval mode alike (the DKT recipe always freezes
    BN; raft_stereo.py:56-59). Its affine weight and bias stay trainable.
    :class:`FrozenBatchNorm3d` is the same over cost volumes.
  - ``"group"``: :class:`GroupNorm`, eps 1e-5, with an affine.
  - ``"none"``: the identity.

:class:`UpdatingBatchNorm2d` / ``3d`` normalise with the batch's statistics
in train mode and update the running ones as flax does; only GWCNet's
``train_bn`` builds them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H and W.

    fp32 inputs use the centred two-pass variance. bf16 inputs take the
    single-pass ``E[x^2] - mean^2`` form with fp32 sums (the JAX package's
    bf16 path) and keep the elementwise math in bf16. The single-pass
    variance is clamped at 0 before ``rsqrt``: cancellation can make it
    slightly negative, where the JAX form gives NaN (a deliberate divergence,
    logged in ROADMAP.md Queue 3)."""

    def __init__(self, eps: float = 1e-5, stats_stride: int = 1):
        super().__init__()
        self.eps, self.stats_stride = eps, stats_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stats_stride
        t = x[:, :, ::s, ::s] if s > 1 else x
        if x.dtype == torch.bfloat16:
            tf = t.float()
            mean = tf.mean(dim=(2, 3), keepdim=True)
            var = (tf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
            scale = torch.rsqrt(var + self.eps).to(x.dtype)
            return (x - mean.to(x.dtype)) * scale
        mean = t.mean(dim=(2, 3), keepdim=True)
        var = (t - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with its running statistics and
    never updates them, whatever ``train()`` says: the reference's freeze_bn
    (tools/ft_dkt.py:155-167) and the JAX package's
    ``use_running_average=True``. The affine weight and bias are ordinary
    parameters; the state dict keeps BatchNorm2d's names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class FrozenBatchNorm3d(nn.BatchNorm3d):
    """:class:`FrozenBatchNorm2d` over (B, C, D, H, W) volumes."""

    forward = FrozenBatchNorm2d.forward


class UpdatingBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training rule (``nn.BatchNorm(momentum=0.9)``):
    in train mode it normalises with the batch's mean and biased variance,
    both reduced in fp32, and sets ``running = 0.9 * running + 0.1 * batch``
    with that biased variance, where ``torch.nn.BatchNorm`` would store the
    unbiased one. In eval mode it is :class:`FrozenBatchNorm2d`.
    ``num_batches_tracked`` is left as it is (flax keeps no count)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return FrozenBatchNorm2d.forward(self, x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        mean = xf.mean(dim=dims)
        var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class UpdatingBatchNorm3d(nn.BatchNorm3d):
    """:class:`UpdatingBatchNorm2d` over (B, C, D, H, W) volumes."""

    forward = UpdatingBatchNorm2d.forward


class GroupNorm(nn.GroupNorm):
    """GroupNorm, eps 1e-5, with an affine; the statistics and the
    normalisation in fp32 and the output in the input's dtype, as flax's
    ``nn.GroupNorm`` computes them."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def Norm(norm_fn: str, channels: int) -> nn.Module:
    """String-dispatched norm module. A factory rather than a wrapper, so
    the BatchNorm's parameters sit at the reference's names (``norm1.weight``,
    not ``norm1.bn.weight``). ``"group"`` takes ``channels // 8`` groups, the
    reference's rule for its residual blocks and its 64-channel stems
    (core/extractor.py)."""
    if norm_fn == "batch":
        return FrozenBatchNorm2d(channels)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "instance_fast":
        return InstanceNorm(stats_stride=4)
    if norm_fn == "group":
        return GroupNorm(channels // 8, channels, eps=1e-5)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")
