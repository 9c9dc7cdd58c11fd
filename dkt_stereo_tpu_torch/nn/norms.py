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

import contextlib

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# --- cross-band instance-norm statistics (exact banded eval) ---------------
#
# eval/tiled.py::banded_forward_exact runs the model on one horizontal band
# of the padded frame a rank. Under :func:`cross_band_stats` every
# InstanceNorm takes its statistics over its band's interior rows only,
# sums them over the ranks and normalises with the global mean and
# variance: the full frame's statistics, since the interiors tile it. The
# context is read at each call (eager torch has no trace time), is
# re-entrant, and is what :func:`band_refresh` reads too.
_BAND: dict | None = None


@contextlib.contextmanager
def cross_band_stats(group, tensor_h: int, halo: int, band_h: int, full_h: int,
                     n_bands: int = 0):
    """All heights at stride 1 (input resolution) and multiples of 32, so
    that the interiors stay integral at every encoder stride. ``group`` is
    the process group of the bands (None: the default one), this rank's
    band its rank there. ``n_bands`` (the group's size) turns on
    :func:`band_refresh`'s halo exchange."""
    global _BAND
    prev = _BAND
    _BAND = dict(group=group, rank=dist.get_rank(group), th=tensor_h, halo=halo, bh=band_h,
                 fh=full_h, n=n_bands)
    try:
        yield
    finally:
        _BAND = prev


def banded() -> bool:
    """Whether a :func:`cross_band_stats` context is open."""
    return _BAND is not None


def _win0(i: int, ctx: dict) -> int:
    """Band ``i``'s window start in the padded frame (``eval/tiled.py``)."""
    return min(max(i * ctx["bh"] - ctx["halo"], 0), ctx["fh"] - ctx["th"])


def band_refresh(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """Halo exchange for exact banded eval (the JAX ``band_refresh``):
    replace each band's top and bottom ``halo`` rows (at ``x``'s stride) by
    its neighbours' values for the same global rows, which are exact there,
    so that convolutions' reach across a band's edge never accumulates past
    the halo. ``dim`` is the row axis: 2 for NCHW features, 1 for the NHWC
    coordinates.

    The rows travel by one all_reduce into zeroed slots, two a boundary
    (the upper band's rows for the lower band's top, the lower band's for
    the upper band's bottom): an all-gather in the one collective every
    backend runs on CUDA tensors. The image's own top and bottom keep their
    rows. The identity outside the context, for one band, without a halo,
    and for a tensor whose height is not the band's at a stride or too
    short to carry the halo."""
    ctx = _BAND
    if ctx is None or ctx["halo"] == 0 or ctx["n"] <= 1 or x.dim() != 4:
        return x
    th, halo, k, n = ctx["th"], ctx["halo"], ctx["rank"], ctx["n"]
    h = x.shape[dim]
    if th % h:
        return x
    s = th // h
    hs = halo // s
    if hs < 1 or h < 2 * hs + 1:
        return x

    w_k = _win0(k, ctx)
    slots = x.new_zeros((n - 1, 2) + x.narrow(dim, 0, hs).shape)
    if k < n - 1:  # rows [win0(k+1), win0(k+1) + halo): the lower band's top
        off = min(max((_win0(k + 1, ctx) - w_k) // s, 0), h - hs)
        slots[k, 0] = x.narrow(dim, off, hs)
    if k > 0:  # rows [win0(k-1) + th - halo, win0(k-1) + th): the upper band's bottom
        off = min(max((_win0(k - 1, ctx) + th - halo - w_k) // s, 0), h - hs)
        slots[k - 1, 1] = x.narrow(dim, off, hs)
    dist.all_reduce(slots, group=ctx["group"])
    top = slots[k - 1, 0] if k > 0 else x.narrow(dim, 0, hs)
    bot = slots[k, 1] if k < n - 1 else x.narrow(dim, h - hs, hs)
    return torch.cat([top, x.narrow(dim, hs, h - 2 * hs), bot], dim)


def _banded_instance_stats(x: torch.Tensor, ctx: dict, eps: float) -> torch.Tensor:
    """``x`` (B, C, h, W) normalised with the statistics of all bands'
    interiors: this band's interior rows summed in fp32 (sum, sum of
    squares, count), one all_reduce, then the single-pass variance, as in
    JAX. The halo and padding rows count for nothing."""
    th, halo, bh, fh, k = ctx["th"], ctx["halo"], ctx["bh"], ctx["fh"], ctx["rank"]
    h = x.shape[2]
    s = th // h  # the feature's stride against the input
    off = k * bh - _win0(k, ctx)  # the interior's offset in the window
    ilen = min(max(fh - k * bh, 0), bh)  # interior rows (the last band may be short)
    inner = x[:, :, off // s:off // s + ilen // s].float()
    B, C = x.shape[:2]
    count = x.new_full((1,), inner.shape[2] * inner.shape[3], dtype=torch.float32)
    sums = torch.cat([inner.sum((2, 3)).reshape(-1), inner.square().sum((2, 3)).reshape(-1),
                      count])
    dist.all_reduce(sums, group=ctx["group"])
    mean = (sums[:B * C] / sums[-1]).view(B, C, 1, 1)
    var = (sums[B * C:2 * B * C] / sums[-1]).view(B, C, 1, 1) - mean.square()
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return (x - mean.to(x.dtype)) * scale


class _Moments(torch.autograd.Function):
    """``(E[t], E[t^2])`` over H and W, in fp32, of a bf16 ``t``: the ops
    of ``t.float()``, ``mean`` and ``square``, with autograd's gradient of
    them bit for bit, but ``t`` itself kept for the backward (which casts
    it again) in place of its fp32 copy: half the bytes."""

    @staticmethod
    def forward(ctx, t):
        tf = t.float()
        ctx.save_for_backward(t)
        return tf.mean(dim=(2, 3), keepdim=True), tf.square().mean(dim=(2, 3), keepdim=True)

    @staticmethod
    def backward(ctx, g_mean, g_msq):
        (t,) = ctx.saved_tensors
        tf = t.float()
        n = t.shape[2] * t.shape[3]
        # mean's backward (expand, / n) and square's (grad * (2 * tf)), summed
        g = g_mean.expand(tf.shape) / n + (g_msq.expand(tf.shape) / n) * (2.0 * tf)
        return g.to(t.dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H and W.

    fp32 inputs use the centred two-pass variance. bf16 inputs take the
    single-pass ``E[x^2] - mean^2`` form with fp32 sums (the JAX package's
    bf16 path) and keep the elementwise math in bf16; with autograd
    recording, the sums go through :class:`_Moments`. The single-pass
    variance is clamped at 0 before ``rsqrt``: cancellation can make it
    slightly negative, where the JAX form gives NaN (a deliberate divergence,
    logged in ROADMAP.md Queue 3).

    Under :func:`cross_band_stats` (exact banded eval) the statistics are
    the global ones of all bands' interiors."""

    def __init__(self, eps: float = 1e-5, stats_stride: int = 1):
        super().__init__()
        self.eps, self.stats_stride = eps, stats_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _BAND is not None:
            # exact banded eval: the global statistics, always at stride 1
            # (a subsample would take a band-shifted grid)
            if x.dim() != 4:
                raise ValueError("cross-band instance-norm statistics are defined for 2-D "
                                 f"feature maps (B, C, H, W); got rank {x.dim()}")
            return _banded_instance_stats(x, _BAND, self.eps)
        s = self.stats_stride
        t = x[:, :, ::s, ::s] if s > 1 else x
        if x.dtype == torch.bfloat16:
            if torch.is_grad_enabled() and t.requires_grad:
                mean, msq = _Moments.apply(t)
            else:
                tf = t.float()
                mean = tf.mean(dim=(2, 3), keepdim=True)
                msq = tf.square().mean(dim=(2, 3), keepdim=True)
            var = (msq - mean.square()).clamp_min(0.0)
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


def Norm(norm_fn: str, channels: int, groups: int | None = None) -> nn.Module:
    """String-dispatched norm module. A factory rather than a wrapper, so
    the BatchNorm's parameters sit at the reference's names (``norm1.weight``,
    not ``norm1.bn.weight``). ``"group"`` takes ``groups`` groups, by
    default ``channels // 8``, the reference's rule for its residual blocks
    and its 64-channel stems (core/extractor.py); its bottleneck block
    passes its own."""
    if norm_fn == "batch":
        return FrozenBatchNorm2d(channels)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "instance_fast":
        return InstanceNorm(stats_stride=4)
    if norm_fn == "group":
        return GroupNorm(groups or channels // 8, channels, eps=1e-5)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")
