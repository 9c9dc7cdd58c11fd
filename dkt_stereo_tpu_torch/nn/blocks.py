"""Residual feature/context encoders (``dkt_stereo_tpu/nn/blocks.py``;
the reference's core/extractor.py), NCHW.

Module attribute names are the reference's torch names, so a reference
``.pth`` loads with a strict ``load_state_dict``. The fused full-resolution
path (:func:`fused_fullres_layer1`) reads the same parameters as the
unfused one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dkt_stereo_tpu_torch.nn.norms import Norm, band_refresh
from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage, in_affine


class ResidualBlock(nn.Module):
    """core/extractor.py:6-60: two 3x3 convs + optional 1x1 downsample.
    As in the reference, ``norm3`` is registered twice (also as
    ``downsample.1``), so checkpoints carry both names."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "batch", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)
        self.norm1 = Norm(norm_fn, planes)
        self.norm2 = Norm(norm_fn, planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.norm3 = Norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3
            )

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BottleneckBlock(nn.Module):
    """core/extractor.py:64-120: 1x1 -> 3x3 (strided) -> 1x1 convs at a
    quarter of ``planes`` in the middle, and a 1x1 downsample where the
    stride is not 1. Every group norm takes ``planes // 8`` groups, also
    ``norm1`` and ``norm2`` over ``planes // 4`` channels. As in the
    reference, ``norm4`` is registered twice (also as ``downsample.1``)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, padding=1, stride=stride)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.relu = nn.ReLU(inplace=True)
        groups = planes // 8
        self.norm1 = Norm(norm_fn, planes // 4, groups)
        self.norm2 = Norm(norm_fn, planes // 4, groups)
        self.norm3 = Norm(norm_fn, planes, groups)
        if stride == 1:
            self.downsample = None
        else:
            self.norm4 = Norm(norm_fn, planes, groups)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm4)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        y = self.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


def _res_pair(in_planes, dim, norm_fn, stride):
    """A two-ResidualBlock stage (core/extractor.py:164-170)."""
    return nn.Sequential(
        ResidualBlock(in_planes, dim, norm_fn, stride), ResidualBlock(dim, dim, norm_fn, 1)
    )


def bn_eval_affine(bn: nn.BatchNorm2d, conv_bias=None):
    """Eval-mode BatchNorm (and optionally the preceding conv's bias) folded
    to ``x -> a*x + b``, fp32 (C,) vectors."""
    a = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    b = bn.bias - bn.running_mean * a
    if conv_bias is not None:
        b = b + conv_bias * a
    return a, b


def fused_fullres_layer1(x, stem_weight, layer1: nn.Sequential, norm_fn="instance", stem_bn=None,
                         stem_bias=None):
    """Stem conv + norm1 + layer1 of an encoder through four encoder stages.

    ``x``: (B, Cin, H, W) normalized image in the compute dtype;
    ``stem_weight``: (64, Cin, 7, 7) stride-1 stem; ``layer1``: the encoder's
    stride-1 64-channel stage. ``norm_fn="instance"`` builds per-sample
    affines from the statistics each stage returns; the conv biases vanish
    under IN (it is shift-invariant), so the stem's is dropped.
    ``norm_fn="batch"`` (eval) folds the running statistics and conv biases
    into static affines (pass the stem's BatchNorm and bias). Returns the
    layer1 output (B, 64, H, W) in x's dtype.

    Matches ResidualBlock's y = relu(norm2(conv2(relu(norm1(conv1(x)))))),
    out = relu(x + y) (core/extractor.py:37-60). The chain runs in NHWC; the
    stage outputs stay in the activation dtype, the last residual sum in fp32.
    """
    dt = x.dtype
    B, _, H, W = x.shape
    count = float(H * W)
    convs = [c for blk in layer1 for c in (blk.conv1, blk.conv2)]
    # channels_last makes the NHWC view of the stem output free
    s = F.conv2d(x.contiguous(memory_format=torch.channels_last), stem_weight.to(dt), padding=3)
    s = s.permute(0, 2, 3, 1).contiguous()
    if norm_fn == "batch":
        norms = [n for blk in layer1 for n in (blk.norm1, blk.norm2)]
        affines = [bn_eval_affine(stem_bn, stem_bias)]
        affines += [bn_eval_affine(n, c.bias) for c, n in zip(convs, norms)]
        affines = [(a.expand(B, -1).contiguous(), b.expand(B, -1).contiguous()) for a, b in affines]

        def aff(i, _s, _ss):
            return affines[i + 1]

        a_s, b_s = affines[0]
    elif norm_fn == "instance":
        sf = s.float()
        a_s, b_s = in_affine(sf.sum(dim=(1, 2)), sf.square().sum(dim=(1, 2)), count)
        del sf

        def aff(_i, st, ssq):
            return in_affine(st, ssq, count)
    else:
        raise ValueError(f"fused_fullres_layer1: norm_fn must be 'instance' or 'batch', got {norm_fn!r}")

    # each full-resolution tensor is dropped as soon as it is dead: without
    # autograd that halves the chain's peak (autograd keeps what it saved)
    w = [c.weight for c in convs]
    y1, s1, ss1 = encoder_stage(s, a_s, b_s, w[0])
    a1, b1 = aff(0, s1, ss1)
    y2, s2, ss2 = encoder_stage(y1, a1, b1, w[1])
    del y1
    a2, b2 = aff(1, s2, ss2)
    # block-1 output o1 = relu(relu(norm(y2)) + relu(norm(s))) is the third
    # stage's transformed input; emit it for the block-2 residual
    y3, s3, ss3, o1 = encoder_stage(y2, a2, b2, w[2], v=s, a2=a_s, b2=b_s, emit_h=True)
    del y2, s
    a3, b3 = aff(2, s3, ss3)
    y4, s4, ss4 = encoder_stage(y3, a3, b3, w[3])
    del y3
    a4, b4 = aff(3, s4, ss4)
    t4 = (y4.float() * a4[:, None, None, :] + b4[:, None, None, :]).clamp_min(0.0)
    del y4
    o2 = o1.float()
    del o1
    return (o2 + t4).clamp_min(0.0).to(dt).permute(0, 3, 1, 2)


def _fused_gate(fused_fullres, downsample, norm_fn, x):
    """The JAX gate of the fused path (nn/blocks.py:329-334): downsample 2,
    instance norm (``instance_fast`` too, whose stem and layer1 the fused
    path then normalise with full statistics, as in JAX), even width."""
    return (fused_fullres and downsample == 2 and norm_fn in ("instance", "instance_fast")
            and x.shape[3] % 2 == 0)


class BasicEncoder(nn.Module):
    """Feature encoder (core/extractor.py:122-197): 7x7 stem + 3 stages
    (64, 96, 128) + 1x1 head. ``downsample=2`` gives 1/4 resolution.
    ``fused_fullres``: stem-norm + layer1 through :func:`fused_fullres_layer1`
    where the gate allows."""

    def __init__(self, output_dim=128, norm_fn="batch", downsample=3, fused_fullres=False):
        super().__init__()
        d = downsample
        self.norm_fn, self.downsample, self.fused_fullres = norm_fn, d, fused_fullres
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (d > 2), padding=3)
        self.norm1 = Norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = _res_pair(64, 64, norm_fn, 1)
        self.layer2 = _res_pair(64, 96, norm_fn, 1 + (d > 1))
        self.layer3 = _res_pair(96, 128, norm_fn, 1 + (d > 0))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        if _fused_gate(self.fused_fullres, self.downsample, self.norm_fn, x):
            x = fused_fullres_layer1(x, self.conv1.weight, self.layer1)
        else:
            x = self.relu1(self.norm1(self.conv1(x)))
            x = self.layer1(x)
        # band_refresh: the identity except in exact banded eval
        # (eval/tiled.py), where it exchanges the halo rows between bands
        x = band_refresh(x)
        x = band_refresh(self.layer2(x))
        x = band_refresh(self.layer3(x))
        return self.conv2(x)


class MultiBasicEncoder(nn.Module):
    """Multi-scale context encoder (core/extractor.py:199-300).

    Returns a tuple over scales (1/4, 1/8, 1/16 at downsample=2) of
    ``[head_0(x), head_1(x), ...]``, one head per entry of ``output_dim``;
    the finest scale uses dim[2], the coarsest dim[0]. All modules are built
    whatever ``num_layers`` is, as in the reference. ``head_names`` names the
    three head lists fine -> coarse: RAFT's ``outputs08/16/32``, or IGEV's
    copy of the encoder, which names them by true scale
    (``outputs04/08/16``).

    ``forward(x, dual_inp=True)`` (RAFT's shared backbone,
    raft_stereo.py:97-99) also returns the layer3 features of the whole
    batch, last, and runs the heads on its first half only."""

    def __init__(self, output_dim=((128, 128, 128),), norm_fn="batch", downsample=3,
                 num_layers=3, fused_fullres=False,
                 head_names=("outputs08", "outputs16", "outputs32")):
        super().__init__()
        d = downsample
        self.norm_fn, self.downsample, self.num_layers = norm_fn, d, num_layers
        self.fused_fullres = fused_fullres
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1 + (d > 2), padding=3)
        self.norm1 = Norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = _res_pair(64, 64, norm_fn, 1)
        self.layer2 = _res_pair(64, 96, norm_fn, 1 + (d > 1))
        self.layer3 = _res_pair(96, 128, norm_fn, 1 + (d > 0))
        self.layer4 = _res_pair(128, 128, norm_fn, 2)
        self.layer5 = _res_pair(128, 128, norm_fn, 2)
        self.head_names = head_names
        for name, i in zip(head_names[:2], (2, 1)):
            self.add_module(name, nn.ModuleList(
                nn.Sequential(ResidualBlock(128, 128, norm_fn, 1),
                              nn.Conv2d(128, dim[i], 3, padding=1))
                for dim in output_dim
            ))
        self.add_module(head_names[2], nn.ModuleList(
            nn.Conv2d(128, dim[0], 3, padding=1) for dim in output_dim))

    def forward(self, x, dual_inp: bool = False):
        if _fused_gate(self.fused_fullres, self.downsample, self.norm_fn, x):
            x = fused_fullres_layer1(x, self.conv1.weight, self.layer1)
        else:
            x = self.relu1(self.norm1(self.conv1(x)))
            x = self.layer1(x)
        x = band_refresh(x)  # exact banded eval only; the identity otherwise
        x = band_refresh(self.layer2(x))
        x = band_refresh(self.layer3(x))
        v = x
        if dual_inp:
            x = x[: x.shape[0] // 2]
        heads = [getattr(self, n) for n in self.head_names]
        out = [[f(x) for f in heads[0]]]
        for i, layer in enumerate((self.layer4, self.layer5)[: self.num_layers - 1]):
            x = band_refresh(layer(x))
            out.append([f(x) for f in heads[i + 1]])
        return (*out, v) if dual_inp else tuple(out)
