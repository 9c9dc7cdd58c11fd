"""MobileNetV2-100 feature trunk (``dkt_stereo_tpu/nn/mobilenetv2.py``), as
IGEV's ``Feature`` slices timm's ``mobilenetv2_100``
(meta_arch/igev_stereo/extractor.py:327-343), NCHW.

Parameter names are the reference's: ``conv_stem``, ``bn1``, then
``block0`` .. ``block4``, each a ``Sequential`` of timm stages (``block3``
holds stages 3 and 4), each stage a ``Sequential`` of blocks with timm's
``conv_pw`` / ``conv_dw`` / ``conv_pwl`` / ``bn1..3`` names. Batch norm is
frozen (eval statistics).
"""

from __future__ import annotations

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm2d


def relu6(x):
    return x.clamp(0.0, 6.0)


class DepthwiseSeparable(nn.Module):
    """timm ``DepthwiseSeparableConv`` (stage 0, expansion 1)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv_dw = nn.Conv2d(in_ch, in_ch, 3, stride, 1, groups=in_ch, bias=False)
        self.bn1 = FrozenBatchNorm2d(in_ch)
        self.conv_pw = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = relu6(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    """timm ``InvertedResidual``: 1x1 expand, 3x3 depthwise, 1x1 project;
    residual when the stride is 1 and the channels match."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, expand: int = 6):
        super().__init__()
        mid = in_ch * expand
        self.conv_pw = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv_dw = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid, bias=False)
        self.bn2 = FrozenBatchNorm2d(mid)
        self.conv_pwl = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = relu6(self.bn1(self.conv_pw(x)))
        y = relu6(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


# (expansion, channels, repeats, first stride) of mobilenetv2_100's stages 0-5
_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
           (6, 160, 3, 2))
# the reference's block groups: stage indices per blockN
_GROUPS = ((0,), (1,), (2,), (3, 4), (5,))


class MobileNetV2Trunk(nn.Module):
    """Stem and stages 0-5. Returns the taps [x2, x4, x8, x16, x32] with
    [16, 24, 32, 96, 160] channels (IGEV's tap points)."""

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(32)
        stages, c = [], 32
        for t, out, n, s in _STAGES:
            blocks = []
            for i in range(n):
                stride = s if i == 0 else 1
                blk = DepthwiseSeparable(c, out, stride) if t == 1 else InvertedResidual(
                    c, out, stride, t)
                blocks.append(blk)
                c = out
            stages.append(nn.Sequential(*blocks))
        for g, idx in enumerate(_GROUPS):
            self.add_module(f"block{g}", nn.Sequential(*(stages[i] for i in idx)))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = relu6(self.bn1(self.conv_stem(x)))
        taps = []
        for g in range(len(_GROUPS)):
            x = getattr(self, f"block{g}")(x)
            taps.append(x)
        return taps
