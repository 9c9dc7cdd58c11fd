"""PSMNet-style 2-D feature extraction of GWCNet (``dkt_stereo_tpu/nn/psm.py``;
the reference's meta_arch/gwcnet/gwc_main.py:40-115 and
submodules.py:6-9,60-83), NCHW.

Module names are the reference's: ``convbn`` is a ``Sequential(conv, bn)``,
a block's ``conv1`` a ``Sequential(convbn, ReLU)``, ``firstconv`` and
``lastconv`` ``Sequential``s with their ReLUs, so a reference state dict
loads with ``strict=True``. ``bn`` builds the batch norms (frozen, or
updating for GWCNet's ``train_bn``).
"""

from __future__ import annotations

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm2d


def convbn(in_ch: int, out_ch: int, kernel: int, stride: int, pad: int, dilation: int,
           bn=FrozenBatchNorm2d) -> nn.Sequential:
    """submodules.py:6-9: a bias-free conv, padded by its dilation where it
    is dilated, then batch norm."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, kernel, stride, dilation if dilation > 1 else pad,
                  dilation=dilation, bias=False),
        bn(out_ch))


class PSMBasicBlock(nn.Module):
    """submodules.py:60-83: ``convbn`` + ReLU, ``convbn``, plus the input
    (through ``downsample`` where it is given). No ReLU after the add."""

    def __init__(self, in_ch: int, planes: int, stride: int, downsample, pad: int,
                 dilation: int, bn=FrozenBatchNorm2d):
        super().__init__()
        self.conv1 = nn.Sequential(convbn(in_ch, planes, 3, stride, pad, dilation, bn),
                                   nn.ReLU(inplace=True))
        self.conv2 = convbn(planes, planes, 3, 1, pad, dilation, bn)
        self.downsample = downsample

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _make_layer(in_ch, planes, blocks, stride, pad, dilation, bn):
    """A stage of ``blocks`` PSMBasicBlocks (the JAX
    ``FeatureExtractionPSM._layer``), the first with a 1x1 conv + BN
    ``downsample`` where the stride or the width changes."""
    downsample = None
    if stride != 1 or in_ch != planes:
        downsample = nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False), bn(planes))
    layers = [PSMBasicBlock(in_ch, planes, stride, downsample, pad, dilation, bn)]
    layers += [PSMBasicBlock(planes, planes, 1, None, pad, dilation, bn) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class FeatureExtractionPSM(nn.Module):
    """gwc_main.py:59-115. Returns ``{"gwc_feature": l2 | l3 | l4}``, 320
    channels at 1/4 resolution, and with ``concat_feature`` also
    ``"concat_feature"`` (``concat_feature_channel`` channels) through
    ``lastconv``."""

    def __init__(self, concat_feature: bool = False, concat_feature_channel: int = 12,
                 bn=FrozenBatchNorm2d):
        super().__init__()
        self.concat_feature = concat_feature
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1, bn), nn.ReLU(inplace=True),
            convbn(32, 32, 3, 1, 1, 1, bn), nn.ReLU(inplace=True),
            convbn(32, 32, 3, 1, 1, 1, bn), nn.ReLU(inplace=True))
        self.layer1 = _make_layer(32, 32, 3, 1, 1, 1, bn)
        self.layer2 = _make_layer(32, 64, 16, 2, 1, 1, bn)
        self.layer3 = _make_layer(64, 128, 3, 1, 1, 1, bn)
        self.layer4 = _make_layer(128, 128, 3, 1, 1, 2, bn)
        if concat_feature:
            self.lastconv = nn.Sequential(
                convbn(320, 128, 3, 1, 1, 1, bn), nn.ReLU(inplace=True),
                nn.Conv2d(128, concat_feature_channel, 1, bias=False))

    def forward(self, x):
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        gwc = torch.cat([l2, l3, l4], dim=1)
        out = {"gwc_feature": gwc}
        if self.concat_feature:
            out["concat_feature"] = self.lastconv(gwc)
        return out
