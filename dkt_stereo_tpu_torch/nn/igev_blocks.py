"""IGEV building blocks (``dkt_stereo_tpu/nn/igev_blocks.py``; the
reference's meta_arch/igev_stereo/submodule.py, extractor.py ``Feature`` and
igev_stereo.py ``hourglass``), NCHW and NCDHW.

Parameter names are the reference's. Its ``BasicConv`` creates a batch norm
even when it runs none (``bn=False``, as in the hourglass's ``conv1_up``):
the port keeps that unused slot, so that a reference checkpoint loads with
``strict=True``. The JAX package's depth-to-lane packed 3D convs
(``agg_packed``) are a TPU layout with the same outputs: the port always runs
direct 3D convs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dkt_stereo_tpu_torch.nn.conv3d import conv_layer
from dkt_stereo_tpu_torch.nn.mobilenetv2 import MobileNetV2Trunk
from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm2d, FrozenBatchNorm3d, InstanceNorm
from dkt_stereo_tpu_torch.ops.resize import interp_nearest


class BasicConvIGEV(nn.Module):
    """``BasicConv`` / ``BasicConv_IN`` (submodule.py:10-36, 84-107): a
    bias-free 2-D or 3-D conv or transposed conv, then batch norm
    (``norm="batch"``), instance norm (``"instance"``, 2-D) or none, then
    LeakyReLU(0.01) if ``relu``."""

    def __init__(self, in_ch, out_ch, deconv=False, dims=2, norm="batch", relu=True,
                 kernel=3, stride=1, padding=1):
        super().__init__()
        self.norm, self.relu = norm, relu
        self.conv = conv_layer(dims, in_ch, out_ch, kernel, stride, padding, deconv)
        if norm == "instance":
            self.IN = InstanceNorm()
        else:
            self.bn = (FrozenBatchNorm2d if dims == 2 else FrozenBatchNorm3d)(out_ch)

    def forward(self, x):
        x = self.conv(x)
        if self.norm == "batch":
            x = self.bn(x)
        elif self.norm == "instance":
            x = self.IN(x)
        return F.leaky_relu(x, 0.01) if self.relu else x


class Conv2xIGEV(nn.Module):
    """``Conv2x`` / ``Conv2x_IN`` (submodule.py:39-80, 110-150): a stride-2
    conv (or 4x4 transposed conv), resized to ``rem`` by nearest
    interpolation where the shapes differ, then concatenated with (or added
    to) ``rem`` and a 3x3 conv."""

    def __init__(self, in_ch, out_ch, deconv=False, dims=2, concat=True, keep_concat=True,
                 norm="batch", relu=True):
        super().__init__()
        self.concat = concat
        kernel = 4 if deconv else 3
        self.conv1 = BasicConvIGEV(in_ch, out_ch, deconv, dims, norm or "batch", True,
                                   kernel, 2, 1)
        if concat:
            mul = 2 if keep_concat else 1
            self.conv2 = BasicConvIGEV(out_ch * 2, out_ch * mul, False, dims, norm, relu)
        else:
            self.conv2 = BasicConvIGEV(out_ch, out_ch, False, dims, norm, relu)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = interp_nearest(x, rem.shape[2:])
        x = torch.cat([x, rem], dim=1) if self.concat else x + rem
        return self.conv2(x)


class FeatureAtt(nn.Module):
    """submodule.py:227-240: ``cv <- sigmoid(att(feat)) * cv``, the (B, C,
    H, W) attention broadcast over the volume's disparity axis."""

    def __init__(self, cv_chan: int, feat_chan: int):
        super().__init__()
        self.feat_att = nn.Sequential(
            BasicConvIGEV(feat_chan, feat_chan // 2, kernel=1, stride=1, padding=0),
            nn.Conv2d(feat_chan // 2, cv_chan, 1),
        )

    def forward(self, cv, feat):
        return torch.sigmoid(self.feat_att(feat)).unsqueeze(2) * cv


def _conv3(in_ch, out_ch, stride=1, kernel=3, padding=1):
    return BasicConvIGEV(in_ch, out_ch, False, 3, "batch", True, kernel, stride, padding)


def _deconv3(in_ch, out_ch, norm="batch", relu=True):
    return BasicConvIGEV(in_ch, out_ch, True, 3, norm, relu, 4, 2, 1)


class HourglassIGEV(nn.Module):
    """igev_stereo.py:22-89: a 3-level 3D encoder-decoder over the (B, C, D,
    H, W) volume with feature attention at every scale; ``features`` are
    the left image's [x4, x8, x16, x32] maps. Returns 8 channels at the
    input's resolution."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(_conv3(c, c * 2, 2), _conv3(c * 2, c * 2))
        self.conv2 = nn.Sequential(_conv3(c * 2, c * 4, 2), _conv3(c * 4, c * 4))
        self.conv3 = nn.Sequential(_conv3(c * 4, c * 6, 2), _conv3(c * 6, c * 6))
        self.conv3_up = _deconv3(c * 6, c * 4)
        self.conv2_up = _deconv3(c * 4, c * 2)
        # no norm and no activation; its batch norm is created and never run
        self.conv1_up = _deconv3(c * 2, 8, norm=None, relu=False)
        self.agg_0 = nn.Sequential(_conv3(c * 8, c * 4, kernel=1, padding=0),
                                   _conv3(c * 4, c * 4), _conv3(c * 4, c * 4))
        self.agg_1 = nn.Sequential(_conv3(c * 4, c * 2, kernel=1, padding=0),
                                   _conv3(c * 2, c * 2), _conv3(c * 2, c * 2))
        self.feature_att_8 = FeatureAtt(c * 2, 64)
        self.feature_att_16 = FeatureAtt(c * 4, 192)
        self.feature_att_32 = FeatureAtt(c * 6, 160)
        self.feature_att_up_16 = FeatureAtt(c * 4, 192)
        self.feature_att_up_8 = FeatureAtt(c * 2, 64)

    def forward(self, x, features):
        conv1 = self.feature_att_8(self.conv1(x), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


class IGEVFeature(MobileNetV2Trunk):
    """extractor.py:326-361: the MobileNetV2 taps fused U-Net style by
    instance-norm ``Conv2x`` deconvs. Returns [x4 (48), x8 (64), x16 (192),
    x32 (160)]. A subclass of the trunk, so the trunk's parameters sit at
    the reference's ``feature.conv_stem`` / ``feature.blockN`` names."""

    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2xIGEV(160, 96, True, norm="instance")
        self.deconv16_8 = Conv2xIGEV(192, 32, True, norm="instance")
        self.deconv8_4 = Conv2xIGEV(64, 24, True, norm="instance")
        self.conv4 = BasicConvIGEV(48, 48, norm="instance")

    def forward(self, x):
        _, x4, x8, x16, x32 = super().forward(x)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.deconv8_4(x8, x4)
        return [self.conv4(x4), x8, x16, x32]
