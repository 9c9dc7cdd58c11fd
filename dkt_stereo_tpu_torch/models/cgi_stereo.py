"""CGI-Stereo (``dkt_stereo_tpu/models/cgi_stereo.py``; the reference's
meta_arch/cgi/CGI_Stereo.py:41-268), test and train mode.

Public conventions are the JAX package's: NHWC images in [0, 255] in,
ImageNet-normalised; disparity negative out. Test mode returns ``(None,
disp (B, H, W))``; train mode ``{"disp_preds": [quarter (B, H/4, W/4),
full (B, H, W)]}``, both x4 (CGI_Stereo.py:262-268). The model runs once:
no iterations.

The forward: both views through the MobileNetV2 trunk and the FeatUp
fusion (``feature_up``) as one batch; batch-norm stems at 1/2 and 1/4; 48-d
descriptors; a one-channel norm-correlation volume over maxdisp/4
disparities; ``corr_stem``, the semantic attention volume and the
hourglass with Context-Geometry-Fusion at 1/8, 1/16 and 1/32; top-2
soft-argmin over the hourglass's cost; the superpixel weights (``spx_4``,
``spx_2``, ``spx``, fp32 softmax) upsample it x4.

The reference's ``feature`` also builds a ``deconv32_16`` that its forward
never calls (FeatUp has its own): the port keeps it, a ``Conv2x`` like
FeatUp's, so that a reference checkpoint loads with ``strict=True``. So is
the batch norm of ``conv1_up``, which runs none. Batch norm is frozen in
both modes (CGI_Stereo.py:120).

Mixed precision follows the JAX model: bf16 autocast over the networks;
the norm-correlation volume (from fp32 descriptors), the top-2 regression,
the superpixel softmax and ``context_upsample`` in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.igev_blocks import BasicConvIGEV, Conv2xIGEV, _conv3, _deconv3
from dkt_stereo_tpu_torch.nn.mobilenetv2 import MobileNetV2Trunk
from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm2d
from dkt_stereo_tpu_torch.ops.upsample import context_upsample
from dkt_stereo_tpu_torch.ops.volumes import build_norm_correlation_volume, regression_topk

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class CGIStereoConfig:
    """Field names and defaults of the JAX ``CGIStereoConfig``
    (configs/cgi/base.json)."""

    maxdisp: int = 192
    mixed_precision: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    @classmethod
    def from_dict(cls, d: dict) -> "CGIStereoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class CGIFeature(MobileNetV2Trunk):
    """CGI_Stereo.py:41-68: the MobileNetV2 trunk at the reference's
    ``feature.conv_stem`` / ``feature.blockN`` names, returning its taps
    [x2, x4, x8, x16, x32], and the ``deconv32_16`` it builds and never
    runs."""

    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2xIGEV(160, 96, True)


class FeatUp(nn.Module):
    """CGI_Stereo.py:71-96: the trunk's [x4, x8, x16, x32] fused U-Net style
    by batch-norm ``Conv2x`` deconvs. Returns [x4 (48), x8 (64), x16 (192),
    x32 (160)]."""

    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2xIGEV(160, 96, True)
        self.deconv16_8 = Conv2xIGEV(192, 32, True)
        self.deconv8_4 = Conv2xIGEV(64, 24, True)
        self.conv4 = BasicConvIGEV(48, 48)

    def forward(self, feats):
        x4, x8, x16, x32 = feats
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


def _conv3_155(c: int) -> BasicConvIGEV:
    """A 3-D BasicConv with a (1, 5, 5) kernel: batch norm, LeakyReLU."""
    return BasicConvIGEV(c, c, False, 3, "batch", True, (1, 5, 5), 1, (0, 2, 2))


class ContextGeometryFusion(nn.Module):
    """CGI_Stereo.py:100-123: ``cv <- agg(sigmoid(att(s + cv)) * s + cv)``
    with ``s`` the image features' (B, cv_chan, H, W) projection broadcast
    over the volume's disparity axis."""

    def __init__(self, cv_chan: int, im_chan: int):
        super().__init__()
        self.semantic = nn.Sequential(BasicConvIGEV(im_chan, im_chan // 2, kernel=1, padding=0),
                                      nn.Conv2d(im_chan // 2, cv_chan, 1))
        self.att = nn.Sequential(_conv3_155(cv_chan),
                                 nn.Conv3d(cv_chan, cv_chan, 1, bias=False))
        self.agg = _conv3_155(cv_chan)

    def forward(self, cv, feat):
        s = self.semantic(feat).unsqueeze(2)
        cv = torch.sigmoid(self.att(s + cv)) * s + cv
        return self.agg(cv)


class HourglassFusion(nn.Module):
    """CGI_Stereo.py:126-188: a 3-level 3-D encoder-decoder over the (B, c,
    D, H, W) volume with Context-Geometry-Fusion at 1/32, 1/16 and 1/8
    (``imgs`` the left image's [x4, x8, x16, x32] maps); its last deconv
    gives one channel at the input's resolution, without norm or
    activation."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(_conv3(c, c * 2, 2), _conv3(c * 2, c * 2))
        self.conv2 = nn.Sequential(_conv3(c * 2, c * 4, 2), _conv3(c * 4, c * 4))
        self.conv3 = nn.Sequential(_conv3(c * 4, c * 6, 2), _conv3(c * 6, c * 6))
        self.conv3_up = _deconv3(c * 6, c * 4)
        self.conv2_up = _deconv3(c * 4, c * 2)
        # no norm and no activation; its batch norm is created and never run
        self.conv1_up = _deconv3(c * 2, 1, norm=None, relu=False)
        self.agg_0 = nn.Sequential(_conv3(c * 8, c * 4, kernel=1, padding=0),
                                   _conv3(c * 4, c * 4), _conv3(c * 4, c * 4))
        self.agg_1 = nn.Sequential(_conv3(c * 4, c * 2, kernel=1, padding=0),
                                   _conv3(c * 2, c * 2), _conv3(c * 2, c * 2))
        self.CGF_32 = ContextGeometryFusion(c * 6, 160)
        self.CGF_16 = ContextGeometryFusion(c * 4, 192)
        self.CGF_8 = ContextGeometryFusion(c * 2, 64)

    def forward(self, x, imgs):
        conv1 = self.conv1(x)
        conv2 = self.conv2(conv1)
        conv3 = self.CGF_32(self.conv3(conv2), imgs[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=1))
        conv2 = self.CGF_16(conv2, imgs[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=1))
        conv1 = self.CGF_8(conv1, imgs[1])
        return self.conv1_up(conv1)


def _bn_stem(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    """``stem_2`` / ``stem_4`` / ``spx_4`` (CGI_Stereo.py:200-212): a
    BasicConv, a bias-free 3x3 conv, batch norm, ReLU."""
    return nn.Sequential(BasicConvIGEV(in_ch, out_ch, stride=stride),
                         nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False),
                         FrozenBatchNorm2d(out_ch), nn.ReLU())


class CGIStereo(nn.Module):
    """CGI-Stereo in test mode (``test_mode=True``) or train mode.
    ``iters`` is accepted for the registry's uniform signature and unused."""

    def __init__(self, cfg: CGIStereoConfig, iters: int = 0, test_mode: bool = True):
        super().__init__()
        self.cfg, self.test_mode = cfg, test_mode
        self.feature = CGIFeature()
        self.feature_up = FeatUp()
        self.stem_2 = _bn_stem(3, 32, 2)
        self.stem_4 = _bn_stem(32, 48, 2)
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2 = Conv2xIGEV(32, 32, True)
        self.spx_4 = _bn_stem(96, 32, 1)
        self.conv = BasicConvIGEV(96, 48)
        self.desc = nn.Conv2d(48, 48, 1)
        self.semantic = nn.Sequential(BasicConvIGEV(96, 32), nn.Conv2d(32, 8, 1, bias=False))
        self.agg = _conv3_155(8)
        self.hourglass_fusion = HourglassFusion(8)
        self.corr_stem = BasicConvIGEV(1, 8, dims=3)

    def _autocast(self, device: torch.device):
        if not self.cfg.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, flow_init=None):
        """(image1, image2) NHWC in [0, 255]. ``flow_init`` is accepted and
        unused."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        dev = image1.device
        mean = torch.tensor(IMAGENET_MEAN, device=dev)
        std = torch.tensor(IMAGENET_STD, device=dev)
        x1 = ((image1 / 255.0 - mean) / std).to(dt).permute(0, 3, 1, 2)
        x2 = ((image2 / 255.0 - mean) / std).to(dt).permute(0, 3, 1, 2)
        B = x1.shape[0]
        D4 = cfg.maxdisp // 4
        with self._autocast(dev):
            x12 = torch.cat([x1, x2], dim=0)
            feats = self.feature_up(self.feature(x12)[1:])
            stem_2x = self.stem_2(x12)
            feat0 = torch.cat([feats[0], self.stem_4(stem_2x)], dim=1)  # 96 channels
            match = self.desc(self.conv(feat0))
            feats_l = [feat0[:B]] + [f[:B] for f in feats[1:]]
        cv = build_norm_correlation_volume(match[:B].float(), match[B:].float(), D4).to(dt)
        with self._autocast(dev):
            cv = self.corr_stem(cv)
            sem = self.semantic(feats_l[0]).unsqueeze(2)
            cost = self.hourglass_fusion(self.agg(sem * cv), feats_l)  # (B, 1, D4, H4, W4)
            spx_logits = self.spx(self.spx_2(self.spx_4(feats_l[0]), stem_2x[:B]))
        spx = torch.softmax(spx_logits.float(), dim=1)
        cost = cost[:, 0].float()
        samples = torch.arange(D4, dtype=torch.float32, device=dev).view(1, D4, 1, 1)
        pred = regression_topk(cost, samples.expand_as(cost), 2)  # (B, 1, H4, W4)
        pred_up = context_upsample(pred, spx)
        if self.test_mode:
            return None, -4.0 * pred_up
        return {"disp_preds": [-4.0 * pred[:, 0], -4.0 * pred_up]}
