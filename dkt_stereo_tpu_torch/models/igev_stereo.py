"""IGEV-Stereo (``dkt_stereo_tpu/models/igev_stereo.py``; the reference's
meta_arch/igev_stereo/igev_stereo.py:91-226), test and train mode.

Public conventions are the JAX package's: NHWC images in [0, 255] in,
disparity negative out (igev_stereo.py:216, :222). Test mode returns
``(None, disp_up (B, H, W))``; train mode returns ``{"init_disp": (B, H,
W), "disp_preds": (iters, B, H, W)}``: the context-upsampled initial
disparity and each iteration's context-upsampled disparity. Inside, modules
run NCHW / NCDHW and refinement is a Python loop.

The forward: both views through the MobileNetV2 feature net and the stems
as one batch of 2B; 96-channel descriptors; an 8-group GWC volume over
max_disp/4 disparities; ``corr_stem``, feature attention, the hourglass and
an 8 -> 1 classifier; an fp32 softmax over disparity and soft-argmin give
the initial disparity. The context net feeds the GRUs; each iteration looks
up the combined geometry encoding volume at the current disparity (K4,
``ops/cuda/geo_lookup.py``, on CUDA tensors whatever ``corr_implementation``
says; in train mode its backward kernels carry the gradient to both
pyramids) and adds the GRU's delta to the detached disparity. The
full-resolution context upsampling (``spx_2_gru``, ``spx_gru``, fp32
softmax, ``context_upsample``) runs on every iteration in train mode and on
the last only in test mode, the only one test mode consumes. Train mode
also upsamples the initial disparity through ``spx_4``, ``spx_2`` and
``spx``.

In train mode ``freeze_backbone`` runs the trunk (``feature``, ``stem_2``,
``stem_4``, ``conv``, ``desc``) without autograd, as the reference's
``torch.no_grad()`` (igev_stereo.py:157-168) and the JAX package's
``stop_gradient`` do; its parameters get no gradient. ``remat_iters`` runs
each iteration, its upsampling included, under ``torch.utils.checkpoint``.

Mixed precision follows the JAX model: bf16 autocast over the networks,
with the softmaxes, the regression, the init correlation (from fp32
descriptors), the pyramids and the disparity kept in fp32. The pyramids are
stored in bf16 only on the GPU, with a kernel ``corr_implementation`` and
``corr_dtype: "bfloat16"``, whatever ``mixed_precision`` says
(models/igev_stereo.py:361-372).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dkt_stereo_tpu_torch.nn.blocks import MultiBasicEncoder
from dkt_stereo_tpu_torch.nn.igev_blocks import (
    BasicConvIGEV, Conv2xIGEV, FeatureAtt, HourglassIGEV, IGEVFeature)
from dkt_stereo_tpu_torch.nn.igev_update import BasicMultiUpdateBlockIGEV
from dkt_stereo_tpu_torch.nn.norms import InstanceNorm
from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import geo_lookup
from dkt_stereo_tpu_torch.ops.geometry import CombinedGeoEncodingVolume
from dkt_stereo_tpu_torch.ops.sampler import coords_grid_x
from dkt_stereo_tpu_torch.ops.upsample import context_upsample
from dkt_stereo_tpu_torch.ops.volumes import build_gwc_volume, disparity_regression

# corr_implementation values that take the JAX package's Pallas lookup, and
# with it the bf16 pyramid storage on an accelerator
_KERNEL_IMPLS = ("reg_cuda", "alt_cuda", "pallas")


@dataclasses.dataclass(frozen=True)
class IGEVStereoConfig:
    """Field names and defaults of the JAX ``IGEVStereoConfig``
    (configs/igev_stereo/*.json). ``agg_packed`` selects a TPU layout of the
    JAX package and changes nothing here; ``freeze_backbone`` matters only
    in training."""

    corr_levels: int = 2
    corr_radius: int = 4
    n_downsample: int = 2
    context_norm: str = "batch"
    slow_fast_gru: bool = False
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    max_disp: int = 192
    mixed_precision: bool = True
    freeze_backbone: bool = True
    corr_implementation: str = "reg"
    corr_dtype: str = "bfloat16"
    remat_iters: bool = False
    agg_packed: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    def pyramid_dtype(self, device: torch.device) -> torch.dtype:
        """bf16 storage of the geo and init-corr pyramids on an accelerator
        with a kernel implementation and ``corr_dtype: "bfloat16"``, else
        fp32 (the JAX rule, independent of ``mixed_precision``)."""
        if (self.corr_implementation in _KERNEL_IMPLS and self.corr_dtype == "bfloat16"
                and device.type != "cpu"):
            return torch.bfloat16
        return torch.float32

    @classmethod
    def from_dict(cls, d: dict) -> "IGEVStereoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known}
        return cls(**kw)


def _stem(in_ch: int, out_ch: int) -> nn.Sequential:
    """``stem_2`` / ``stem_4`` (igev_stereo.py:105-116): stride-2 conv + IN
    + LeakyReLU, a bias-free 3x3 conv, IN, ReLU."""
    return nn.Sequential(
        BasicConvIGEV(in_ch, out_ch, norm="instance", kernel=3, stride=2, padding=1),
        nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False), InstanceNorm(), nn.ReLU(),
    )


class IGEVStereo(nn.Module):
    """IGEV-Stereo with ``iters`` GRU refinement iterations, in test mode
    (``test_mode=True``) or train mode."""

    def __init__(self, cfg: IGEVStereoConfig, iters: int = 32, test_mode: bool = True):
        super().__init__()
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        self.cfg, self.iters, self.test_mode = cfg, iters, test_mode
        hd = tuple(cfg.hidden_dims)
        self.cnet = MultiBasicEncoder(
            output_dim=(hd, hd), norm_fn=cfg.context_norm, downsample=cfg.n_downsample,
            num_layers=cfg.n_gru_layers, head_names=("outputs04", "outputs08", "outputs16"),
        )
        self.update_block = BasicMultiUpdateBlockIGEV(cfg.n_gru_layers, hd, cfg.corr_levels,
                                                      cfg.corr_radius)
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1) for i in range(cfg.n_gru_layers)
        )
        self.feature = IGEVFeature()
        self.stem_2 = _stem(3, 32)
        self.stem_4 = _stem(32, 48)
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2 = Conv2xIGEV(24, 32, True, norm="instance")
        self.spx_4 = nn.Sequential(
            BasicConvIGEV(96, 24, norm="instance"),
            nn.Conv2d(24, 24, 3, 1, 1, bias=False), InstanceNorm(), nn.ReLU(),
        )
        self.spx_2_gru = Conv2xIGEV(32, 32, True)
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIGEV(96, 96, norm="instance")
        self.desc = nn.Conv2d(96, 96, 1)
        self.corr_stem = BasicConvIGEV(8, 8, dims=3)
        self.corr_feature_att = FeatureAtt(8, 96)
        self.cost_agg = HourglassIGEV(8)
        self.classifier = nn.Conv3d(8, 1, 3, 1, 1, bias=False)

    def _autocast(self, device: torch.device):
        if not self.cfg.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def _upsample(self, disp, spx_logits):
        """Full-resolution disparity (B, H, W) from a (B, 1, H/4, W/4) one
        and the context weights' logits (B, 9, H, W): fp32 softmax over the
        9 taps, then ``context_upsample`` of disp * 4."""
        spx = torch.softmax(spx_logits.float(), dim=1)
        return context_upsample(disp * 4.0, spx)

    def _iteration(self, net, inp, geo_pyr, corr_pyr, coords, disp, stem_2x, upsample: bool):
        """One refinement iteration (the JAX ``_IGEVIterStep``): the lookup
        at the detached disparity, the GRU update, the new disparity; with
        ``upsample`` also the mask feature and the full-resolution context
        upsampling. Returns ``(net, disp, disp_up or None)``."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        n = cfg.n_gru_layers
        disp = disp.detach()
        geo_feat = geo_lookup(geo_pyr, corr_pyr, disp, coords, cfg.corr_radius)
        with self._autocast(disp.device):
            if n == 3 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter16=True, iter08=False, iter04=False,
                                        update=False)
            if n >= 2 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter16=n == 3, iter08=True, iter04=False,
                                        update=False)
            net, mask_feat_4, delta = self.update_block(
                net, inp, geo_feat.permute(0, 3, 1, 2).to(dt), disp.permute(0, 3, 1, 2).to(dt),
                iter16=n == 3, iter08=n >= 2, with_mask=upsample,
            )
            spx = self.spx_gru(self.spx_2_gru(mask_feat_4, stem_2x)) if upsample else None
        disp = disp + delta.float().permute(0, 2, 3, 1)
        disp_up = self._upsample(disp.permute(0, 3, 1, 2), spx) if upsample else None
        return net, disp, disp_up

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: Optional[torch.Tensor] = None):
        """(image1, image2) NHWC in [0, 255]. Test mode returns (None,
        disp_up (B, H, W)); train mode ``{"init_disp": (B, H, W),
        "disp_preds": (iters, B, H, W)}``; disparity negative. ``flow_init``
        is accepted and unused, as in the reference (igev_stereo.py:151)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        train = not self.test_mode
        D4 = cfg.max_disp // 4
        x1 = (2.0 * (image1 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        B = x1.shape[0]
        dev = x1.device

        trunk_grad = torch.is_grad_enabled() and not (train and cfg.freeze_backbone)
        with self._autocast(dev):
            with torch.set_grad_enabled(trunk_grad):
                x12 = torch.cat([x1, x2], dim=0)
                feats = self.feature(x12)
                stem_2x = self.stem_2(x12)
                stem_4x = self.stem_4(stem_2x)
                feat0 = torch.cat([feats[0], stem_4x], dim=1)
                feats_l = [feat0[:B]] + [f[:B] for f in feats[1:]]
                match = self.desc(self.conv(feat0))
                match_l, match_r = match[:B], match[B:]
                stem_2x = stem_2x[:B]
            gwc = build_gwc_volume(match_l, match_r, D4, 8)
            gwc = self.corr_feature_att(self.corr_stem(gwc), feats_l[0])
            geo_volume = self.cost_agg(gwc, feats_l)
            logits = self.classifier(geo_volume)[:, 0]  # (B, D4, H, W)
            if train:
                xspx = self.spx_2(self.spx_4(feats_l[0]), stem_2x)
                spx_init = self.spx(xspx)
        prob = torch.softmax(logits.float(), dim=1)
        init_disp = disparity_regression(prob, D4)  # (B, 1, H, W)

        with self._autocast(dev):
            cnet_list = self.cnet(x1)
            net = [torch.tanh(o[0]) for o in cnet_list]
            inp = [
                conv(torch.relu(o[1])).split(cfg.hidden_dims[i], dim=1)
                for i, (conv, o) in enumerate(zip(self.context_zqr_convs, cnet_list))
            ]

        geo_fn = CombinedGeoEncodingVolume(
            match_l.float().permute(0, 2, 3, 1), match_r.float().permute(0, 2, 3, 1),
            geo_volume.float(), cfg.corr_levels, cfg.corr_radius,
        )
        pyr_dt = cfg.pyramid_dtype(dev)
        geo_pyr = [v.to(pyr_dt) for v in geo_fn.geo_pyramid]
        corr_pyr = [v.to(pyr_dt) for v in geo_fn.corr_pyramid]
        _, _, Hc, Wc = init_disp.shape
        coords = coords_grid_x(B, Hc, Wc, device=dev)
        disp = init_disp.permute(0, 2, 3, 1).contiguous()  # (B, H, W, 1) fp32

        preds = []
        for itr in range(self.iters):
            # test mode consumes only the last iteration's upsampled disparity
            args = (net, inp, geo_pyr, corr_pyr, coords, disp, stem_2x,
                    train or itr == self.iters - 1)
            if train and cfg.remat_iters:
                net, disp, disp_up = checkpoint(self._iteration, *args, use_reentrant=False)
            else:
                net, disp, disp_up = self._iteration(*args)
            if train:
                preds.append(disp_up)

        if self.test_mode:
            return None, -disp_up
        init_up = self._upsample(init_disp, spx_init)
        return {"init_disp": -init_up, "disp_preds": -torch.stack(preds)}
