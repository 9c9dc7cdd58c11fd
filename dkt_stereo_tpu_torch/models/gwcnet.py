"""GWCNet, the group-wise correlation network (``dkt_stereo_tpu/models/gwcnet.py``;
the reference's meta_arch/gwcnet/gwc_main.py:156-326), test and train mode.

Public conventions are the JAX package's: NHWC images in [0, 255] in,
normalised as ``2 * (x / 255) - 1``; disparity negative out. Test mode
returns ``(None, disp (B, H, W))`` from the last classifier; train mode
returns ``{"disp_preds": (4, B, H, W)}``, one prediction per classifier.

The forward: both views through the PSM trunk (320-channel features at 1/4
and, with ``use_concat_volume``, 12-channel concat features); a 40-group
GWC volume over maxdisp/4 disparities, with the concat volume (reference
features masked where w < d) appended; ``dres0``/``dres1``; three stacked
hourglasses; each classifier's 32 -> 1 cost upsampled x4 in D, H and W
(trilinear, half-pixel), an fp32 softmax over disparity and the
soft-argmin. All four classifiers are built in both modes, as the
reference's checkpoints hold them.

Mixed precision follows the JAX model: bf16 autocast over the networks and
the volumes; the upsample, the softmax and the regression in fp32.

Batch norm is frozen, unless ``train_bn`` is set and the model is in train
mode: its norms then normalise with the batch's statistics and update the
running ones as flax does (``nn/norms.py::UpdatingBatchNorm2d``). The DKT
step refuses ``train_bn`` (the JAX step carries no mutable batch
statistics).

With ``ptrans`` the model holds the patch contrastive head
(gwc_main.py:174-181, 290-300), ``projection``: Linear 320 -> 320, a batch
norm, ReLU, Linear 320 -> 256. In train mode, given the augmented patch
views ``augp1``/``augp2`` (B, NP, NV, P, P, 3) of ``data/ptrans.py``, the
views go through the shared trunk after the pair (left, right, then the
patches: the order in which ``train_bn`` updates the statistics), their
``gwc_feature`` is averaged over the patch, projected and L2-normalised in
fp32, and returned as ``z_ps`` (B, NP, 2 NV, 256) beside ``disp_preds``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.conv3d import Hourglass3D, convbn_3d
from dkt_stereo_tpu_torch.nn.norms import (
    FrozenBatchNorm2d, FrozenBatchNorm3d, UpdatingBatchNorm2d, UpdatingBatchNorm3d)
from dkt_stereo_tpu_torch.nn.precision import autocast
from dkt_stereo_tpu_torch.nn.psm import FeatureExtractionPSM
from dkt_stereo_tpu_torch.ops.resize import interp_trilinear_halfpix
from dkt_stereo_tpu_torch.ops.volumes import (
    build_concat_volume, build_gwc_volume, disparity_regression)


@dataclasses.dataclass(frozen=True)
class GWCNetConfig:
    """Field names and defaults of the JAX ``GWCNetConfig``
    (configs/gwcnet/base_g.json, base_gc.json)."""

    maxdisp: int = 192
    use_concat_volume: bool = False
    num_groups: int = 40
    concat_channels: int = 12
    ptrans: bool = False
    mixed_precision: bool = True
    train_bn: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    @classmethod
    def from_dict(cls, d: dict) -> "GWCNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _classifier(bn3) -> nn.Sequential:
    return nn.Sequential(convbn_3d(32, 32, 3, 1, 1, bn3), nn.ReLU(inplace=True),
                         nn.Conv3d(32, 1, 3, 1, 1, bias=False))


class GWCNet(nn.Module):
    """GWCNet in test mode (``test_mode=True``) or train mode. ``iters`` is
    accepted for the registry's uniform signature and unused."""

    def __init__(self, cfg: GWCNetConfig, iters: int = 0, test_mode: bool = True):
        super().__init__()
        self.cfg, self.test_mode = cfg, test_mode
        self.update_bn = cfg.train_bn and not test_mode
        bn2, bn3 = ((UpdatingBatchNorm2d, UpdatingBatchNorm3d) if self.update_bn
                    else (FrozenBatchNorm2d, FrozenBatchNorm3d))
        cc = cfg.concat_channels if cfg.use_concat_volume else 0
        self.feature_extraction = FeatureExtractionPSM(cfg.use_concat_volume, cc, bn2)
        relu = nn.ReLU(inplace=True)
        self.dres0 = nn.Sequential(convbn_3d(cfg.num_groups + 2 * cc, 32, 3, 1, 1, bn3), relu,
                                   convbn_3d(32, 32, 3, 1, 1, bn3), relu)
        self.dres1 = nn.Sequential(convbn_3d(32, 32, 3, 1, 1, bn3), relu,
                                   convbn_3d(32, 32, 3, 1, 1, bn3))
        self.dres2 = Hourglass3D(32, bn3)
        self.dres3 = Hourglass3D(32, bn3)
        self.dres4 = Hourglass3D(32, bn3)
        for i in range(4):
            self.add_module(f"classif{i}", _classifier(bn3))
        if cfg.ptrans:
            # bn2 normalises (N, C) rows as BatchNorm1d does, under its names
            self.projection = nn.Sequential(nn.Linear(320, 320), bn2(320), nn.ReLU(inplace=True),
                                            nn.Linear(320, 256))

    def _autocast(self, device: torch.device):
        return autocast(device, self.cfg.mixed_precision)

    def _regress(self, cost: torch.Tensor, full) -> torch.Tensor:
        """(B, 1, D/4, H/4, W/4) cost -> (B, H, W) negative disparity: the
        fp32 trilinear upsample, the softmax over D, the soft-argmin."""
        logits = interp_trilinear_halfpix(cost.float(), full)[:, 0]
        prob = torch.softmax(logits, dim=1)
        return -disparity_regression(prob, self.cfg.maxdisp)[:, 0]

    def _patch_embeddings(self, augp1: torch.Tensor, augp2: torch.Tensor) -> torch.Tensor:
        """``z_ps`` (B, NP, 2 NV, 256) fp32, unit rows, of the views."""
        B, NP, NV = augp1.shape[:3]
        views = torch.cat([augp1, augp2], dim=2)
        x = (2.0 * (views / 255.0) - 1.0).to(self.cfg.compute_dtype)
        x = x.flatten(0, 2).permute(0, 3, 1, 2)
        feat = self.feature_extraction(x)["gwc_feature"].mean(dim=(2, 3))
        z = self.projection(feat).float()
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return z.reshape(B, NP, 2 * NV, -1)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, flow_init=None,
                augp1: torch.Tensor | None = None, augp2: torch.Tensor | None = None,
                mix_weight=None):
        """(image1, image2) NHWC in [0, 255]. ``flow_init`` is accepted and
        unused, as in the reference, and so is ``mix_weight`` (RAFT's blend
        weight, which the training steps pass to every model).
        ``augp1``/``augp2`` are read only with ``ptrans`` in train mode."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        x1 = (2.0 * (image1 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        B = x1.shape[0]
        D4 = cfg.maxdisp // 4
        with self._autocast(x1.device):
            if self.update_bn and self.training:
                # each view's own batch statistics, left then right, as the
                # JAX model's two calls of the trunk update them
                fL, fR = self.feature_extraction(x1), self.feature_extraction(x2)
            else:
                f = self.feature_extraction(torch.cat([x1, x2], dim=0))
                fL = {k: v[:B] for k, v in f.items()}
                fR = {k: v[B:] for k, v in f.items()}
            vol = build_gwc_volume(fL["gwc_feature"], fR["gwc_feature"], D4, cfg.num_groups)
            if cfg.use_concat_volume:
                cvol = build_concat_volume(fL["concat_feature"], fR["concat_feature"], D4,
                                           mask_ref=True)
                vol = torch.cat([vol, cvol], dim=1)
            cost0 = self.dres0(vol.to(dt))
            cost0 = self.dres1(cost0) + cost0
            out1 = self.dres2(cost0)
            out2 = self.dres3(out1)
            out3 = self.dres4(out2)
            heads = (out3,) if self.test_mode else (cost0, out1, out2, out3)
            first = 3 if self.test_mode else 0
            costs = [getattr(self, f"classif{first + i}")(c) for i, c in enumerate(heads)]
            extra = {}
            if self.cfg.ptrans and not self.test_mode and augp1 is not None:
                extra["z_ps"] = self._patch_embeddings(augp1, augp2)
        _, _, _, Hc, Wc = cost0.shape
        full = (cfg.maxdisp, 4 * Hc, 4 * Wc)
        preds = [self._regress(c, full) for c in costs]
        if self.test_mode:
            return None, preds[0]
        return {"disp_preds": torch.stack(preds), **extra}
