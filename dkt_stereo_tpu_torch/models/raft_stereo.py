"""RAFT-Stereo (``dkt_stereo_tpu/models/raft_stereo.py``; the reference's
meta_arch/raft_stereo/raft_stereo.py:30-187), test and train mode.

Public conventions are the JAX package's: NHWC images in [0, 255] in;
disparity as negative flow-x out. Test mode returns ``(coarse (B, H/f, W/f,
1), disp_up (B, H, W))``; train mode returns ``{"disp_preds": (iters, B, H,
W)}``, one convex-upsampled disparity per iteration. Inside, modules run
NCHW and refinement is a Python loop.

Mixed precision follows the JAX package (and the reference's autocast): the
normalised images are cast to bf16, encoders and GRUs run under bf16
autocast, the fmaps are cast to ``corr_dtype`` before the pyramid, the
lookup interpolates in fp32 and is rounded once to the compute dtype for the
motion encoder (JAX's ``corr.astype(dt)``), and the coordinates and the
convex upsampling stay fp32. Only the x component of the GRU's delta is
kept, and the flow fed back to the motion encoder has a zero y channel.

Correlation modes, in both modes of the model:

  - ``reg`` and ``reg_cuda`` build the volume pyramid once; on CUDA tensors
    both look it up through the K1 kernel, which writes the motion
    encoder's input in the compute dtype, and differentiate it through K1's
    backward, which reads its gradient in that dtype
    (``ops/cuda/corr_lookup.py``).
  - ``cosine`` is the same with the cosine pyramid (both feature maps
    L2-normalised, no 1/sqrt(D)); JAX looks it up through its XLA lookup,
    the port through K1.
  - ``mix_fmap_image`` is ``cosine`` in test mode. In train mode it blends
    the cosine volume of the features with that of the images resized to
    1/f (D = 3), ``p * image + (1 - p) * feature`` in fp32 with one weight
    ``p`` a forward (the ``mix_weight`` argument, else one U(0, 1) draw
    from ``generator``, else 0.5: the JAX model's ``mix`` rng), pools the
    blend and looks it up through K1, both ways.
  - ``alt_cuda`` keeps no volume: the pyramid is the right features pooled
    in the corr dtype (bf16 under mixed precision), and every iteration
    recomputes its taps from them and fmap1, through the K3 kernel on CUDA
    tensors (``ops/cuda/corr_alt.py``; its backward differentiates the
    plain recompute, as the JAX VJP does).
  - ``alt`` is the same lookup in plain PyTorch on every device, from right
    features pooled in fp32 (the JAX model's rule: its levels >= 1 differ
    from ``alt_cuda``'s by one bf16 rounding under mixed precision).

Feature maps: the fnet's (``fast_in_stats`` gives it instance norms whose
statistics come from every 4th row and column); with ``shared_backbone``
the cnet's layer3 over both images through ``conv2`` (a residual block and
a 3x3 conv to 256 channels), and no fnet; with ``backbone_type=
"interpolate"`` the normalised images themselves resized to 1/f (D = 3; no
fnet), which ``alt_cuda`` looks up through K3 at D = 3.

The fnet's full-resolution section (and the cnet's, with an instance-norm
``context_norm``) runs through the K2 kernel when ``pallas_encoder`` is
set, in both modes (with ``fast_in_stats`` the fused stem and layer1 keep
exact statistics, as in JAX): in train mode its backward runs K2 again for the
adjoint conv (``ops/cuda/encoder_conv.py::EncoderStage``). ``remat_iters``
recomputes only the GRU iterations, never the encoder. Batch norm is frozen
in both modes (``nn/norms.py::FrozenBatchNorm2d``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder, MultiBasicEncoder, ResidualBlock
from dkt_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from dkt_stereo_tpu_torch.nn.norms import band_refresh
from dkt_stereo_tpu_torch.nn.precision import autocast
from dkt_stereo_tpu_torch.ops.corr import corr_lookup_alt as corr_lookup_alt_plain
from dkt_stereo_tpu_torch.ops.corr import (
    corr_pyramid, corr_pyramid_fused, corr_volume, fmap_pyramid)
from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_align
from dkt_stereo_tpu_torch.ops.sampler import coords_grid_x
from dkt_stereo_tpu_torch.ops.upsample import convex_upsample

CORR_MODES = ("reg", "reg_cuda", "pallas", "cosine", "mix_fmap_image", "alt", "alt_cuda")
BACKBONES = ("default", "interpolate")


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """Field names and defaults of the JAX ``RAFTStereoConfig``
    (configs/raft_stereo/*.json + the reference CLI defaults)."""

    backbone_type: str = "default"
    corr_implementation: str = "reg"
    shared_backbone: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    context_norm: str = "batch"
    slow_fast_gru: bool = False
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    mixed_precision: bool = True
    corr_dtype: str = "bfloat16"
    fast_in_stats: bool = False
    pallas_encoder: bool = False
    remat_iters: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    @property
    def corr_storage_dtype(self) -> torch.dtype:
        """bf16 pyramid storage only under mixed precision (the JAX AMP
        boundary, models/raft_stereo.py:263-274)."""
        if self.mixed_precision and self.corr_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    @classmethod
    def from_dict(cls, d: dict) -> "RAFTStereoConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known}
        return cls(**kw)

    def check(self) -> None:
        """Raise ValueError for a correlation mode or backbone the JAX model
        does not have (``pallas`` is its other name for ``reg_cuda``)."""
        if self.corr_implementation not in CORR_MODES:
            raise ValueError(f"corr_implementation must be one of {CORR_MODES}, "
                             f"got {self.corr_implementation!r}")
        if self.backbone_type not in BACKBONES:
            raise ValueError(f"backbone_type must be one of {BACKBONES}, "
                             f"got {self.backbone_type!r}")


class RAFTStereo(nn.Module):
    """RAFT-Stereo with ``iters`` GRU refinement iterations, in test mode
    (``test_mode=True``) or train mode."""

    def __init__(self, cfg: RAFTStereoConfig, iters: int = 12, test_mode: bool = True):
        super().__init__()
        cfg.check()
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        self.cfg, self.iters, self.test_mode = cfg, iters, test_mode
        hd = tuple(cfg.hidden_dims)
        self.cnet = MultiBasicEncoder(
            output_dim=(hd, hd), norm_fn=cfg.context_norm, downsample=cfg.n_downsample,
            num_layers=cfg.n_gru_layers, fused_fullres=cfg.pallas_encoder,
        )
        self.update_block = BasicMultiUpdateBlock(
            cfg.n_gru_layers, cfg.n_downsample, hd, cfg.corr_levels, cfg.corr_radius
        )
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1) for i in range(cfg.n_gru_layers)
        )
        # the interpolate backbone's feature maps are the resized images
        if cfg.backbone_type == "default" and cfg.shared_backbone:
            # the reference's conv2 head on the cnet's layer3 (raft_stereo.py:43-45)
            self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", 1),
                                       nn.Conv2d(128, 256, 3, padding=1))
        elif cfg.backbone_type == "default":
            self.fnet = BasicEncoder(256, "instance_fast" if cfg.fast_in_stats else "instance",
                                     cfg.n_downsample, fused_fullres=cfg.pallas_encoder)

    def _autocast(self, device: torch.device):
        return autocast(device, self.cfg.mixed_precision)

    @staticmethod
    def _mix_weight(mix_weight, generator, device) -> torch.Tensor:
        """The image volume's fp32 weight in ``mix_fmap_image``."""
        if mix_weight is not None:
            return torch.as_tensor(mix_weight, dtype=torch.float32).to(device)
        if generator is not None:
            return torch.rand((), generator=generator, device=generator.device).to(device)
        return torch.tensor(0.5, device=device)

    def _lookup(self, fmap1, pyramid, coords1):
        """The motion encoder's correlation input: (B, L*(2r+1), H, W) in the
        compute dtype, channels last in memory. K1 writes it so itself; the
        no-volume lookups' NHWC fp32 output is permuted and cast."""
        r, dt = self.cfg.corr_radius, self.cfg.compute_dtype
        if self.cfg.corr_implementation == "alt_cuda":
            corr = corr_lookup_alt(fmap1, pyramid, coords1, r)
        elif self.cfg.corr_implementation == "alt":
            corr = corr_lookup_alt_plain(fmap1, pyramid, coords1, r)
        else:
            return corr_lookup(pyramid, coords1, r, dt)
        return corr.permute(0, 3, 1, 2).to(dt)

    def _iteration(self, net, inp, fmap1, pyramid, coords0, coords1, with_mask: bool,
                   upsample: bool):
        """One refinement iteration (the JAX ``_IterStep._one_iter``). The
        incoming coordinates are detached (the reference's
        ``coords1.detach()``); the GRU state is not. ``fmap1`` is None for
        the volume modes. Returns ``(net, coords1, mask)``, or ``(net,
        coords1, disp_up)`` with ``upsample`` (train mode: each iteration's
        convex-upsampled disparity)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        n = cfg.n_gru_layers
        coords1 = coords1.detach().contiguous()
        corr = self._lookup(fmap1, pyramid, coords1)
        flow_x = coords1 - coords0
        flow2 = torch.cat([flow_x, torch.zeros_like(flow_x)], dim=-1).permute(0, 3, 1, 2)
        with self._autocast(coords1.device):
            if n == 3 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter32=True, iter16=False, iter08=False,
                                        update=False)
            if n >= 2 and cfg.slow_fast_gru:
                net = self.update_block(net, inp, iter32=n == 3, iter16=True, iter08=False,
                                        update=False)
            net, mask, delta = self.update_block(
                net, inp, corr, flow2.to(dt),
                iter32=n == 3, iter16=n >= 2, with_mask=with_mask,
            )
        # stereo: only the x component of the delta survives
        coords1 = coords1 + delta[:, 0:1].float().permute(0, 2, 3, 1)
        # exact banded eval (the identity otherwise): refresh the carried
        # state's halo rows every iteration, so that the GRUs' reach across
        # a band's edge never accumulates over the loop
        net = [band_refresh(h) for h in net]
        coords1 = band_refresh(coords1, dim=1)
        if upsample:
            disp = (coords1 - coords0).permute(0, 3, 1, 2)
            return net, coords1, convex_upsample(disp, mask.float(), 2**cfg.n_downsample)[:, 0]
        return net, coords1, mask

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: Optional[torch.Tensor] = None, mix_weight=None,
                generator: Optional[torch.Generator] = None):
        """(image1, image2) NHWC in [0, 255]; ``flow_init`` (B, H/f, W/f, 1)
        is added to the starting coordinates. Test mode returns (coarse
        (B, H/f, W/f, 1), disp_up (B, H, W)); train mode returns
        ``{"disp_preds": (iters, B, H, W)}``. Disparity is negative flow-x.

        ``mix_weight`` (a number or a 0-d tensor) or one U(0, 1) draw from
        ``generator`` is the image volume's weight of ``mix_fmap_image`` in
        train mode (0.5 without either); no other mode reads them.

        With ``remat_iters`` in train mode each iteration runs under
        ``torch.utils.checkpoint``: its activations are recomputed in the
        backward pass (the lookup's forward included) instead of kept."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        factor = 2**cfg.n_downsample
        x1 = (2.0 * (image1 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        H, W = x1.shape[2:]
        fine = (H // factor, W // factor)

        with self._autocast(x1.device):
            if cfg.backbone_type == "interpolate":
                cnet_list = self.cnet(x1)
            elif cfg.shared_backbone:
                *cnet_list, x = self.cnet(torch.cat([x1, x2], dim=0), dual_inp=True)
                fmap = self.conv2(x)
            else:
                cnet_list = self.cnet(x1)
                fmap = self.fnet(torch.cat([x1, x2], dim=0))
            net = [torch.tanh(o[0]) for o in cnet_list]
            inp = [
                conv(torch.relu(o[1])).split(cfg.hidden_dims[i], dim=1)
                for i, (conv, o) in enumerate(zip(self.context_zqr_convs, cnet_list))
            ]
        if cfg.backbone_type == "interpolate":
            fmap = torch.cat([interp_bilinear_align(x, fine) for x in (x1, x2)], dim=0)

        corr_dt = cfg.corr_storage_dtype
        fmap1, fmap2 = (f.to(corr_dt).permute(0, 2, 3, 1) for f in fmap.chunk(2, dim=0))
        B, Hc, Wc, _ = fmap1.shape
        coords0 = coords_grid_x(B, Hc, Wc, device=fmap1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        mode = cfg.corr_implementation
        if mode == "alt_cuda":
            # no volume: the right features pooled and stored in the corr
            # dtype, contiguous (B, H, W2, D) as K3 reads them
            fmap1 = fmap1.contiguous()
            pyramid = fmap_pyramid(fmap2.contiguous(), cfg.corr_levels)
        elif mode == "alt":
            # no volume: the right features pooled in fp32
            pyramid = fmap_pyramid(fmap2.float(), cfg.corr_levels)
        elif mode == "mix_fmap_image" and not self.test_mode:
            # the image volume and the feature volume, both cosine, blended
            # in fp32 by one weight a forward and then pooled
            # (raft_stereo/corr.py:216-228)
            vol_feat = corr_volume(fmap1, fmap2, normalize=True, out_dtype=corr_dt)
            fi1, fi2 = (interp_bilinear_align(x.to(corr_dt), fine).permute(0, 2, 3, 1)
                        for x in (x1, x2))
            vol_img = corr_volume(fi1, fi2, normalize=True, out_dtype=corr_dt)
            p = self._mix_weight(mix_weight, generator, vol_img.device)
            pyramid = corr_pyramid(p * vol_img.float() + (1.0 - p) * vol_feat.float(),
                                   cfg.corr_levels)
            fmap1 = None
        else:
            pyramid = corr_pyramid_fused(fmap1, fmap2, cfg.corr_levels, out_dtype=corr_dt,
                                         normalize=mode in ("cosine", "mix_fmap_image"))
            fmap1 = None

        if not self.test_mode:
            preds = []
            for _ in range(self.iters):
                args = (net, inp, fmap1, pyramid, coords0, coords1, True, True)
                if cfg.remat_iters:
                    net, coords1, disp_up = checkpoint(self._iteration, *args, use_reentrant=False)
                else:
                    net, coords1, disp_up = self._iteration(*args)
                preds.append(disp_up)
            return {"disp_preds": torch.stack(preds)}

        for itr in range(self.iters):
            # test mode consumes only the final iteration's mask
            net, coords1, mask = self._iteration(
                net, inp, fmap1, pyramid, coords0, coords1, itr == self.iters - 1, False
            )
        disp = coords1 - coords0
        disp_up = convex_upsample(disp.permute(0, 3, 1, 2), mask.float(), factor)[:, 0]
        return disp, disp_up
