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
  - ``alt_cuda`` keeps no volume: the pyramid is the right features pooled
    in the corr dtype (bf16 under mixed precision), and every iteration
    recomputes its taps from them and fmap1, through the K3 kernel on CUDA
    tensors (``ops/cuda/corr_alt.py``; its backward differentiates the
    plain recompute, as the JAX VJP does).
  - ``alt`` is the same lookup in plain PyTorch on every device, from right
    features pooled in fp32 (the JAX model's rule: its levels >= 1 differ
    from ``alt_cuda``'s by one bf16 rounding under mixed precision).

The fnet's full-resolution section (and the cnet's, with an instance-norm
``context_norm``) runs through the K2 kernel when ``pallas_encoder`` is
set, in both modes: in train mode its backward runs K2 again for the
adjoint conv (``ops/cuda/encoder_conv.py::EncoderStage``). ``remat_iters``
recomputes only the GRU iterations, never the encoder. Batch norm is frozen
in both modes (``nn/norms.py::FrozenBatchNorm2d``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder, MultiBasicEncoder
from dkt_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from dkt_stereo_tpu_torch.nn.norms import band_refresh
from dkt_stereo_tpu_torch.ops.corr import corr_lookup_alt as corr_lookup_alt_plain
from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused, fmap_pyramid
from dkt_stereo_tpu_torch.ops.cuda.corr_alt import corr_lookup_alt
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
from dkt_stereo_tpu_torch.ops.sampler import coords_grid_x
from dkt_stereo_tpu_torch.ops.upsample import convex_upsample

# options of the JAX config that this slice does not run, with the ROADMAP.md
# entry that will port them
_UNPORTED = {
    "cosine": "Queue 1 item 4 (cosine corr mode)",
    "mix_fmap_image": "Queue 1 item 4 (mix_fmap_image, train-time image/feature volume mix)",
    "interpolate": "Queue 1 item 4 (backbone_type='interpolate')",
    "fast_in_stats": "Queue 1 item 4 (subsampled IN statistics)",
    "shared_backbone": "Queue 1 item 4 (shared backbone)",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md {_UNPORTED[what]}")


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

    def check_ported(self) -> None:
        """Raise NotImplementedError for the options this slice lacks."""
        if self.corr_implementation not in ("reg", "reg_cuda", "alt", "alt_cuda"):
            raise _unported(self.corr_implementation)
        if self.backbone_type != "default":
            raise _unported(self.backbone_type)
        for flag in ("shared_backbone", "fast_in_stats"):
            if getattr(self, flag):
                raise _unported(flag)


class RAFTStereo(nn.Module):
    """RAFT-Stereo with ``iters`` GRU refinement iterations, in test mode
    (``test_mode=True``) or train mode."""

    def __init__(self, cfg: RAFTStereoConfig, iters: int = 12, test_mode: bool = True):
        super().__init__()
        cfg.check_ported()
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
        self.fnet = BasicEncoder(
            256, "instance", cfg.n_downsample, fused_fullres=cfg.pallas_encoder
        )

    def _autocast(self, device: torch.device):
        if not self.cfg.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

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
                flow_init: Optional[torch.Tensor] = None):
        """(image1, image2) NHWC in [0, 255]; ``flow_init`` (B, H/f, W/f, 1)
        is added to the starting coordinates. Test mode returns (coarse
        (B, H/f, W/f, 1), disp_up (B, H, W)); train mode returns
        ``{"disp_preds": (iters, B, H, W)}``. Disparity is negative flow-x.

        With ``remat_iters`` in train mode each iteration runs under
        ``torch.utils.checkpoint``: its activations are recomputed in the
        backward pass (the lookup's forward included) instead of kept."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        factor = 2**cfg.n_downsample
        x1 = (2.0 * (image1 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2 / 255.0) - 1.0).to(dt).permute(0, 3, 1, 2)

        with self._autocast(x1.device):
            cnet_list = self.cnet(x1)
            fmap = self.fnet(torch.cat([x1, x2], dim=0))
            net = [torch.tanh(o[0]) for o in cnet_list]
            inp = [
                conv(torch.relu(o[1])).split(cfg.hidden_dims[i], dim=1)
                for i, (conv, o) in enumerate(zip(self.context_zqr_convs, cnet_list))
            ]

        corr_dt = cfg.corr_storage_dtype
        fmap1, fmap2 = (f.to(corr_dt).permute(0, 2, 3, 1) for f in fmap.chunk(2, dim=0))
        B, Hc, Wc, _ = fmap1.shape
        coords0 = coords_grid_x(B, Hc, Wc, device=fmap1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init

        if cfg.corr_implementation == "alt_cuda":
            # no volume: the right features pooled and stored in the corr
            # dtype, contiguous (B, H, W2, D) as K3 reads them
            fmap1 = fmap1.contiguous()
            pyramid = fmap_pyramid(fmap2.contiguous(), cfg.corr_levels)
        elif cfg.corr_implementation == "alt":
            # no volume: the right features pooled in fp32
            pyramid = fmap_pyramid(fmap2.float(), cfg.corr_levels)
        else:
            pyramid = corr_pyramid_fused(fmap1, fmap2, cfg.corr_levels, out_dtype=corr_dt)
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
