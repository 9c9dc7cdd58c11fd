"""RAFT-Stereo inference (``dkt_stereo_tpu/models/raft_stereo.py``; the
reference's meta_arch/raft_stereo/raft_stereo.py:30-187).

Public conventions are the JAX package's: NHWC images in [0, 255] in, and in
test mode ``(coarse (B, H/f, W/f, 1), disp_up (B, H, W))`` out, disparity as
negative flow-x. Inside, modules run NCHW and refinement is a Python loop.

Mixed precision follows the JAX package (and the reference's autocast): the
normalised images are cast to bf16, encoders and GRUs run under bf16
autocast, the fmaps are cast to ``corr_dtype`` before the pyramid, and the
lookup, the coordinates and the convex upsampling stay fp32. Only the x
component of the GRU's delta is kept, and the flow fed back to the motion
encoder has a zero y channel.

On CUDA tensors both ``reg`` and ``reg_cuda`` look the pyramid up through
the K1 kernel (``ops/cuda/corr_lookup.py``); the fnet's full-resolution
section runs through the K2 kernel when ``pallas_encoder`` is set.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder, MultiBasicEncoder
from dkt_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
from dkt_stereo_tpu_torch.ops.sampler import coords_grid_x
from dkt_stereo_tpu_torch.ops.upsample import convex_upsample

# options of the JAX config that this slice does not run, with the ROADMAP.md
# entry that will port them
_UNPORTED = {
    "alt": "Queue 1 item 2 (corr_lookup_alt) / Queue 2 K3",
    "alt_cuda": "Queue 2 K3 (corr_lookup_alt_pallas)",
    "cosine": "Queue 1 item 4 (cosine corr mode)",
    "mix_fmap_image": "Queue 1 item 4 (train-time corr modes)",
    "interpolate": "Queue 1 item 4 (backbone_type='interpolate')",
    "fast_in_stats": "Queue 1 item 4 (subsampled IN statistics)",
    "remat_iters": "Queue 1 item 5 (training: torch.utils.checkpoint)",
    "shared_backbone": "Queue 1 item 4 (shared backbone)",
    "train": "Queue 1 item 4 (train mode) and item 5 (DKT training)",
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
        if self.corr_implementation not in ("reg", "reg_cuda"):
            raise _unported(self.corr_implementation)
        if self.backbone_type != "default":
            raise _unported(self.backbone_type)
        for flag in ("shared_backbone", "fast_in_stats", "remat_iters"):
            if getattr(self, flag):
                raise _unported(flag)


class RAFTStereo(nn.Module):
    """Test-mode RAFT-Stereo. ``iters`` GRU refinement iterations."""

    def __init__(self, cfg: RAFTStereoConfig, iters: int = 12, test_mode: bool = True):
        super().__init__()
        cfg.check_ported()
        if not test_mode:
            raise _unported("train")
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        self.cfg, self.iters = cfg, iters
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

    def forward(self, image1: torch.Tensor, image2: torch.Tensor):
        """(image1, image2) NHWC in [0, 255] -> (coarse (B, H/f, W/f, 1),
        disp_up (B, H, W)), disparity as negative flow-x."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        factor = 2**cfg.n_downsample
        n = cfg.n_gru_layers
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
        pyramid = corr_pyramid_fused(fmap1, fmap2, cfg.corr_levels, out_dtype=corr_dt)

        B, Hc, Wc, _ = fmap1.shape
        coords0 = coords_grid_x(B, Hc, Wc, device=fmap1.device)
        coords1 = coords0
        up_mask = None
        for itr in range(self.iters):
            corr = corr_lookup(pyramid, coords1, cfg.corr_radius)
            flow_x = coords1 - coords0
            flow2 = torch.cat([flow_x, torch.zeros_like(flow_x)], dim=-1).permute(0, 3, 1, 2)
            with self._autocast(x1.device):
                if n == 3 and cfg.slow_fast_gru:
                    net = self.update_block(net, inp, iter32=True, iter16=False, iter08=False,
                                            update=False)
                if n >= 2 and cfg.slow_fast_gru:
                    net = self.update_block(net, inp, iter32=n == 3, iter16=True, iter08=False,
                                            update=False)
                net, mask, delta = self.update_block(
                    net, inp, corr.permute(0, 3, 1, 2).to(dt), flow2.to(dt),
                    iter32=n == 3, iter16=n >= 2, with_mask=itr == self.iters - 1,
                )
            # stereo: only the x component of the delta survives
            coords1 = coords1 + delta[:, 0:1].float().permute(0, 2, 3, 1)
            if mask is not None:
                up_mask = mask

        disp = coords1 - coords0
        disp_up = convex_upsample(disp.permute(0, 3, 1, 2), up_mask.float(), factor)[:, 0]
        return disp, disp_up
