"""PCVNet, the parameterized cost volume network
(``dkt_stereo_tpu/models/pcvnet.py``; the reference's
meta_arch/pcvnet/model.py:26-196), in test and train mode.

Public conventions are the JAX package's: NHWC images in [0, 255] in; test
mode returns ``(None, -refined_up (B, H, W))``; train mode returns
``{"disp_preds": -refined_up[None], "output_list": (refined_up (B, H, W),
disp_seq (N, B, H, W), mu_seq, w_seq, sigma_seq (N, B, H, W, G))}``, the
per-iteration outputs convex-upsampled, positive. The model works on
positive disparities and negates at the API (JAX ``models/pcvnet.py:8-13``),
and it refines after the last iteration whatever ``valid_iters`` says
(:15-18). With ``cascade=True`` test mode returns the last iteration's
upsampled mixture instead, ``{"disp": (B, H, W, 1), "mu", "sigma", "w": (B,
H, W, G)}``, which ``init_param`` of a second, finer stage takes; train mode
adds that dict, read off the last iteration's outputs, as
``init_params``. Inside, modules run NCHW, the mixture parameters are (B,
G, H, W) and the iterations are a Python loop.

Gradients follow the JAX model (:83-152): every iteration detaches the
incoming centres (coords1), and the update block and the updater read the
mixture detached, but sigma enters the lookup undetached (model.py:121-122
detaches only coords1), so the loss reaches the previous iteration's
updater through K5's position gradient. The per-iteration disparity
upsamples with the mask attached, mu, sigma and w with it detached; the
refinement reads the final mixture detached and upsamples with the last
mask detached. ``remat_iters`` runs each train-mode iteration, its
upsampling included, under ``torch.utils.checkpoint``.

The forward: both views through the context encoder as one batch; the
shared layer3 features through ``conv2`` give the 256-channel fmaps; the
correlation pyramid is ``f1 @ pooled(f2)`` pooled by the compress factor
(4 at ``n_downsample`` 2, else 2), one level per ``corr_levels``. Each
iteration samples every level at ``G*S`` positions ``mu + sigma*dx`` per
pixel (K5) and runs the slow-fast GRU hierarchy, whose updater moves the
mixture in closed form.

The lookup goes through ``ops/cuda/row_sample.py::gaussian_row_sample``,
which returns the motion encoder's input folded and in the compute dtype:
one K5 launch an iteration over every level on CUDA tensors, for every
``corr_implementation`` (``reg``, ``reg_cuda``, ``alt_cuda``, ``pallas``:
all build the volume), as RAFT's ``reg`` takes K1 on the card; its plain
twin on the CPU. In JAX ``reg`` is the XLA lookup and the other three the
Pallas kernel (``models/pcvnet.py:98-108``); the two agree to 1e-4
(``tests/test_pallas_row_sample.py``).

Mixed precision follows the JAX model: the normalised images are cast to
bf16 and the networks run under bf16 autocast; the fmaps are cast to the
corr dtype (a bf16 pyramid by default); the positions, mu, sigma and w stay
fp32, and the motion encoder reads them cast to the compute dtype;
RefineNet reads its inputs in the compute dtype and its output is cast to
fp32 before the convex upsampling.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dkt_stereo_tpu_torch.nn.blocks import ResidualBlock
from dkt_stereo_tpu_torch.nn.pcv import (
    BasicMultiUpdateBlockPCV, PCVMultiBasicEncoder, RefineNet, gaussian_positions)
from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused
from dkt_stereo_tpu_torch.ops.cuda.row_sample import gaussian_row_sample
from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_align, interp_nearest
from dkt_stereo_tpu_torch.ops.upsample import convex_upsample


@dataclasses.dataclass(frozen=True)
class PCVNetConfig:
    """The fields of the JAX ``PCVNetConfig`` (configs/pcvnet/base.json;
    fast.json differs only in ``n_downsample`` 3). ``valid_iters`` and
    ``corr_implementation`` are read by nothing here: the caller sets the
    iterations, and every ``corr_implementation`` builds the volume and
    takes K5 on the card."""

    corr_levels: int = 3
    n_downsample: int = 2
    context_norm: str = "batch"
    slow_fast_gru: bool = True
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, ...] = (128, 128, 128, 128)
    gauss_num: int = 4
    sample_num: int = 9
    init_sigma: float = 32.0
    init_mu: Tuple[float, ...] = (0.0, 64.0, 128.0, 192.0)
    mixed_precision: bool = True
    valid_iters: int = 32
    corr_implementation: str = "reg"
    corr_dtype: str = "bfloat16"
    # run each train-mode iteration under torch.utils.checkpoint
    remat_iters: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed_precision else torch.float32

    @property
    def corr_storage_dtype(self) -> torch.dtype:
        """bf16 pyramid storage only under mixed precision (JAX
        ``models/pcvnet.py:197-201``)."""
        if self.mixed_precision and self.corr_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    @property
    def compress_factor(self) -> int:
        return 4 if self.n_downsample == 2 else 2

    @classmethod
    def from_dict(cls, d: dict) -> "PCVNetConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in known}
        return cls(**kw)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class PCVNet(nn.Module):
    """PCVNet with ``iters`` GRU iterations, in test or train mode;
    ``cascade`` returns the upsampled mixture for a second stage."""

    def __init__(self, cfg: PCVNetConfig, iters: int = 12, test_mode: bool = True,
                 cascade: bool = False):
        super().__init__()
        if iters < 1:
            raise ValueError(f"iters must be at least 1, got {iters}")
        self.cfg, self.iters, self.test_mode, self.cascade = cfg, iters, test_mode, cascade
        hd = tuple(cfg.hidden_dims)
        self.cnet = PCVMultiBasicEncoder((hd, hd), cfg.context_norm, cfg.n_downsample)
        self.conv2 = nn.Sequential(ResidualBlock(128, 128, "instance", 1),
                                   nn.Conv2d(128, 256, 3, padding=1))
        # the context heads' widths: outputs08 dim[0], outputs16 dim[1],
        # outputs32 dim[3]
        heads = (hd[0], hd[1], hd[3])
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(heads[i], hd[i] * 3, 3, padding=1) for i in range(cfg.n_gru_layers))
        self.FDM = BasicMultiUpdateBlockPCV(cfg.n_gru_layers, cfg.n_downsample, hd, cfg.gauss_num,
                                            cfg.sample_num, cfg.corr_levels)
        self.refineNet = RefineNet(cfg.gauss_num)

    def _autocast(self, device: torch.device):
        if not self.cfg.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=torch.bfloat16)

    def _iteration(self, net, inp, pyramid, coords0, coords1, sigma, w, with_mask: bool):
        """One iteration (the JAX ``_PCVIterStep``): the lookup at the
        current mixture, the slow-fast GRU schedule with the motion features
        computed once, and the updater. coords1 comes in detached and sigma
        reaches the lookup undetached; the update block and the updater read
        mu, w and sigma detached. Returns ``(net, coords1, sigma, w, mu,
        mask)`` with the updater's mu."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        n = cfg.n_gru_layers
        coords1 = coords1.detach()
        sigma_d, w_d = sigma.detach(), w.detach()
        pos = gaussian_positions(coords1, sigma, cfg.sample_num)
        # the motion encoder's folded input, in the compute dtype
        corr = gaussian_row_sample(pyramid, pos, cfg.compress_factor, cfg.gauss_num, dt)
        mu = coords0 - coords1
        with self._autocast(coords1.device):
            mfl = self.FDM.motion_features(mu.to(dt), corr, w_d.to(dt), sigma_d.to(dt))
            if n >= 3 and cfg.slow_fast_gru:
                net = self.FDM(net, inp, mfl, iter16=True, iter08=False, iter04=False,
                               update=False)
            if n >= 2 and cfg.slow_fast_gru:
                net = self.FDM(net, inp, mfl, iter16=n >= 3, iter08=True, iter04=False,
                               update=False)
            net, mask, mu, sigma, w = self.FDM(net, inp, mfl, mu=mu, w=w_d, sigma=sigma_d,
                                               iter16=n >= 3, iter08=n >= 2, iter04=True,
                                               with_mask=with_mask)
        return net, coords0 - mu, sigma, w, mu, mask

    def _train_iteration(self, net, inp, pyramid, coords0, coords1, sigma, w):
        """One train-mode iteration and its upsampled outputs: the mixture
        disparity with the mask attached, mu, sigma and w (unscaled) with it
        detached, each (B, H, W[, G]). Returns ``(net, coords1, sigma, w,
        mask, (disp_up, mu_up, w_up, sigma_up))``."""
        net, coords1, sigma, w, mu, mask = self._iteration(
            net, inp, pyramid, coords0, coords1, sigma, w, True)
        factor = 2**self.cfg.n_downsample
        mask = mask.float()
        mask_det = mask.detach()
        disp = (w * mu).sum(dim=1, keepdim=True)
        ys = (convex_upsample(disp, mask, factor)[:, 0],
              _nhwc(convex_upsample(mu, mask_det, factor)),
              _nhwc(convex_upsample(w, mask_det, factor, scale=False)),
              _nhwc(convex_upsample(sigma, mask_det, factor)))
        return net, coords1, sigma, w, mask, ys

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                flow_init: Optional[torch.Tensor] = None, init_param: Optional[dict] = None):
        """(image1, image2) NHWC in [0, 255]. ``flow_init`` is ignored, as in
        the JAX model (it keeps the DKT step's model-generic call).
        ``init_param``: a coarser stage's cascade dict (NHWC), which sets the
        starting mixture (model.py:99-108). See the module docstring for
        what each mode returns."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        G = cfg.gauss_num
        factor = 2**cfg.n_downsample
        train = not self.test_mode
        x1 = _nchw((2.0 * (image1 / 255.0) - 1.0).to(dt))
        x2 = _nchw((2.0 * (image2 / 255.0) - 1.0).to(dt))

        with self._autocast(x1.device):
            *cnet_list, xfeat, low_f = self.cnet(torch.cat([x1, x2], dim=0), dual_inp=True)
            fmap = self.conv2(xfeat)
            net = [torch.tanh(o[0]) for o in cnet_list]
            inp = [
                conv(torch.relu(o[1])).split(cfg.hidden_dims[i], dim=1)
                for i, (conv, o) in enumerate(zip(self.context_zqr_convs, cnet_list))
            ]

        corr_dt = cfg.corr_storage_dtype
        fmap1, fmap2 = (_nhwc(f.to(corr_dt)) for f in fmap.chunk(2, dim=0))
        pyramid = corr_pyramid_fused(fmap1, fmap2, cfg.corr_levels, out_dtype=corr_dt,
                                     pool_factor=cfg.compress_factor)

        B, Hc, Wc, _ = fmap1.shape
        dev = fmap1.device
        coords0 = torch.arange(Wc, dtype=torch.float32, device=dev).view(1, 1, 1, Wc)
        coords0 = coords0.expand(B, G, Hc, Wc)
        if init_param is not None:
            # the cascade's second stage (model.py:99-108)
            f_sc = Wc / init_param["mu"].shape[2]
            mu0 = f_sc * interp_bilinear_align(_nchw(init_param["mu"]).float(), (Hc, Wc))
            sigma = f_sc * interp_bilinear_align(_nchw(init_param["sigma"]).float(), (Hc, Wc))
            w = interp_nearest(_nchw(init_param["w"]).float(), (Hc, Wc))
            coords1 = coords0 - mu0
        else:
            start = torch.tensor(cfg.init_mu, dtype=torch.float32, device=dev) / factor
            coords1 = coords0 - start.view(1, G, 1, 1)
            sigma = torch.full((B, G, Hc, Wc), cfg.init_sigma / factor, device=dev)
            w = torch.full((B, G, Hc, Wc), 1.0 / G, device=dev)

        ys = []
        for itr in range(self.iters):
            if train:
                args = (net, inp, pyramid, coords0, coords1, sigma, w)
                if cfg.remat_iters:
                    net, coords1, sigma, w, mask, y = checkpoint(self._train_iteration, *args,
                                                                 use_reentrant=False)
                else:
                    net, coords1, sigma, w, mask, y = self._train_iteration(*args)
                ys.append(y)
            else:
                # test mode consumes only the final iteration's mask
                net, coords1, sigma, w, _, mask = self._iteration(
                    net, inp, pyramid, coords0, coords1, sigma, w, itr == self.iters - 1)

        mu = coords0 - coords1
        disp = (w * mu).sum(dim=1, keepdim=True)
        mask = mask.float().detach()
        if self.cascade and not train:
            return {
                "disp": _nhwc(convex_upsample(disp, mask, factor)),
                "sigma": _nhwc(convex_upsample(sigma, mask, factor)),
                "mu": _nhwc(convex_upsample(mu, mask, factor)),
                "w": _nhwc(convex_upsample(w, mask, factor, scale=False)),
            }
        with self._autocast(x1.device):
            refined = self.refineNet(w.detach().to(dt), sigma.detach().to(dt),
                                     mu.detach().to(dt), disp.detach().to(dt), low_f)
        refined_up = convex_upsample(refined.float(), mask, factor)[:, 0]
        if not train:
            return None, -refined_up
        disp_seq, mu_seq, w_seq, sigma_seq = (torch.stack(t) for t in zip(*ys))
        out = {"disp_preds": -refined_up[None],
               "output_list": (refined_up, disp_seq, mu_seq, w_seq, sigma_seq)}
        if self.cascade:
            out["init_params"] = {"disp": disp_seq[-1][..., None], "sigma": sigma_seq[-1],
                                  "mu": mu_seq[-1], "w": w_seq[-1]}
        return out
