"""PCVNet building blocks (``dkt_stereo_tpu/nn/pcv.py``; the reference's
meta_arch/pcvnet/{extractor,update,refinement}.py), NCHW.

Module attribute names are the reference's torch names, so a reference
``.pth`` loads with a strict ``load_state_dict``. The mixture parameters
mu, sigma and w are (B, G, H, W) here, one channel per Gaussian.

- :class:`PCVMultiBasicEncoder`: the context encoder with PCV's strides
  and head widths, its dual-input batch and the low-level head.
- :func:`gaussian_positions` and :func:`gaussian_corr_lookup`: the sample
  positions ``mu + sigma * dx`` and the plain lookup of the pyramid there
  (K5's plain twin, ``ops/cuda/row_sample.py``).
- :class:`BasicMotionEncoderPCV`, :class:`ParametersUpdater`,
  :class:`BasicMultiUpdateBlockPCV` (the slow-fast GRU hierarchy) and
  :class:`RefineNet`.
"""

from __future__ import annotations

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.blocks import ResidualBlock, _res_pair
from dkt_stereo_tpu_torch.nn.gru import ConvGRU, FlowHead
from dkt_stereo_tpu_torch.nn.norms import Norm
from dkt_stereo_tpu_torch.ops.cuda.row_sample import gaussian_row_sample_plain
from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_align, pool2x


def _conv_relu(cin, cout, k=3, stride=1, padding=1, dilation=1):
    """The reference's ``Sequential(conv, ReLU)`` (parameters at ``.0``)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding, dilation), nn.ReLU(inplace=True))


class PCVMultiBasicEncoder(nn.Module):
    """extractor.py:196-332. conv1 always has stride 2; layer2 has stride 1
    at ``downsample`` 2 (finest head at 1/4) and 2 otherwise (1/8). The
    heads read ``outputs08`` dim[0], ``outputs16`` dim[1] and ``outputs32``
    dim[3] of each ``output_dim`` entry, as the reference does.

    ``forward(x, dual_inp=True)`` returns ``(outputs08, outputs16,
    outputs32, v, low_f)``: the heads and the 32-channel low-level features
    of the first half of the batch, and ``v`` the layer3 features of the
    whole batch; without ``dual_inp`` only the three head lists."""

    def __init__(self, output_dim=((128,) * 4, (128,) * 4), norm_fn="batch", downsample=2):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = Norm(norm_fn, 64)
        self.relu1 = nn.ReLU(inplace=True)
        self.layer1 = _res_pair(64, 64, norm_fn, 1)
        self.layer2 = _res_pair(64, 96, norm_fn, 1 if downsample == 2 else 2)
        self.layer3 = _res_pair(96, 128, norm_fn, 2)
        self.layer4 = _res_pair(128, 128, norm_fn, 2)
        self.layer5 = _res_pair(128, 128, norm_fn, 2)
        self.low_level_conv = nn.Sequential(
            nn.Conv2d(128, 32, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(32, 32, 3, padding=1), nn.ReLU(inplace=True),
        )
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), nn.Conv2d(128, dim[0], 3, padding=1))
            for dim in output_dim)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, 1), nn.Conv2d(128, dim[1], 3, padding=1))
            for dim in output_dim)
        self.outputs32 = nn.ModuleList(nn.Conv2d(128, dim[3], 3, padding=1) for dim in output_dim)

    def forward(self, x, dual_inp: bool = True):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        v = x
        if dual_inp:
            x = x[: x.shape[0] // 2]
        out08 = [f(x) for f in self.outputs08]
        y = self.layer4(x)
        out16 = [f(y) for f in self.outputs16]
        z = self.layer5(y)
        out32 = [f(z) for f in self.outputs32]
        if dual_inp:
            return out08, out16, out32, v, self.low_level_conv(x)
        return out08, out16, out32


def gaussian_positions(mu_coords: torch.Tensor, sigma: torch.Tensor, sample_num: int) -> torch.Tensor:
    """(B, G, H, W) mixture centres and widths -> (B, H, W, G*S) contiguous
    fp32 positions ``mu + sigma * dx``, dx = -S//2..S//2, Gaussian-major
    (corr.py:33-51): the one expression both lookups sample."""
    half = sample_num // 2
    dx = torch.arange(-half, half + 1, dtype=torch.float32, device=mu_coords.device)
    mu = mu_coords.float().permute(0, 2, 3, 1)[..., None]
    sg = sigma.float().permute(0, 2, 3, 1)[..., None]
    x = mu + sg * dx  # (B, H, W, G, S)
    return x.reshape(*x.shape[:3], -1)


def gaussian_corr_pyramid(volume: torch.Tensor, num_levels: int, compress_factor: int):
    """corr.py:24-31: ``num_levels`` levels of a (B, H, W1, W2) volume, each
    mean-pooled by ``compress_factor`` along W2 (a ragged tail dropped)."""
    pyr = [volume]
    v = volume
    for _ in range(num_levels - 1):
        w2 = v.shape[-1]
        keep = (w2 // compress_factor) * compress_factor
        v = v[..., :keep].reshape(*v.shape[:-1], w2 // compress_factor, compress_factor).mean(-1)
        pyr.append(v)
    return pyr


def gaussian_corr_lookup(pyramid, mu_coords, sigma, sample_num: int, compress_factor: int):
    """The plain Gaussian lookup (corr.py:33-51): (B, H, W, L*G*S) fp32,
    level-major, then Gaussian, then sample, the order the motion encoder
    folds."""
    return gaussian_row_sample_plain(
        pyramid, gaussian_positions(mu_coords, sigma, sample_num), compress_factor)


class BasicMotionEncoderPCV(nn.Module):
    """update.py:37-61: per-Gaussian correlation convs (the Gaussians folded
    into the batch) and a branch on the mixture parameters, which passes no
    gradient to w and sigma. Output 48*G + 64 channels (256 at G = 4)."""

    def __init__(self, gauss_num=4, sample_num=9, corr_levels=3):
        super().__init__()
        G = gauss_num
        self.G, self.S, self.L = gauss_num, sample_num, corr_levels
        self.convc1 = nn.Conv2d(corr_levels * sample_num, 64, 3, padding=1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convc3 = nn.Conv2d(64, 48, 3, padding=1)
        # the folded lookup arrives channels-last (ops/cuda/row_sample.py):
        # with the corr branch's weights in that layout too, cuDNN runs the
        # three convs without a layout transform and PyTorch copies no weight
        for conv in (self.convc1, self.convc2, self.convc3):
            conv.to(memory_format=torch.channels_last)
        self.convf1 = nn.Conv2d(3 * G, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64 - 3 * G, 3, padding=1)

    def forward(self, mu, corr, w, sigma):
        """mu, w, sigma: (B, G, H, W); corr: the lookup folded to (B*G, L*S,
        H, W), channel l*S + s (``ops/cuda/row_sample.py::fold_lookup``, what
        ``gaussian_row_sample`` returns)."""
        relu = torch.relu
        B, G, H, W = mu.shape
        c = relu(self.convc3(relu(self.convc2(relu(self.convc1(corr))))))
        c = c.reshape(B, G * 48, H, W)  # channel g*48 + c
        # the parameter branch sees w and sigma without their gradient, as
        # JAX's stop_gradient there (nn/pcv.py:154-156); mu keeps its gradient
        param = torch.cat([mu, w.detach(), sigma.detach()], dim=1)
        pf = relu(self.convf2(relu(self.convf1(param))))
        return torch.cat([c, pf, param], dim=1)


class ParametersUpdater(nn.Module):
    """update.py:77-112: the closed-form mu/sigma/w updates from the GRU
    state's delta, in fp32 (FlowHead's output cast first)."""

    def __init__(self, hidden_dim=128, gauss_num=4):
        super().__init__()
        self.G = gauss_num
        self.head = FlowHead(hidden_dim, 256, gauss_num)

    def forward(self, hidden, mu, sigma, w):
        """hidden (B, C, H, W); mu, sigma, w (B, G, H, W). Returns the
        updated (mu, w, sigma), fp32."""
        delta = self.head(hidden).float()
        mu, sigma, w = mu.float(), sigma.float(), w.float()
        M = float(self.G)
        sigma0, eps = 0.5, 1e-3
        d_sigma = 0.5 * (((1 - M * w) * sigma**2 - sigma0**2 - delta**2) / (M * sigma**3)
                         + w * sigma / sigma0**2)
        d_mu = -0.5 * delta * (1 / (M * sigma**2) + w / sigma0**2)
        beta = 0.5 * (-1 / (M * w + eps) + torch.log(sigma0 * M * w / sigma + eps)
                      + (sigma**2 + delta**2) / (2 * sigma0**2) + 0.5)
        d_w = beta - beta.sum(dim=1, keepdim=True) / M
        d_sigma = d_sigma.clamp(-3, 3)
        d_mu = d_mu.clamp(-128, 128)
        d_w = d_w.clamp(-1 / (M * 4), 1 / (M * 4))
        sigma = (sigma - d_sigma).clamp(0.1, 16.0)
        mu = mu - d_mu
        w = (w - d_w).clamp(0.0, 1.0)
        w = w / w.sum(dim=1, keepdim=True)
        return mu, w, sigma


class BasicMultiUpdateBlockPCV(nn.Module):
    """update.py:115-170: the 3-level GRU hierarchy (``gru04`` finest); the
    coarser levels read strided motion features. ``hidden_dims`` has four
    entries and the finest GRU uses [3]."""

    def __init__(self, n_gru_layers=3, n_downsample=2, hidden_dims=(128,) * 4, gauss_num=4,
                 sample_num=9, corr_levels=3):
        super().__init__()
        hd = hidden_dims
        self.n_gru_layers = n_gru_layers
        mf = 48 * gauss_num + 64
        self.encoder = BasicMotionEncoderPCV(gauss_num, sample_num, corr_levels)
        self.conv2 = _conv_relu(mf, 128, stride=2)
        self.conv2_out = _conv_relu(128, 128)
        self.conv3 = _conv_relu(128, 128, stride=2)
        self.conv3_out = _conv_relu(128, 128)
        self.gru04 = ConvGRU(hd[3], mf + hd[2] * (n_gru_layers > 1))
        self.gru08 = ConvGRU(hd[2], 128 + hd[3] + hd[1] * (n_gru_layers > 2))
        self.gru16 = ConvGRU(hd[1], 128 + hd[2])
        self.ParametersUpdater = ParametersUpdater(hd[3], gauss_num)
        factor = 2**n_downsample
        self.mask = nn.Sequential(
            nn.Conv2d(hd[3], 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, factor**2 * 9, 1),
        )

    def motion_features(self, mu, corr, w, sigma):
        """The motion features at the three GRU scales (computed once an
        iteration, update.py:130-141); the strided branches read them
        detached."""
        mf = self.encoder(mu, corr, w, sigma)
        if self.n_gru_layers < 2:
            return [mf]
        m08_0 = self.conv2(mf.detach())
        m08 = self.conv2_out(m08_0)
        if self.n_gru_layers < 3:
            return [mf, m08]
        return [mf, m08, self.conv3_out(self.conv3(m08_0.detach()))]

    def forward(self, net, inp, mfl, mu=None, w=None, sigma=None, iter04=True, iter08=True,
                iter16=True, update=True, with_mask=True):
        """``net``: hidden states fine -> coarse; ``inp``: per-scale (cz, cr,
        cq); ``mfl``: :meth:`motion_features`. Returns the new ``net``, and
        with ``update`` also ``(mask, mu, sigma, w)`` from the updater;
        ``mask`` is None unless ``with_mask`` (test mode consumes only the
        last iteration's)."""
        net = list(net)
        n = self.n_gru_layers
        if iter16:
            net[2] = self.gru16(net[2], inp[2], mfl[2], pool2x(net[1]))
        if iter08:
            if n > 2:
                net[1] = self.gru08(net[1], inp[1], mfl[1], pool2x(net[0]),
                                    interp_bilinear_align(net[2], net[1].shape[2:]))
            else:
                net[1] = self.gru08(net[1], inp[1], mfl[1], pool2x(net[0]))
        if iter04:
            if n > 1:
                net[0] = self.gru04(net[0], inp[0], mfl[0],
                                    interp_bilinear_align(net[1], net[0].shape[2:]))
            else:
                net[0] = self.gru04(net[0], inp[0], mfl[0])
        if not update:
            return net
        mu, w, sigma = self.ParametersUpdater(net[0], mu, sigma, w)
        mask = 0.25 * self.mask(net[0]) if with_mask else None
        return net, mask, mu, sigma, w


class RefineNet(nn.Module):
    """refinement.py:5-37: uncertainty-weighted dilated refinement of the
    mixture's disparity."""

    def __init__(self, gauss_num=4):
        super().__init__()
        G = gauss_num
        self.conv0 = nn.Sequential(
            nn.Conv2d(2 * G + 1, 64, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(64, 64, 3, padding=1), nn.ReLU(inplace=True),
        )
        self.conv_softmask = nn.Sequential(nn.Conv2d(64, 1, 3, padding=1), nn.Sigmoid())
        self.conv_disp = _conv_relu(1, 32, 7, padding=3)
        self.conv1 = _conv_relu(32 + 32 + 2 * G + 64, 64)
        self.conv2 = _conv_relu(64, 64, padding=3, dilation=3)
        self.conv3 = _conv_relu(64, 64, padding=7, dilation=7)
        self.conv4 = nn.Conv2d(64, 1, 3, padding=1)

    def forward(self, w, sigma, mu, disp, features):
        """w, sigma, mu: (B, G, H, W); disp: (B, 1, H, W); features: the
        encoder's 32-channel low-level map."""
        w_sigma = w * sigma
        u = self.conv0(torch.cat([w_sigma, mu, disp], dim=1))
        umap = self.conv_softmask(u)
        x = self.conv_disp(disp)
        x = self.conv3(self.conv2(self.conv1(torch.cat([x, features, w_sigma, mu, u], dim=1))))
        return disp + self.conv4(x) * umap
