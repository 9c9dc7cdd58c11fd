"""IGEV's GRU update block (``dkt_stereo_tpu/nn/igev_update.py``; the
reference's meta_arch/igev_stereo/update.py), NCHW.

The finest GRU runs at 1/4 resolution (``gru04``), the motion encoder reads
L*(2r+1)*(8+1) lookup channels and a 1-channel disparity, and the block
emits a 32-channel mask feature for the context upsampling instead of
RAFT's convex mask. The JAX package skips the mask feature's conv with
``lax.cond`` on all but the last test-mode iteration; here that is a Python
``if``.
"""

from __future__ import annotations

import torch
from torch import nn

from dkt_stereo_tpu_torch.nn.gru import ConvGRU, FlowHead
from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_align, pool2x


class BasicMotionEncoderIGEV(nn.Module):
    """update.py:73-92. ``disp``: (B, 1, H, W); ``corr``: (B,
    L*(2r+1)*9, H, W). Output 127 + 1 channels (the disparity last)."""

    def __init__(self, corr_levels: int = 2, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) * (8 + 1)
        self.convc1 = nn.Conv2d(cor_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convd1 = nn.Conv2d(1, 64, 7, padding=3)
        self.convd2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 127, 3, padding=1)

    def forward(self, disp, corr):
        relu = torch.relu
        cor = relu(self.convc2(relu(self.convc1(corr))))
        d = relu(self.convd2(relu(self.convd1(disp))))
        out = relu(self.conv(torch.cat([cor, d], dim=1)))
        return torch.cat([out, disp], dim=1)


class BasicMultiUpdateBlockIGEV(nn.Module):
    """update.py:104-142: the 3-level GRU hierarchy (``gru04`` fine ..
    ``gru16`` coarse) with cross-scale exchange, a 1-channel disparity head
    and the mask-feature head. ``net``: list fine -> coarse; ``inp``:
    per-scale (cz, cr, cq)."""

    def __init__(self, n_gru_layers=3, hidden_dims=(128, 128, 128), corr_levels=2,
                 corr_radius=4):
        super().__init__()
        hd = hidden_dims
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoderIGEV(corr_levels, corr_radius)
        encoder_output_dim = 128
        self.gru04 = ConvGRU(hd[2], encoder_output_dim + hd[1] * (n_gru_layers > 1))
        self.gru08 = ConvGRU(hd[1], hd[0] * (n_gru_layers == 3) + hd[2])
        self.gru16 = ConvGRU(hd[0], hd[1])
        self.disp_head = FlowHead(hd[2], hidden_dim=256, output_dim=1)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hd[2], 32, 3, padding=1), nn.ReLU(inplace=True))

    def forward(self, net, inp, corr=None, disp=None, iter04=True, iter08=True, iter16=True,
                update=True, with_mask=True):
        """Returns the new ``net`` list, and with ``update`` also
        ``(mask_feat_4, delta_disp)``; ``mask_feat_4`` is None unless
        ``with_mask`` (test mode consumes only the last iteration's)."""
        net = list(net)
        if iter16:
            net[2] = self.gru16(net[2], inp[2], pool2x(net[1]))
        if iter08:
            if self.n_gru_layers > 2:
                net[1] = self.gru08(net[1], inp[1], pool2x(net[0]),
                                    interp_bilinear_align(net[2], net[1].shape[2:]))
            else:
                net[1] = self.gru08(net[1], inp[1], pool2x(net[0]))
        if iter04:
            motion = self.encoder(disp, corr)
            if self.n_gru_layers > 1:
                net[0] = self.gru04(net[0], inp[0], motion,
                                    interp_bilinear_align(net[1], net[0].shape[2:]))
            else:
                net[0] = self.gru04(net[0], inp[0], motion)
        if not update:
            return net
        delta_disp = self.disp_head(net[0])
        mask_feat_4 = self.mask_feat_4(net[0]) if with_mask else None
        return net, mask_feat_4, delta_disp
