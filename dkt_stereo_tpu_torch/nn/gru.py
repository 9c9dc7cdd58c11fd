"""ConvGRU update machinery (``dkt_stereo_tpu/nn/gru.py``; the reference's
core/update.py), NCHW.

The JAX package's ``thin_conv3x3`` (a TPU lane workaround for convs with few
output channels) is a plain 3x3 ``nn.Conv2d`` here, and its ``cond_mask_head``
is a Python ``if``: the mask head runs only when the caller asks for it.
"""

from __future__ import annotations

import torch
from torch import nn

from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_align, pool2x


class FlowHead(nn.Module):
    """core/update.py:6-14."""

    def __init__(self, input_dim=128, hidden_dim=256, output_dim=2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """core/update.py:16-32: 3x3 gated recurrence with context biases
    ``ctx = (cz, cr, cq)`` precomputed from the context features."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        p = kernel_size // 2
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size, padding=p)

    def forward(self, h, ctx, *x_list):
        cz, cr, cq = ctx
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """core/update.py:64-85. ``corr``: (B, L*(2r+1), H, W); ``flow``:
    (B, 2, H, W) with a zero vertical channel. Output 128 channels."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = nn.Conv2d(cor_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 126, 3, padding=1)

    def forward(self, flow, corr):
        relu = torch.relu
        cor = relu(self.convc2(relu(self.convc1(corr))))
        flo = relu(self.convf2(relu(self.convf1(flow))))
        out = relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMultiUpdateBlock(nn.Module):
    """core/update.py:97-138: 3-level GRU hierarchy with cross-scale
    exchange. ``net``: list fine -> coarse; ``inp``: per-scale (cz, cr, cq).
    The iter08/16/32 and ``update`` flags drive the slow-fast schedule
    (raft_stereo.py:157-161)."""

    def __init__(self, n_gru_layers=3, n_downsample=2, hidden_dims=(128, 128, 128),
                 corr_levels=4, corr_radius=4):
        super().__init__()
        hd = hidden_dims
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        encoder_output_dim = 128
        self.gru08 = ConvGRU(hd[2], encoder_output_dim + hd[1] * (n_gru_layers > 1))
        self.gru16 = ConvGRU(hd[1], hd[0] * (n_gru_layers == 3) + hd[2])
        self.gru32 = ConvGRU(hd[0], hd[1])
        self.flow_head = FlowHead(hd[2], hidden_dim=256, output_dim=2)
        factor = 2**n_downsample
        self.mask = nn.Sequential(
            nn.Conv2d(hd[2], 256, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, factor**2 * 9, 1),
        )

    def forward(self, net, inp, corr=None, flow=None, iter08=True, iter16=True, iter32=True,
                update=True, with_mask=True):
        """Returns the new ``net`` list, and with ``update`` also
        ``(mask, delta_flow)``; ``mask`` is None unless ``with_mask`` (test
        mode consumes only the last iteration's mask)."""
        net = list(net)
        if iter32:
            net[2] = self.gru32(net[2], inp[2], pool2x(net[1]))
        if iter16:
            if self.n_gru_layers > 2:
                net[1] = self.gru16(net[1], inp[1], pool2x(net[0]),
                                    interp_bilinear_align(net[2], net[1].shape[2:]))
            else:
                net[1] = self.gru16(net[1], inp[1], pool2x(net[0]))
        if iter08:
            motion = self.encoder(flow, corr)
            if self.n_gru_layers > 1:
                net[0] = self.gru08(net[0], inp[0], motion,
                                    interp_bilinear_align(net[1], net[0].shape[2:]))
            else:
                net[0] = self.gru08(net[0], inp[0], motion)
        if not update:
            return net
        delta_flow = self.flow_head(net[0])
        # scale mask to balance gradients (core/update.py:137)
        mask = 0.25 * self.mask(net[0]) if with_mask else None
        return net, mask, delta_flow
