"""Convolution layers of the cost-volume stacks (``dkt_stereo_tpu/nn/conv3d.py``).

The JAX package writes two TPU forms here: ``thin_conv3d``, a 3x3x3 conv
with few output channels as a full-lane matmul plus shifted adds, and a
clone of torch's transposed conv as an input-dilated conv. Both are the
plain PyTorch layers in the port: the classifiers' 32 -> 1 and 8 -> 1 tails
are ``nn.Conv3d`` and the up-sampling convs ``nn.ConvTranspose3d``, the
reference's own modules. The depth-to-lane packed convs
(``nn/conv3d_packed.py``) are a TPU lane layout with the same outputs and
are not ported.

:func:`convbn_3d` and :class:`Hourglass3D` are GWCNet's (the reference's
gwcnet/submodules.py:12-15 and gwc_main.py:116-152), with its module
names.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm3d

_LAYERS = {
    (2, False): nn.Conv2d,
    (3, False): nn.Conv3d,
    (2, True): nn.ConvTranspose2d,
    (3, True): nn.ConvTranspose3d,
}


def conv_layer(dims: int, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
               deconv: bool = False, bias: bool = False) -> nn.Module:
    """``nn.Conv{2,3}d`` or, with ``deconv``, ``nn.ConvTranspose{2,3}d``."""
    return _LAYERS[(dims, deconv)](in_ch, out_ch, kernel, stride=stride, padding=padding,
                                   bias=bias)


def convbn_3d(in_ch: int, out_ch: int, kernel: int, stride: int, pad: int,
              bn=FrozenBatchNorm3d) -> nn.Sequential:
    """submodules.py:12-15: a bias-free 3-D conv, then batch norm."""
    return nn.Sequential(nn.Conv3d(in_ch, out_ch, kernel, stride, pad, bias=False), bn(out_ch))


def _deconv_bn(in_ch: int, out_ch: int, bn) -> nn.Sequential:
    """The reference's ``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)``
    then batch norm: doubles D, H and W."""
    return nn.Sequential(nn.ConvTranspose3d(in_ch, out_ch, 3, 2, 1, output_padding=1,
                                            bias=False), bn(out_ch))


class Hourglass3D(nn.Module):
    """gwc_main.py:116-152: two stride-2 encoders, two transposed-conv
    decoders with batch norm, and the ``redir`` 1x1x1 skips; (B, c, D, H, W)
    in and out, D, H and W multiples of 4."""

    def __init__(self, c: int, bn=FrozenBatchNorm3d):
        super().__init__()
        relu = nn.ReLU(inplace=True)
        self.conv1 = nn.Sequential(convbn_3d(c, c * 2, 3, 2, 1, bn), relu)
        self.conv2 = nn.Sequential(convbn_3d(c * 2, c * 2, 3, 1, 1, bn), relu)
        self.conv3 = nn.Sequential(convbn_3d(c * 2, c * 4, 3, 2, 1, bn), relu)
        self.conv4 = nn.Sequential(convbn_3d(c * 4, c * 4, 3, 1, 1, bn), relu)
        self.conv5 = _deconv_bn(c * 4, c * 2, bn)
        self.conv6 = _deconv_bn(c * 2, c, bn)
        self.redir1 = convbn_3d(c, c, 1, 1, 0, bn)
        self.redir2 = convbn_3d(c * 2, c * 2, 1, 1, 0, bn)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        conv4 = self.conv4(self.conv3(conv2))
        conv5 = F.relu(self.conv5(conv4) + self.redir2(conv2))
        return F.relu(self.conv6(conv5) + self.redir1(x))
