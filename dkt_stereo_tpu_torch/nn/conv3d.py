"""Convolution layers of the cost-volume stacks (``dkt_stereo_tpu/nn/conv3d.py``).

The JAX package writes two TPU forms here: ``thin_conv3d``, a 3x3x3 conv
with few output channels as a full-lane matmul plus shifted adds, and a
clone of torch's transposed conv as an input-dilated conv. Both are the
plain PyTorch layers in the port: IGEV's classifier is an ``nn.Conv3d`` and
its up-sampling convs are ``nn.ConvTranspose3d``, the reference's own
modules. The depth-to-lane packed convs (``nn/conv3d_packed.py``) are a TPU
lane layout with the same outputs and are not ported.
"""

from __future__ import annotations

from torch import nn

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
