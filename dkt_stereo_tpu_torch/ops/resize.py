"""Resizing / pooling with torch semantics, over NCHW tensors and NCDHW
volumes (``dkt_stereo_tpu/ops/resize.py``: ``interp_bilinear_align``,
``interp_bilinear_halfpix``, ``interp_trilinear_halfpix``,
``interp_nearest``, ``upflow``, ``avg_pool2d``, ``pool2x``, ``pool4x``). The JAX package writes
these as matmuls and a depthwise conv for the TPU; here they are PyTorch
operators and an index gather."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dkt_stereo_tpu_torch.nn import norms


def _interp_rows_banded(x: torch.Tensor, Ho: int, ctx: dict) -> torch.Tensor:
    """The rows of an ``align_corners=True`` resize under exact banded eval
    (the JAX ``_interp_rows_banded``): output row o of the whole frame reads
    input position ``o * (Hin - 1) / (Hout - 1)`` of the whole frame's
    heights, a map that depends on the frame's height, so a band's own
    resize would differ everywhere, not only at its edges. Here the band's
    rows take the frame's positions, shifted by the window's offset (the
    sources stay inside the band: a x2 exchange moves them by far less than
    the halo). The position is ``scale * o`` in fp32, as PyTorch's kernel
    computes it, so the weights are the frame's to the bit."""
    th, fh = ctx["th"], ctx["fh"]
    H = x.shape[2]
    s_in, s_out = th // H, th // Ho
    w0 = norms._win0(ctx["rank"], ctx)
    hin, hout = fh // s_in, fh // s_out
    scale = torch.tensor((hin - 1) / max(hout - 1, 1), dtype=torch.float32)
    o = torch.arange(Ho, dtype=torch.float32) + float(w0 // s_out)
    p = o * scale - float(w0 // s_in)
    p0 = p.floor().long().clamp(0, H - 2)
    w = (p - p0.float()).to(device=x.device, dtype=x.dtype)[None, None, :, None]
    p0 = p0.to(x.device)
    return x.index_select(2, p0) * (1 - w) + x.index_select(2, p0 + 1) * w


def interp_bilinear_align(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of NCHW ``x`` to (Ho, Wo)
    (core/update.py:93-95). Under exact banded eval
    (``nn/norms.py::cross_band_stats``) the rows are resized as the whole
    frame's would be (:func:`_interp_rows_banded`)."""
    H, W = x.shape[2:]
    Ho, Wo = out_hw
    if (Ho, Wo) == (H, W):
        return x
    ctx = norms._BAND
    if (ctx is not None and H != Ho and ctx["th"] % H == 0 and ctx["th"] % Ho == 0
            and ctx["fh"] % (ctx["th"] // H) == 0 and ctx["fh"] % (ctx["th"] // Ho) == 0):
        x = _interp_rows_banded(x, Ho, ctx)
        if Wo == W:
            return x
    return F.interpolate(x, size=(Ho, Wo), mode="bilinear", align_corners=True)


def interp_bilinear_halfpix(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear ``align_corners=False`` resize of NCHW ``x`` (torch's
    default)."""
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


def interp_trilinear_halfpix(x: torch.Tensor, out_dhw) -> torch.Tensor:
    """Trilinear ``align_corners=False`` resize of NCDHW ``x`` to (Do, Ho,
    Wo): GWCNet's cost upsample (gwc_main.py:248-263)."""
    if tuple(out_dhw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_dhw), mode="trilinear", align_corners=False)


def interp_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to (Ho, Wo): output row i reads input row
    ``floor(i * H / Ho)`` in integer arithmetic, as the JAX form does (torch's
    ``mode="nearest"`` computes the same index in floating point)."""
    H, W = x.shape[2:]
    Ho, Wo = out_hw
    rows = torch.arange(Ho, device=x.device) * H // Ho
    cols = torch.arange(Wo, device=x.device) * W // Wo
    return x.index_select(2, rows).index_select(3, cols)


def upflow(flow: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """``upflow8`` (core/utils/utils.py:83-85): an ``align_corners=True``
    bilinear resize of NCHW ``flow`` by ``factor``, its values scaled by
    ``factor``."""
    H, W = flow.shape[2:]
    return factor * interp_bilinear_align(flow, (factor * H, factor * W))


def avg_pool2d(x: torch.Tensor, window, stride, padding=(0, 0)) -> torch.Tensor:
    """torch average pool over NCHW, ``count_include_pad=True``."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool (core/update.py:87-88)."""
    return avg_pool2d(x, (3, 3), (2, 2), (1, 1))


def pool4x(x: torch.Tensor) -> torch.Tensor:
    """5x5 stride-4 pad-1 average pool (core/update.py:90-91)."""
    return avg_pool2d(x, (5, 5), (4, 4), (1, 1))
