"""Banded evaluation of very large frames (``dkt_stereo_tpu/eval/tiled.py``).

Stereo correlation is row-local, so a frame can be cut into horizontal
bands with a halo of context rows; a band is exact for the cost volume and
approximate only within the 2-D networks' reach of its edges.

  - :func:`banded_forward` runs the bands one after another on one device:
    the peak memory falls with the band count.
  - :func:`banded_forward_exact` runs one band a rank of a process group,
    with the instance norms' statistics summed over the bands and the halo
    rows exchanged between neighbours (``nn/norms.py``): the full frame's
    result up to fp noise.
  - :func:`banded_forward_mesh` runs one band a rank with no exchange.

Each takes (H, W, 3) images in [0, 255] (numpy arrays or tensors) and
returns the (H, W) disparity (negative flow-x) as a float32 numpy array.
The banded ones leave every rank with the whole frame (the ranks' interiors
summed into a zeroed frame by one all_reduce).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dkt_stereo_tpu_torch.nn.norms import cross_band_stats
from dkt_stereo_tpu_torch.ops.pad import pad_dims, pad_input, unpad_input


def _host(img) -> np.ndarray:
    return torch.as_tensor(img).detach().cpu().numpy().astype(np.float32, copy=False)


def banded_forward(forward, img1, img2, n_bands: int = 2, halo: int = 64,
                   divide_factor: int = 32) -> np.ndarray:
    """Bands one after another through ``forward`` (a
    ``eval/validate.py::make_forward_fn``: NHWC tensors on
    ``forward.device`` -> (B, h, w) disparity). Band ``b`` covers rows
    ``[b * ceil(H / n_bands), ...)`` plus ``halo`` rows above and below,
    clipped to the frame, and is padded to multiples of ``divide_factor``
    as the unbanded eval pads a frame. ``halo`` should cover the encoders'
    and the GRUs' reach (64 rows at the input ~ 16 at 1/4 resolution).
    Approximate: each band's instance norms see only that band."""
    if n_bands < 1:
        raise ValueError(f"n_bands must be at least 1, got {n_bands}")
    a, c = _host(img1), _host(img2)
    H, W, _ = a.shape
    band_h = -(-H // n_bands)
    out = np.zeros((H, W), np.float32)
    dev = forward.device
    for b in range(n_bands):
        y0 = b * band_h
        y1 = min(H, y0 + band_h)
        if y0 >= y1:
            break
        ys, ye = max(0, y0 - halo), min(H, y1 + halo)
        x1, spec = pad_input(torch.as_tensor(a[None, ys:ye], device=dev), divide_factor, "sintel")
        x2, _ = pad_input(torch.as_tensor(c[None, ys:ye], device=dev), divide_factor, "sintel")
        disp = unpad_input(forward(x1, x2)[..., None], spec)[0, ..., 0]
        out[y0:y1] = disp[y0 - ys:y1 - ys].cpu().numpy()
    return out


def _gather_rows(out: torch.Tensor, group) -> np.ndarray:
    """The ranks' rows, each written into its own zeroed copy of the frame,
    summed: every rank gets the whole frame."""
    dist.all_reduce(out, group=group)
    return out.cpu().numpy()


def banded_forward_exact(model, img1, img2, group=None, halo: int = 96,
                         divide_factor: int = 32) -> np.ndarray:
    """Exact banded eval: this rank runs band ``rank`` of the group's
    ``size`` bands through ``model`` (test mode, on this rank's device);
    every rank calls it with the same frame. The frame is padded as the
    unbanded eval pads it, then cut into bands of ``ceil(fh / size / 32) *
    32`` rows with ``halo`` rows each side, windows clamped to the frame
    (``win0 = clip(k * band_h - halo, 0, fh - th)``), so that the first and
    last band's edges are the image's. Under ``nn/norms.py::
    cross_band_stats`` every instance norm uses the global statistics of
    the bands' interiors and the encoders and GRU iterations exchange
    their halo rows, so the result equals the unbanded forward up to fp
    noise wherever each stretch of convolutions between two exchanges
    reaches less than the halo.

    ``model`` must not use the fused encoder (``pallas_encoder``), whose
    kernel computes its instance norm inside; ``halo`` and
    ``divide_factor`` must be multiples of 32, the coarsest context stride,
    or the windows would not align with it and the summed statistics would
    be wrong. A frame too small to band runs whole on every rank."""
    if getattr(getattr(model, "cfg", None), "pallas_encoder", False):
        raise ValueError("banded_forward_exact needs module-level instance norms "
                         "(pallas_encoder=False)")
    if halo <= 0 or halo % 32:
        raise ValueError(f"halo must be a positive multiple of 32, got {halo}")
    if divide_factor <= 0 or divide_factor % 32:
        raise ValueError(f"banded_forward_exact requires divide_factor % 32 == 0 (got "
                         f"{divide_factor}): band windows must align to the 1/32-scale "
                         "context stride for exact cross-band instance-norm statistics")
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    dev = next(model.parameters()).device
    a, c = _host(img1), _host(img2)
    H, W, _ = a.shape
    (pt, pb), (pl, pr) = pad_dims(H, W, divide_factor, "sintel")
    a = np.pad(a, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    c = np.pad(c, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
    fh, fw = a.shape[:2]

    band_h = -(-fh // (n * 32)) * 32
    th = band_h + 2 * halo
    if th >= fh:  # too small to band: every rank runs the frame, band 0 keeps it
        th = band_h = fh
        halo = 0
    w0 = min(max(rank * band_h - halo, 0), fh - th)
    x1 = torch.as_tensor(a[None, w0:w0 + th], device=dev)
    x2 = torch.as_tensor(c[None, w0:w0 + th], device=dev)
    with torch.inference_mode(), cross_band_stats(group, th, halo, band_h, fh, n):
        _, disp = model(x1, x2)

    out = torch.zeros((fh, fw), dtype=torch.float32, device=dev)
    off = rank * band_h - w0
    ilen = min(max(fh - rank * band_h, 0), band_h)
    if ilen > 0:
        out[rank * band_h:rank * band_h + ilen] = disp[0, off:off + ilen].float()
    return _gather_rows(out, group)[pt:pt + H, pl:pl + W]


def banded_forward_mesh(forward, img1, img2, group=None, halo: int = 64,
                        divide_factor: int = 32) -> np.ndarray:
    """One band a rank through ``forward`` with no exchange between bands
    (the JAX ``banded_forward_mesh``): equal bands of ``ceil(H / size)``
    rows with ``halo`` rows each side, the frame edge-padded to fit, each
    padded to multiples of ``divide_factor``. Approximate where instance
    norms or the networks' reach see across a band's edge."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    a, c = _host(img1), _host(img2)
    H, W, _ = a.shape
    band_h = -(-H // n)
    pads = ((halo, halo + band_h * n - H), (0, 0), (0, 0))
    a, c = np.pad(a, pads, mode="edge"), np.pad(c, pads, mode="edge")
    bh = band_h + 2 * halo
    dev = forward.device
    x1, spec = pad_input(torch.as_tensor(a[None, rank * band_h:rank * band_h + bh], device=dev),
                         divide_factor, "sintel")
    x2, _ = pad_input(torch.as_tensor(c[None, rank * band_h:rank * band_h + bh], device=dev),
                      divide_factor, "sintel")
    disp = unpad_input(forward(x1, x2)[..., None], spec)[0, ..., 0]

    out = torch.zeros((H, W), dtype=torch.float32, device=dev)
    y0 = rank * band_h
    y1 = min(H, y0 + band_h)
    if y1 > y0:
        out[y0:y1] = disp[halo:halo + y1 - y0].float()
    return _gather_rows(out, group)
