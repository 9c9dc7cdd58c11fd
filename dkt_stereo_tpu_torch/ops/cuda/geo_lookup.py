"""K4: IGEV's combined geometry-encoding volume lookup
(``csrc/geo_lookup.cu``), the port of the forward of the Pallas
``dkt_stereo_tpu/ops/pallas/geo_lookup.py::geo_lookup_pallas``.

:func:`geo_lookup` takes the plain path (:func:`geo_lookup_plain`, the same
function as ``ops/geometry.py::geo_lookup``) only for CPU tensors; for CUDA
tensors it launches the kernel or raises. The kernel has no backward yet:
on CUDA it refuses pyramids that require grad while grad mode is on, rather
than cut the graph.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup as geo_lookup_plain

MAX_LEVELS = 4
MAX_RADIUS = 8

__all__ = ["geo_lookup", "geo_lookup_plain"]


def _launcher():
    """``geo_lookup_launch``: four geo and four corr level pointers, four
    depths, four widths, levels, channels, disp, coords, out, pixels,
    radius, bf16 flag, stream."""
    fn = _build.load("geo_lookup").geo_lookup_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 10 + [p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(geo_pyr, corr_pyr, disp, coords, radius):
    """Validate the kernel's inputs; returns (lead (B, H, W), C, dtype)."""
    L = len(geo_pyr)
    if not 1 <= L <= MAX_LEVELS or len(corr_pyr) != L:
        raise ValueError(f"geo_lookup: 1..{MAX_LEVELS} levels, the same number of geo and "
                         f"corr levels; got {L} and {len(corr_pyr)}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"geo_lookup: radius 0..{MAX_RADIUS}, got {radius}")
    lead = tuple(disp.shape[:3])
    for name, t in (("disp", disp), ("coords", coords)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 4
                or tuple(t.shape) != (*lead, 1)):
            raise ValueError(f"geo_lookup: {name} must be a contiguous fp32 (B, H, W, 1) "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    dtype = geo_pyr[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"geo_lookup: pyramid dtype must be fp32 or bf16, got {dtype}")
    C = geo_pyr[0].shape[-1]
    for g, c in zip(geo_pyr, corr_pyr):
        if g.dtype != dtype or c.dtype != dtype:
            raise ValueError("geo_lookup: all levels of both pyramids must have one dtype")
        if (g.dim() != 5 or tuple(g.shape[:3]) != lead or g.shape[4] != C or g.shape[3] < 1
                or c.dim() != 4 or tuple(c.shape[:3]) != lead or c.shape[3] < 1):
            raise ValueError(f"geo_lookup: levels {tuple(g.shape)} / {tuple(c.shape)} do not "
                             f"match disp {lead}")
        for t in (g, c):
            if t.device != disp.device or not t.is_contiguous():
                raise ValueError("geo_lookup: levels must be contiguous, on disp's device")
    if coords.device != disp.device:
        raise ValueError("geo_lookup: coords must be on disp's device")
    return lead, C, dtype


def geo_lookup(geo_pyr, corr_pyr, disp: torch.Tensor, coords: torch.Tensor,
               radius: int = 4) -> torch.Tensor:
    """``geo_pyr``: per level (B, H, W, D_i, C); ``corr_pyr``: per level (B,
    H, W, W2_i), all levels fp32 or all bf16; ``disp``, ``coords``: (B, H,
    W, 1) fp32. Returns (B, H, W, L*(C+1)*(2r+1)) fp32: per level [geo
    C-major, taps fast | corr taps]."""
    geo_pyr, corr_pyr = list(geo_pyr), list(corr_pyr)
    if disp.device.type == "cpu":
        return geo_lookup_plain(geo_pyr, corr_pyr, disp, coords, radius)
    if disp.device.type != "cuda":
        raise ValueError(f"geo_lookup: unsupported device {disp.device}")
    _build.refuse_grad("geo_lookup", "Queue 2 K4 bwd", *geo_pyr, *corr_pyr)
    lead, C, dtype = _check(geo_pyr, corr_pyr, disp, coords, radius)
    L = len(geo_pyr)
    taps = 2 * radius + 1
    out = torch.empty((*lead, L * (C + 1) * taps), dtype=torch.float32, device=disp.device)
    pad = [None] * (MAX_LEVELS - L)
    zeros = [0] * (MAX_LEVELS - L)
    args = ([g.data_ptr() for g in geo_pyr] + pad + [c.data_ptr() for c in corr_pyr] + pad
            + [g.shape[3] for g in geo_pyr] + zeros + [c.shape[3] for c in corr_pyr] + zeros)
    fn = _launcher()
    with torch.cuda.device(disp.device):
        stream = torch.cuda.current_stream(disp.device).cuda_stream
        err = fn(*args, L, C, disp.data_ptr(), coords.data_ptr(), out.data_ptr(),
                 lead[0] * lead[1] * lead[2], radius, int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "geo_lookup")
    geo_lookup.launches += 1
    return out


geo_lookup.launches = 0
