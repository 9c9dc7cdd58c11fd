"""K4: IGEV's combined geometry-encoding volume lookup (``csrc/geo_lookup.cu``)
and its backward (``csrc/geo_lookup_bwd.cu``: the dgeo and the dcorr
kernel), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/geo_lookup.py::geo_lookup_pallas`` and its
custom VJP.

:func:`geo_lookup` takes the plain path (:func:`geo_lookup_plain`, the same
function as ``ops/geometry.py::geo_lookup``, differentiated by autograd)
only for CPU tensors, as the backward wrappers take
``ops/geometry.py::geo_lookup_bwd_plain``; for CUDA tensors it goes through :class:`GeoLookup`,
whose forward and backward launch the kernels or raise. The backward gives
each level of both pyramids its gradient in that level's dtype and no
gradient for disp and coords, which IGEV detaches every iteration (the JAX
VJP returns zeros there).
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup as geo_lookup_plain
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup_bwd_plain

MAX_LEVELS = 4
MAX_RADIUS = 8

__all__ = ["GeoLookup", "geo_lookup", "geo_lookup_bwd_corr", "geo_lookup_bwd_geo",
           "geo_lookup_bwd_plain", "geo_lookup_plain"]


def _launcher(name: str):
    """``geo_lookup_launch``: four geo and four corr level pointers, four
    depths, four widths, levels, channels, disp, coords, out, pixels,
    radius, bf16 flag, stream. ``geo_lookup_bwd_{geo,corr}_launch``: four
    output level pointers, four sizes, levels, channels, disp, coords, g,
    pixels, radius, bf16 flag, stream."""
    lib = "geo_lookup" if name == "geo_lookup" else "geo_lookup_bwd"
    fn = getattr(_build.load(lib), f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        pointers = 8 if name == "geo_lookup" else 4
        fn.argtypes = [p] * pointers + [i] * (pointers + 2) + [p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_points(disp, coords, levels, radius, name):
    """Validate disp and coords; returns the lead shape (B, H, W)."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius 0..{MAX_RADIUS}, got {radius}")
    lead = tuple(disp.shape[:3])
    for arg, t in (("disp", disp), ("coords", coords)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 4
                or tuple(t.shape) != (*lead, 1) or t.device != disp.device):
            raise ValueError(f"{name}: {arg} must be a contiguous fp32 (B, H, W, 1) tensor on "
                             f"disp's device, got {t.dtype} {tuple(t.shape)}")
    return lead


def _check_meta(geo_meta, corr_meta, lead, name):
    """Validate the levels' shapes and dtypes; returns (C, dtype)."""
    if len(corr_meta) != len(geo_meta):
        raise ValueError(f"{name}: the same number of geo and corr levels; got "
                         f"{len(geo_meta)} and {len(corr_meta)}")
    dtype = geo_meta[0][1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: pyramid dtype must be fp32 or bf16, got {dtype}")
    C = geo_meta[0][0][-1]
    for (gs, gdt), (cs, cdt) in zip(geo_meta, corr_meta):
        if gdt != dtype or cdt != dtype:
            raise ValueError(f"{name}: all levels of both pyramids must have one dtype")
        if (len(gs) != 5 or tuple(gs[:3]) != lead or gs[4] != C or gs[3] < 1
                or len(cs) != 4 or tuple(cs[:3]) != lead or cs[3] < 1):
            raise ValueError(f"{name}: levels {tuple(gs)} / {tuple(cs)} do not match disp {lead}")
    return C, dtype


def _launch_fwd(geo_pyr, corr_pyr, disp, coords, radius):
    L = len(geo_pyr)
    lead = _check_points(disp, coords, L, radius, "geo_lookup")
    C, dtype = _check_meta([(tuple(v.shape), v.dtype) for v in geo_pyr],
                           [(tuple(v.shape), v.dtype) for v in corr_pyr], lead, "geo_lookup")
    for t in (*geo_pyr, *corr_pyr):
        if t.device != disp.device or not t.is_contiguous():
            raise ValueError("geo_lookup: levels must be contiguous, on disp's device")
    taps = 2 * radius + 1
    out = torch.empty((*lead, L * (C + 1) * taps), dtype=torch.float32, device=disp.device)
    pad = [None] * (MAX_LEVELS - L)
    zeros = [0] * (MAX_LEVELS - L)
    args = ([g.data_ptr() for g in geo_pyr] + pad + [c.data_ptr() for c in corr_pyr] + pad
            + [g.shape[3] for g in geo_pyr] + zeros + [c.shape[3] for c in corr_pyr] + zeros)
    fn = _launcher("geo_lookup")
    with torch.cuda.device(disp.device):
        stream = torch.cuda.current_stream(disp.device).cuda_stream
        err = fn(*args, L, C, disp.data_ptr(), coords.data_ptr(), out.data_ptr(),
                 lead[0] * lead[1] * lead[2], radius, int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "geo_lookup")
    geo_lookup.launches += 1
    return out


def _launch_bwd(part, geo_meta, corr_meta, disp, coords, g, radius):
    """Launch ``geo_lookup_bwd_<part>`` (part "geo" or "corr"); returns one
    tensor per level, every element written by the kernel."""
    name = f"geo_lookup_bwd_{part}"
    L = len(geo_meta)
    lead = _check_points(disp, coords, L, radius, name)
    C, dtype = _check_meta(geo_meta, corr_meta, lead, name)
    width = L * (C + 1) * (2 * radius + 1)
    if (g.device != disp.device or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (*lead, width)):
        raise ValueError(f"{name}: g must be a contiguous fp32 {(*lead, width)} tensor on "
                         f"{disp.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    meta = geo_meta if part == "geo" else corr_meta
    outs = [torch.empty(s, dtype=dtype, device=g.device) for s, _ in meta]
    ptrs = [o.data_ptr() for o in outs] + [None] * (MAX_LEVELS - L)
    sizes = [s[3] for s, _ in meta] + [0] * (MAX_LEVELS - L)
    fn = _launcher(name)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(*ptrs, *sizes, L, C, disp.data_ptr(), coords.data_ptr(), g.data_ptr(),
                 lead[0] * lead[1] * lead[2], radius, int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, name)
    return outs


def _meta(shapes_dtypes):
    return [(tuple(s), dt) for s, dt in shapes_dtypes]


def geo_lookup_bwd_geo(geo_shapes_dtypes, corr_shapes_dtypes, disp: torch.Tensor,
                       coords: torch.Tensor, g: torch.Tensor, radius: int = 4):
    """d/dgeo of the lookup, one (B, H, W, D_i, C) tensor per level in the
    levels' dtype. ``g``: (B, H, W, L*(C+1)*(2r+1)) fp32. CPU tensors take
    :func:`geo_lookup_bwd_plain`; CUDA tensors launch the dgeo kernel or
    raise."""
    geo_meta, corr_meta = _meta(geo_shapes_dtypes), _meta(corr_shapes_dtypes)
    if disp.device.type == "cpu":
        return geo_lookup_bwd_plain(geo_meta, corr_meta, disp, coords, g, radius,
                                    need_corr=False)[0]
    if disp.device.type != "cuda":
        raise ValueError(f"geo_lookup_bwd_geo: unsupported device {disp.device}")
    outs = _launch_bwd("geo", geo_meta, corr_meta, disp, coords, g, radius)
    geo_lookup_bwd_geo.launches += 1
    return outs


def geo_lookup_bwd_corr(geo_shapes_dtypes, corr_shapes_dtypes, disp: torch.Tensor,
                        coords: torch.Tensor, g: torch.Tensor, radius: int = 4):
    """d/dcorr of the lookup, one (B, H, W, W2_i) tensor per level in the
    levels' dtype; as :func:`geo_lookup_bwd_geo`, with the dcorr kernel."""
    geo_meta, corr_meta = _meta(geo_shapes_dtypes), _meta(corr_shapes_dtypes)
    if disp.device.type == "cpu":
        return geo_lookup_bwd_plain(geo_meta, corr_meta, disp, coords, g, radius,
                                    need_geo=False)[1]
    if disp.device.type != "cuda":
        raise ValueError(f"geo_lookup_bwd_corr: unsupported device {disp.device}")
    outs = _launch_bwd("corr", geo_meta, corr_meta, disp, coords, g, radius)
    geo_lookup_bwd_corr.launches += 1
    return outs


class GeoLookup(torch.autograd.Function):
    """The lookup with its hand-written backward: ``apply(disp, coords,
    radius, levels, *geo_levels, *corr_levels)``. Only disp, coords and the
    levels' shapes and dtypes are saved, as the JAX residuals are
    (geo_lookup.py:308-312). CPU tensors run the plain versions of both
    directions."""

    @staticmethod
    def forward(ctx, disp, coords, radius, levels, *pyramids):
        geo_pyr, corr_pyr = pyramids[:levels], pyramids[levels:]
        ctx.radius, ctx.levels = radius, levels
        ctx.geo_meta = [(tuple(v.shape), v.dtype) for v in geo_pyr]
        ctx.corr_meta = [(tuple(v.shape), v.dtype) for v in corr_pyr]
        ctx.save_for_backward(disp, coords)
        if disp.device.type == "cpu":
            return geo_lookup_plain(geo_pyr, corr_pyr, disp, coords, radius)
        return _launch_fwd(geo_pyr, corr_pyr, disp, coords, radius)

    @staticmethod
    def backward(ctx, g):
        disp, coords = ctx.saved_tensors
        L = ctx.levels
        need = ctx.needs_input_grad[4:]
        # the model permutes the lookup's output, so autograd hands back a
        # strided gradient; the kernels read it densely
        g = g.contiguous()
        args = (ctx.geo_meta, ctx.corr_meta, disp, coords, g, ctx.radius)
        dgeo = geo_lookup_bwd_geo(*args) if any(need[:L]) else [None] * L
        dcorr = geo_lookup_bwd_corr(*args) if any(need[L:]) else [None] * L
        return (None, None, None, None, *dgeo, *dcorr)


def geo_lookup(geo_pyr, corr_pyr, disp: torch.Tensor, coords: torch.Tensor,
               radius: int = 4) -> torch.Tensor:
    """``geo_pyr``: per level (B, H, W, D_i, C); ``corr_pyr``: per level (B,
    H, W, W2_i), all levels fp32 or all bf16; ``disp``, ``coords``: (B, H,
    W, 1) fp32. Returns (B, H, W, L*(C+1)*(2r+1)) fp32: per level [geo
    C-major, taps fast | corr taps], differentiable with respect to the
    levels."""
    geo_pyr, corr_pyr = list(geo_pyr), list(corr_pyr)
    if disp.device.type == "cpu":
        return geo_lookup_plain(geo_pyr, corr_pyr, disp, coords, radius)
    if disp.device.type != "cuda":
        raise ValueError(f"geo_lookup: unsupported device {disp.device}")
    return GeoLookup.apply(disp, coords, radius, len(geo_pyr), *geo_pyr, *corr_pyr)


geo_lookup.launches = 0
geo_lookup_bwd_geo.launches = 0
geo_lookup_bwd_corr.launches = 0
