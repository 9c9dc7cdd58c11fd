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

Both directions take any number of levels up to :data:`MAX_LEVELS` (the
kernels' parameter blocks) and any radius whose staging fits a block's
shared memory: :func:`fwd_smem_bytes` (the forward's output staging, 256
threads of 2r+1 floats) and :func:`bwd_plan` (the backward's pixels a
block) raise past that limit. A NaN disparity gives zeros in every kernel,
where the plain twin and JAX give NaN.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup as geo_lookup_plain
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup_bwd_plain

MAX_LEVELS = 32  # kMaxLevels of the kernels' parameter blocks
MAX_SMEM = 232_448  # a block's shared memory on the H100
FWD_THREADS = 256
PIXELS_PER_BLOCK = (64, 32, 16, 8)

__all__ = ["GeoLookup", "bwd_plan", "fwd_smem_bytes", "geo_lookup", "geo_lookup_bwd_corr",
           "geo_lookup_bwd_geo", "geo_lookup_bwd_plain", "geo_lookup_plain"]


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def fwd_smem_bytes(levels: int, radius: int) -> int:
    """Shared memory of one forward block (``geo_lookup.cu::smem_bytes``): a
    24-byte entry a level, then every thread's 2r+1 outputs in fp32."""
    return levels * 24 + FWD_THREADS * (2 * radius + 1) * 4


def bwd_smem_bytes(levels: int, radius: int, channels: int, part: str, pixels: int,
                   max_size: int, out_itemsize: int) -> int:
    """Shared memory of one dgeo (``part`` "geo") or dcorr ("corr") block
    (``geo_lookup_bwd.cu::make_plan``): an int4 a (pixel, level), a slot a
    (pixel, level) for its g piece, C*(2r+1) or 2r+1 fp32 staged from
    anywhere in its first 16-byte chunk, then one level's output span of
    the tile (the widest level's: ``max_size`` D_i x C or W2_i values)."""
    taps = 2 * radius + 1
    geo = part == "geo"
    length = channels * taps if geo else taps
    items = pixels * levels
    stage = _round16(pixels * max_size * (channels if geo else 1) * out_itemsize)
    return items * 16 + items * (_round16(length * 4) + 16) + stage


def bwd_plan(levels: int, radius: int, channels: int, part: str, max_size: int,
             out_itemsize: int) -> tuple[int, int]:
    """(pixels a block, shared-memory bytes) of the dgeo or dcorr kernel:
    the widest block of which four fit an SM's shared memory, else the
    widest that fits at all, else ValueError naming the limit."""
    name = f"geo_lookup_bwd_{part}"
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels (the kernel's parameter block), got "
                         f"{levels}")
    if radius < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {radius}")

    def smem(p):
        return bwd_smem_bytes(levels, radius, channels, part, p, max_size, out_itemsize)

    for budget in (MAX_SMEM // 4, MAX_SMEM):
        for pixels in PIXELS_PER_BLOCK:
            if smem(pixels) <= budget:
                return pixels, smem(pixels)
    raise ValueError(f"{name}: {levels} levels at radius {radius}, {channels} channels and size "
                     f"{max_size} need {smem(8)} B of shared memory at 8 pixels a block, more "
                     f"than the {MAX_SMEM} B a block has")


def _launcher(name: str):
    """``geo_lookup_launch``: geo and corr level pointers, depths and widths
    (host arrays), levels, channels, disp, coords, out, pixels, radius, bf16
    flag, stream. ``geo_lookup_bwd_{geo,corr}_launch``: output level
    pointers and sizes (host arrays), levels, channels, disp, coords, g,
    pixels, radius, bf16 flag, pixels a block, stream."""
    lib = "geo_lookup" if name == "geo_lookup" else "geo_lookup_bwd"
    fn = getattr(_build.load(lib), f"{name}_launch")
    if fn.argtypes is None:
        p, i, pp, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), \
            ctypes.POINTER(ctypes.c_int)
        if name == "geo_lookup":
            fn.argtypes = [pp, pp, pi, pi, i, i, p, p, p, ctypes.c_longlong, i, i, p]
        else:
            fn.argtypes = [pp, pi, i, i, p, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _check_points(disp, coords, levels, radius, name):
    """Validate disp and coords; returns the lead shape (B, H, W)."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if radius < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {radius}")
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
    if fwd_smem_bytes(L, radius) > MAX_SMEM:
        raise ValueError(f"geo_lookup: radius {radius} needs {fwd_smem_bytes(L, radius)} B of "
                         f"shared memory a block, more than the {MAX_SMEM} B a block has")
    taps = 2 * radius + 1
    out = torch.empty((*lead, L * (C + 1) * taps), dtype=torch.float32, device=disp.device)
    fn = _launcher("geo_lookup")
    with torch.cuda.device(disp.device):
        stream = torch.cuda.current_stream(disp.device).cuda_stream
        err = fn(_array(ctypes.c_void_p, [g.data_ptr() for g in geo_pyr]),
                 _array(ctypes.c_void_p, [c.data_ptr() for c in corr_pyr]),
                 _array(ctypes.c_int, [g.shape[3] for g in geo_pyr]),
                 _array(ctypes.c_int, [c.shape[3] for c in corr_pyr]), L, C, disp.data_ptr(),
                 coords.data_ptr(), out.data_ptr(), lead[0] * lead[1] * lead[2], radius,
                 int(dtype == torch.bfloat16), stream)
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
    meta = geo_meta if part == "geo" else corr_meta
    pixels, _ = bwd_plan(L, radius, C, part, max(s[3] for s, _ in meta), dtype.itemsize)
    width = L * (C + 1) * (2 * radius + 1)
    if (g.device != disp.device or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (*lead, width)):
        raise ValueError(f"{name}: g must be a contiguous fp32 {(*lead, width)} tensor on "
                         f"{disp.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    outs = [torch.empty(s, dtype=dtype, device=g.device) for s, _ in meta]
    fn = _launcher(name)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(_array(ctypes.c_void_p, [o.data_ptr() for o in outs]),
                 _array(ctypes.c_int, [s[3] for s, _ in meta]), L, C, disp.data_ptr(),
                 coords.data_ptr(), g.data_ptr(), lead[0] * lead[1] * lead[2], radius,
                 int(dtype == torch.bfloat16), pixels, stream)
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
