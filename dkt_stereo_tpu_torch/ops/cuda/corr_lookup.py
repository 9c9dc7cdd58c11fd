"""K1: the correlation-pyramid lookup kernel (``csrc/corr_lookup.cu``) and
its backward (``csrc/corr_lookup_bwd.cu``), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/corr_lookup.py::corr_lookup_pallas`` and its
custom VJP.

:func:`corr_lookup` takes the plain path (:func:`corr_lookup_plain`, the
same function as ``ops/corr.py::corr_lookup``, differentiated by autograd)
only for CPU tensors; for CUDA tensors it goes through :class:`CorrLookup`,
whose forward and backward launch the kernels or raise. The backward gives
each level its d/dvolume in that level's dtype and no gradient for the
coordinates, which RAFT detaches every iteration (the JAX VJP returns zeros
there).
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.corr import corr_lookup as corr_lookup_plain
from dkt_stereo_tpu_torch.ops.cuda import _build

MAX_LEVELS = 4
MAX_RADIUS = 8

__all__ = ["CorrLookup", "corr_lookup", "corr_lookup_bwd", "corr_lookup_bwd_plain",
           "corr_lookup_plain"]


def corr_lookup_bwd_plain(shapes_dtypes, coords_x: torch.Tensor, g: torch.Tensor,
                          radius: int = 4) -> list[torch.Tensor]:
    """Plain version of the backward: the dense transposed weighting of the
    Pallas ``_bwd_kernel`` (corr_lookup.py:63-78). For level i and tap k the
    weight of volume column j is ``relu(1 - |j - (x/2^i + k - r)|)``;
    d/dvol_i is the sum over taps of that weight times g's tap. Accumulates
    in fp32 and returns each level in its own dtype.

    ``shapes_dtypes``: one ``(shape, dtype)`` per level, shape (B, H, W1,
    W2_i); ``coords_x``: (B, H, W1, 1); ``g``: (B, H, W1, L*(2r+1))."""
    taps = 2 * radius + 1
    g = g.float()
    x = coords_x.float()
    out = []
    for i, (shape, dtype) in enumerate(shapes_dtypes):
        j = torch.arange(shape[-1], dtype=torch.float32, device=g.device)
        xi = x / (2**i)
        acc = torch.zeros(shape, dtype=torch.float32, device=g.device)
        for k in range(taps):
            w = (1.0 - (j - (xi + (k - radius))).abs()).clamp_min(0.0)
            acc = acc + g[..., i * taps + k : i * taps + k + 1] * w
        out.append(acc.to(dtype))
    return out


def _launcher(name: str):
    """``<name>_launch`` of ``csrc/<name>.cu``; the forward and the backward
    take the same arguments: four level pointers, four widths, the level
    count, coords, the dense fp32 tensor (out or g), pixels, radius, bf16
    flag, stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_coords(coords_x: torch.Tensor, levels: int, radius: int, name: str):
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius 0..{MAX_RADIUS}, got {radius}")
    if coords_x.dtype != torch.float32 or not coords_x.is_contiguous():
        raise ValueError(f"{name}: coords_x must be contiguous fp32")
    if coords_x.dim() != 4 or coords_x.shape[-1] != 1:
        raise ValueError(f"{name}: coords_x must be (B, H, W1, 1), got {tuple(coords_x.shape)}")
    return tuple(coords_x.shape[:3])


def _check_levels(shapes_dtypes, lead, name: str):
    dtype = shapes_dtypes[0][1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: pyramid dtype must be fp32 or bf16, got {dtype}")
    for shape, dt in shapes_dtypes:
        if dt != dtype:
            raise ValueError(f"{name}: all levels must have one dtype")
        if len(shape) != 4 or tuple(shape[:3]) != lead or shape[3] < 1:
            raise ValueError(f"{name}: level shape {tuple(shape)} does not match coords {lead}")
    return dtype


def _launch_fwd(pyramid, coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    L = len(pyramid)
    lead = _check_coords(coords_x, L, radius, "corr_lookup")
    dtype = _check_levels([(tuple(v.shape), v.dtype) for v in pyramid], lead, "corr_lookup")
    for v in pyramid:
        if v.device != coords_x.device or not v.is_contiguous():
            raise ValueError("corr_lookup: levels must be contiguous, on the coords' device")

    taps = 2 * radius + 1
    out = torch.empty((*lead, L * taps), dtype=torch.float32, device=coords_x.device)
    npix = lead[0] * lead[1] * lead[2]
    ptrs = [v.data_ptr() for v in pyramid] + [None] * (MAX_LEVELS - L)
    widths = [v.shape[3] for v in pyramid] + [0] * (MAX_LEVELS - L)
    fn = _launcher("corr_lookup")
    with torch.cuda.device(coords_x.device):
        stream = torch.cuda.current_stream(coords_x.device).cuda_stream
        err = fn(*ptrs, *widths, L, coords_x.data_ptr(), out.data_ptr(), npix, radius,
                 int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "corr_lookup")
    corr_lookup.launches += 1
    return out


def corr_lookup_bwd(shapes_dtypes, coords_x: torch.Tensor, g: torch.Tensor,
                    radius: int = 4) -> list[torch.Tensor]:
    """d/dvolume of the lookup, one tensor per level in that level's dtype.
    ``g``: (B, H, W1, L*(2r+1)) fp32. CPU tensors take
    :func:`corr_lookup_bwd_plain`; CUDA tensors launch the kernel or raise."""
    shapes_dtypes = [(tuple(s), dt) for s, dt in shapes_dtypes]
    if coords_x.device.type == "cpu":
        return corr_lookup_bwd_plain(shapes_dtypes, coords_x, g, radius)
    if coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup_bwd: unsupported device {coords_x.device}")
    L = len(shapes_dtypes)
    lead = _check_coords(coords_x, L, radius, "corr_lookup_bwd")
    dtype = _check_levels(shapes_dtypes, lead, "corr_lookup_bwd")
    taps = 2 * radius + 1
    if (g.device != coords_x.device or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (*lead, L * taps)):
        raise ValueError(f"corr_lookup_bwd: g must be a contiguous fp32 {(*lead, L * taps)} "
                         f"tensor on {coords_x.device}, got {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}")

    dvols = [torch.empty(s, dtype=dtype, device=g.device) for s, _ in shapes_dtypes]
    npix = lead[0] * lead[1] * lead[2]
    ptrs = [d.data_ptr() for d in dvols] + [None] * (MAX_LEVELS - L)
    widths = [d.shape[3] for d in dvols] + [0] * (MAX_LEVELS - L)
    fn = _launcher("corr_lookup_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(*ptrs, *widths, L, coords_x.data_ptr(), g.data_ptr(), npix, radius,
                 int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "corr_lookup_bwd")
    corr_lookup_bwd.launches += 1
    return dvols


class CorrLookup(torch.autograd.Function):
    """The lookup with its hand-written backward: ``apply(coords_x, radius,
    *levels)``. CPU tensors run the plain versions of both directions."""

    @staticmethod
    def forward(ctx, coords_x, radius, *pyramid):
        ctx.radius = radius
        ctx.shapes_dtypes = [(tuple(v.shape), v.dtype) for v in pyramid]
        ctx.save_for_backward(coords_x)
        if coords_x.device.type == "cpu":
            return corr_lookup_plain(pyramid, coords_x, radius)
        return _launch_fwd(pyramid, coords_x, radius)

    @staticmethod
    def backward(ctx, g):
        (coords_x,) = ctx.saved_tensors
        # the model permutes the lookup's output, so autograd hands back a
        # strided gradient; the kernel reads it densely
        dvols = corr_lookup_bwd(ctx.shapes_dtypes, coords_x, g.contiguous(), ctx.radius)
        return (None, None, *dvols)


def corr_lookup(pyramid, coords_x: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """``pyramid``: sequence of (B, H, W1, W2_i) levels, all fp32 or all bf16;
    ``coords_x``: (B, H, W1, 1) fp32. Returns (B, H, W1, L*(2r+1)) fp32,
    differentiable with respect to the levels."""
    pyramid = list(pyramid)
    if coords_x.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords_x, radius)
    if coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {coords_x.device}")
    return CorrLookup.apply(coords_x, radius, *pyramid)


corr_lookup.launches = 0
corr_lookup_bwd.launches = 0
