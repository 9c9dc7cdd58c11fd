"""K1: the correlation-pyramid lookup kernel (``csrc/corr_lookup.cu``) and
its backward (``csrc/corr_lookup_bwd.cu``), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/corr_lookup.py::corr_lookup_pallas`` and its
custom VJP.

:func:`corr_lookup` returns what RAFT's motion encoder reads: the lookup of
``ops/corr.py::corr_lookup`` (NHWC fp32, the JAX signature) permuted to
NCHW and cast once to the compute dtype, ``plain.permute(0, 3, 1,
2).to(dtype)``. In memory that is a dense (B, H, W1, L*(2r+1)) tensor, so
the NCHW view has the strides that ``.to`` gives it. CPU tensors take that
plain path (differentiated by autograd); CUDA tensors go through
:class:`CorrLookup`, whose forward kernel writes the tensor in ``dtype``
itself and whose backward kernel reads the gradient in ``dtype``: no cast
before or after the kernels. The backward gives each level its d/dvolume in
that level's dtype and no gradient for the coordinates, which RAFT detaches
every iteration (the JAX VJP returns zeros there).

Any number of levels up to :data:`MAX_LEVELS` (the kernels' parameter
block) and any radius whose per-block staging fits a block's shared memory:
:func:`fwd_plan` and :func:`bwd_plan` pick the pixels a block owns and
raise past that limit.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.corr import corr_lookup as corr_lookup_plain
from dkt_stereo_tpu_torch.ops.cuda import _build

MAX_LEVELS = 32  # kMaxLevels of both kernels' parameter blocks
MAX_SMEM = 232_448  # a block's shared memory on the H100
MAX_WIDTH = 1 << 22  # fp32 positions stay exact to well below a column
PIXELS_PER_BLOCK = (64, 32, 16, 8)  # multiples of 8: 16-byte aligned spans

__all__ = ["CorrLookup", "bwd_plan", "corr_lookup", "corr_lookup_bwd", "corr_lookup_bwd_plain",
           "corr_lookup_plain", "fold_vmap", "fwd_plan"]


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def fwd_smem_bytes(levels: int, radius: int, vol_itemsize: int, out_itemsize: int,
                   pixels: int) -> int:
    """Shared memory of one forward block (``corr_lookup.cu::make_plan``):
    per (level, pixel) item an int4 of metadata and a slot for its window
    of at most 2r+3 values starting anywhere in its first 16-byte chunk,
    then the block's output span."""
    taps = 2 * radius + 1
    items = pixels * levels
    slot = _round16(16 - vol_itemsize + (taps + 2) * vol_itemsize)
    return items * 16 + items * slot + _round16(items * taps * out_itemsize)


def bwd_smem_bytes(levels: int, radius: int, pixels: int) -> int:
    """Shared memory of one backward block (``corr_lookup_bwd.cu::make_plan``):
    the block's g in fp32, each item's window of 2r+3 floats and an int2."""
    taps = 2 * radius + 1
    items = pixels * levels
    return _round16(items * taps * 4) + _round16(items * (taps + 2) * 4) + items * 8


def _plan(smem, name: str, levels: int, radius: int) -> tuple[int, int]:
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels (the kernel's parameter block), "
                         f"got {levels}")
    if radius < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {radius}")
    for pixels in PIXELS_PER_BLOCK:
        if smem(pixels) <= MAX_SMEM:
            return pixels, smem(pixels)
    raise ValueError(f"{name}: {levels} levels at radius {radius} need {smem(8)} B of shared "
                     f"memory at 8 pixels a block, more than the {MAX_SMEM} B a block has")


def fwd_plan(levels: int, radius: int, vol_itemsize: int, out_itemsize: int) -> tuple[int, int]:
    """(pixels a block, shared-memory bytes) of the forward kernel: the
    widest block whose staging fits, or ValueError naming the limit."""
    return _plan(lambda p: fwd_smem_bytes(levels, radius, vol_itemsize, out_itemsize, p),
                 "corr_lookup", levels, radius)


def bwd_plan(levels: int, radius: int) -> tuple[int, int]:
    """(pixels a block, shared-memory bytes) of the backward kernel."""
    return _plan(lambda p: bwd_smem_bytes(levels, radius, p), "corr_lookup_bwd", levels, radius)


def corr_lookup_bwd_plain(shapes_dtypes, coords_x: torch.Tensor, g: torch.Tensor,
                          radius: int = 4) -> list[torch.Tensor]:
    """Plain version of the backward: the dense transposed weighting of the
    Pallas ``_bwd_kernel`` (corr_lookup.py:63-78). For level i and tap k the
    weight of volume column j is ``relu(1 - |j - (x/2^i + k - r)|)``;
    d/dvol_i is the sum over taps of that weight times g's tap. Accumulates
    in fp32 and returns each level in its own dtype. A NaN coordinate gives
    a NaN row, as in JAX.

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
    """``<name>_launch`` of ``csrc/<name>.cu``. Both take: level pointers and
    widths (host arrays), the level count, coords, the dense tensor (out,
    or g), pixels, radius, two bf16 flags, pixels a block, stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(p), ctypes.POINTER(i), i, p, p, ctypes.c_longlong, i, i, i,
                       i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_coords(coords_x: torch.Tensor, name: str):
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
        if len(shape) != 4 or tuple(shape[:3]) != lead or not 1 <= shape[3] < MAX_WIDTH:
            raise ValueError(f"{name}: level shape {tuple(shape)} does not match coords {lead} "
                             f"(widths 1..{MAX_WIDTH - 1})")
    return dtype


def _check_dtype(dtype, name: str):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the lookup's dtype must be fp32 or bf16, got {dtype}")


def _arrays(tensors):
    """Host arrays of the levels' pointers and widths for the launchers."""
    n = len(tensors)
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors]),
            (ctypes.c_int * n)(*[t.shape[3] for t in tensors]))


def _launch_fwd(pyramid, coords_x: torch.Tensor, radius: int, dtype) -> torch.Tensor:
    """The kernel's dense (B, H, W1, L*(2r+1)) output in ``dtype``."""
    L = len(pyramid)
    _check_dtype(dtype, "corr_lookup")
    lead = _check_coords(coords_x, "corr_lookup")
    vdt = _check_levels([(tuple(v.shape), v.dtype) for v in pyramid], lead, "corr_lookup")
    for v in pyramid:
        if v.device != coords_x.device or not v.is_contiguous():
            raise ValueError("corr_lookup: levels must be contiguous, on the coords' device")
    pixels, _ = fwd_plan(L, radius, vdt.itemsize, dtype.itemsize)

    out = torch.empty((*lead, L * (2 * radius + 1)), dtype=dtype, device=coords_x.device)
    npix = lead[0] * lead[1] * lead[2]
    ptrs, widths = _arrays(pyramid)
    fn = _launcher("corr_lookup")
    with torch.cuda.device(coords_x.device):
        stream = torch.cuda.current_stream(coords_x.device).cuda_stream
        err = fn(ptrs, widths, L, coords_x.data_ptr(), out.data_ptr(), npix, radius,
                 int(vdt == torch.bfloat16), int(dtype == torch.bfloat16), pixels, stream)
    _build.check_launch(err, "corr_lookup")
    corr_lookup.launches += 1
    return out


def corr_lookup_bwd(shapes_dtypes, coords_x: torch.Tensor, g: torch.Tensor,
                    radius: int = 4) -> list[torch.Tensor]:
    """d/dvolume of the lookup, one tensor per level in that level's dtype.
    ``g``: dense (B, H, W1, L*(2r+1)), fp32 or bf16 (the forward output's
    dtype). CPU tensors take :func:`corr_lookup_bwd_plain`; CUDA tensors
    launch the kernel or raise."""
    shapes_dtypes = [(tuple(s), dt) for s, dt in shapes_dtypes]
    if coords_x.device.type == "cpu":
        return corr_lookup_bwd_plain(shapes_dtypes, coords_x, g, radius)
    if coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup_bwd: unsupported device {coords_x.device}")
    L = len(shapes_dtypes)
    lead = _check_coords(coords_x, "corr_lookup_bwd")
    dtype = _check_levels(shapes_dtypes, lead, "corr_lookup_bwd")
    pixels, _ = bwd_plan(L, radius)
    taps = 2 * radius + 1
    if (g.device != coords_x.device or g.dtype not in (torch.float32, torch.bfloat16)
            or not g.is_contiguous() or tuple(g.shape) != (*lead, L * taps)):
        raise ValueError(f"corr_lookup_bwd: g must be a contiguous fp32 or bf16 "
                         f"{(*lead, L * taps)} tensor on {coords_x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")

    dvols = [torch.empty(s, dtype=dtype, device=g.device) for s, _ in shapes_dtypes]
    npix = lead[0] * lead[1] * lead[2]
    ptrs, widths = _arrays(dvols)
    fn = _launcher("corr_lookup_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(ptrs, widths, L, coords_x.data_ptr(), g.data_ptr(), npix, radius,
                 int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16), pixels, stream)
    _build.check_launch(err, "corr_lookup_bwd")
    corr_lookup_bwd.launches += 1
    return dvols


def fold_vmap(apply, info, in_dims, *args):
    """The batching rule of the kernels' autograd Functions under
    ``torch.func.vmap``: every tensor argument's mapped axis (broadcast
    where it has none) moved to the front and merged into its batch axis,
    one ``apply`` of the T*B images, and the output's first axis split back
    into (T, B), mapped at 0."""
    n = info.batch_size

    def fold(x, bdim):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.unsqueeze(0).expand(n, *x.shape) if bdim is None else x.movedim(bdim, 0)
        return x.flatten(0, 1).contiguous()

    return apply(*(fold(a, d) for a, d in zip(args, in_dims))).unflatten(0, (n, -1)), 0


class CorrLookup(torch.autograd.Function):
    """The lookup with its hand-written backward: ``apply(coords_x, radius,
    dtype, *levels)`` returns the (B, L*(2r+1), H, W1) view in ``dtype``.
    CPU tensors run the plain versions of both directions.

    Under ``torch.func.vmap`` the mapped axis is folded into the batch axis
    (:meth:`vmap`), so that one launch serves every slot: the DKT step's
    two teachers, stacked, take one launch an iteration."""

    @staticmethod
    def forward(coords_x, radius, dtype, *pyramid):
        if coords_x.device.type == "cpu":
            return corr_lookup_plain(pyramid, coords_x, radius).permute(0, 3, 1, 2).to(dtype)
        return _launch_fwd(pyramid, coords_x, radius, dtype).permute(0, 3, 1, 2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coords_x, radius, _, *pyramid = inputs
        ctx.radius = radius
        ctx.shapes_dtypes = [(tuple(v.shape), v.dtype) for v in pyramid]
        ctx.save_for_backward(coords_x)

    @staticmethod
    def backward(ctx, g):
        (coords_x,) = ctx.saved_tensors
        # the kernel reads g densely as (B, H, W1, C); a channels-last
        # gradient (what cuDNN's convolution hands back for the channels-last
        # input) is that already, any other layout costs one counted copy
        g = g.permute(0, 2, 3, 1)
        if not g.is_contiguous():
            g = g.contiguous()
            corr_lookup_bwd.g_copies += 1
        dvols = corr_lookup_bwd(ctx.shapes_dtypes, coords_x, g, ctx.radius)
        return (None, None, None, *dvols)

    @staticmethod
    def vmap(info, in_dims, *args):
        return fold_vmap(CorrLookup.apply, info, in_dims, *args)


def corr_lookup(pyramid, coords_x: torch.Tensor, radius: int = 4,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``pyramid``: sequence of (B, H, W1, W2_i) levels, all fp32 or all bf16;
    ``coords_x``: (B, H, W1, 1) fp32. Returns the motion encoder's input,
    (B, L*(2r+1), H, W1) in ``dtype`` (fp32 or bf16), a view of a dense
    (B, H, W1, L*(2r+1)) tensor: ``ops/corr.py::corr_lookup(...).permute(0,
    3, 1, 2).to(dtype)``. Differentiable with respect to the levels.
    Batches under ``torch.func.vmap`` by folding the mapped axis into B,
    on the CPU (without gradients) as on the card."""
    pyramid = list(pyramid)
    if coords_x.device.type == "cpu":
        _check_dtype(dtype, "corr_lookup")
        if torch.is_grad_enabled() and any(v.requires_grad for v in pyramid):
            # differentiated by autograd through the plain ops
            return corr_lookup_plain(pyramid, coords_x, radius).permute(0, 3, 1, 2).to(dtype)
    elif coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {coords_x.device}")
    return CorrLookup.apply(coords_x, radius, dtype, *pyramid)


corr_lookup.launches = 0
corr_lookup_bwd.launches = 0
corr_lookup_bwd.g_copies = 0  # strided gradients copied to dense before the kernel
