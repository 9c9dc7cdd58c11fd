"""K3: the correlation lookup without a volume (``csrc/corr_alt.cu``), the
port of the Pallas ``dkt_stereo_tpu/ops/pallas/corr_alt.py::
corr_lookup_alt_pallas``.

:func:`corr_lookup_alt` takes the plain path (:func:`corr_lookup_alt_plain`,
the same function as ``ops/corr.py::corr_lookup_alt``, differentiated by
autograd) only for CPU tensors; for CUDA tensors it goes through
:class:`CorrLookupAlt`, whose forward launches the kernel or raises.

The backward is the JAX package's VJP (``corr_alt.py:177-193``): it
differentiates a recompute of the plain lookup on the saved fmap1 and
levels, and gives no gradient for the coordinates, which RAFT detaches
every iteration. The JAX package has no backward kernel here (its backward
is XLA), so neither has the port: the recompute is plain PyTorch on the
card. It gathers (B, H, W1, 2r+1, D) fp32 taps twice a level, about 1 GB
each at the DKT crop's 8 x 80 x 180 grid with D = 256, once per iteration
under remat: the JAX package's choice (training rarely runs memory-starved,
``corr_alt.py:23-26``), and it fits an 80 GB card.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.corr import corr_lookup_alt as corr_lookup_alt_plain
from dkt_stereo_tpu_torch.ops.cuda import _build

MAX_LEVELS = 8
MAX_DIM = 512
# csrc/corr_alt.cu's shared-memory plan (make_plan), mirrored so that the
# argument checks run without the library
_BUFS, _MAX_PIECE, _PIECE_BYTES, _MAX_SMEM = 2, 48, 24576, 232448

__all__ = ["CorrLookupAlt", "check_args", "corr_lookup_alt", "corr_lookup_alt_plain",
           "smem_bytes"]


def smem_bytes(dim: int, bf16: bool, radius: int) -> int:
    """Dynamic shared memory of one K3 block: the fmap1 tile of its pixels
    (96 in bf16, 64 in fp32) and a ring of band pieces, in slabs of 128
    bytes of channels, and the (pixel, column) product table."""
    pixels = 96 if bf16 else 64
    slabs = -(-dim // (64 if bf16 else 32))
    nc = min(_MAX_PIECE, max(16, _PIECE_BYTES // (slabs * 128) // 16 * 16))
    head = 256 + 4 * pixels + 4 * pixels * (2 * radius + 2)
    return head + 1024 + (pixels + _BUFS * nc) * slabs * 128


def check_args(fmap1: torch.Tensor, levels, coords_x: torch.Tensor, radius: int) -> None:
    """Raise unless the kernel takes these arguments. Reads only shapes,
    dtypes, devices, strides and addresses, so it runs on ``meta``
    tensors."""
    name = "corr_lookup_alt"
    L = len(levels)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {L}")
    if fmap1.dim() != 4:
        raise ValueError(f"{name}: fmap1 must be (B, H, W1, D), got {tuple(fmap1.shape)}")
    B, H, W1, D = fmap1.shape
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"{name}: D must be in [1, {MAX_DIM}], got {D}")
    if fmap1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: fmap1 must be fp32 or bf16, got {fmap1.dtype}")
    if radius < 0:
        raise ValueError(f"{name}: radius must be >= 0, got {radius}")
    need = smem_bytes(D, fmap1.dtype == torch.bfloat16, radius)
    if need > _MAX_SMEM:
        raise ValueError(f"{name}: radius {radius} at D {D} {fmap1.dtype} needs {need} bytes of "
                         f"shared memory a block, more than {_MAX_SMEM}")
    dev = fmap1.device
    if (coords_x.device != dev or coords_x.dtype != torch.float32
            or tuple(coords_x.shape) != (B, H, W1, 1) or not coords_x.is_contiguous()):
        raise ValueError(f"{name}: coords_x must be a contiguous fp32 {(B, H, W1, 1)} tensor on "
                         f"{dev}, got {coords_x.dtype} {tuple(coords_x.shape)} on "
                         f"{coords_x.device}")
    for t in (fmap1, *levels):
        if t.device != dev or t.dtype != fmap1.dtype:
            raise ValueError(f"{name}: fmap1 and every level must be {fmap1.dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: fmap1 and the levels must be contiguous and 16-byte "
                             "aligned")
    for v in levels:
        if v.dim() != 4 or tuple(v.shape[:2]) != (B, H) or v.shape[3] != D or v.shape[2] < 1:
            raise ValueError(f"{name}: level shape {tuple(v.shape)} does not match fmap1 "
                             f"{tuple(fmap1.shape)}")


def _launcher():
    fn = _build.load("corr_alt").corr_alt_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(fmap1: torch.Tensor, levels, coords_x: torch.Tensor, radius: int) -> torch.Tensor:
    check_args(fmap1, levels, coords_x, radius)
    B, H, W1, D = fmap1.shape
    L = len(levels)
    taps = 2 * radius + 1
    dev = fmap1.device
    out = torch.empty((B, H, W1, L * taps), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * L)(*[v.data_ptr() for v in levels])
    widths = (ctypes.c_int * L)(*[v.shape[2] for v in levels])
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptrs, widths, L, fmap1.data_ptr(), coords_x.data_ptr(), out.data_ptr(),
                 B * H, W1, D, radius, int(fmap1.dtype == torch.bfloat16), stream)
    _build.check_launch(err, "corr_lookup_alt")
    corr_lookup_alt.launches += 1
    return out


class CorrLookupAlt(torch.autograd.Function):
    """The lookup with the JAX package's recompute VJP: ``apply(fmap1,
    coords_x, radius, *levels)``. CPU tensors run the plain forward."""

    @staticmethod
    def forward(ctx, fmap1, coords_x, radius, *levels):
        ctx.radius = radius
        ctx.save_for_backward(fmap1, coords_x, *levels)
        if coords_x.device.type == "cpu":
            return corr_lookup_alt_plain(fmap1, levels, coords_x, radius)
        return _launch(fmap1, levels, coords_x, radius)

    @staticmethod
    def backward(ctx, g):
        fmap1, coords_x, *levels = ctx.saved_tensors
        needs = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n) for t, n in zip([fmap1, *levels],
                                                               [needs[0], *needs[3:]])]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), torch.autocast(g.device.type, enabled=False):
            out = corr_lookup_alt_plain(inputs[0], inputs[1:], coords_x, ctx.radius)
            grads = iter(torch.autograd.grad(out, wanted, g))
        d = [next(grads) if t.requires_grad else None for t in inputs]
        return (d[0], None, None, *d[1:])


def corr_lookup_alt(fmap1: torch.Tensor, f2_pyramid, coords_x: torch.Tensor,
                    radius: int = 4) -> torch.Tensor:
    """``fmap1``: (B, H, W1, D); ``f2_pyramid``: sequence of pooled right
    features (B, H, W2_i, D), the same dtype as fmap1 (fp32 or bf16);
    ``coords_x``: (B, H, W1, 1) fp32. Returns (B, H, W1, L*(2r+1)) fp32,
    differentiable with respect to fmap1 and the levels."""
    levels = list(f2_pyramid)
    if coords_x.device.type == "cpu":
        return corr_lookup_alt_plain(fmap1, levels, coords_x, radius)
    if coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup_alt: unsupported device {coords_x.device}")
    return CorrLookupAlt.apply(fmap1, coords_x, radius, *levels)


corr_lookup_alt.launches = 0
