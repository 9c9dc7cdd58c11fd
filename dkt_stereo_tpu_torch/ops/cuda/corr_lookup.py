"""K1: the correlation-pyramid lookup kernel (``csrc/corr_lookup.cu``), the
port of the Pallas ``dkt_stereo_tpu/ops/pallas/corr_lookup.py::
corr_lookup_pallas``.

:func:`corr_lookup` takes the plain path (:func:`corr_lookup_plain`, the
same function as ``ops/corr.py::corr_lookup``) only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.corr import corr_lookup as corr_lookup_plain
from dkt_stereo_tpu_torch.ops.cuda import _build

MAX_LEVELS = 4
MAX_RADIUS = 8

__all__ = ["corr_lookup", "corr_lookup_plain"]


def _lib():
    lib = _build.load("corr_lookup")
    fn = lib.corr_lookup_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def corr_lookup(pyramid, coords_x: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """``pyramid``: sequence of (B, H, W1, W2_i) levels, all fp32 or all bf16;
    ``coords_x``: (B, H, W1, 1) fp32. Returns (B, H, W1, L*(2r+1)) fp32."""
    pyramid = list(pyramid)
    if coords_x.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords_x, radius)
    if coords_x.device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {coords_x.device}")

    L = len(pyramid)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"corr_lookup: 1..{MAX_LEVELS} levels, got {L}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"corr_lookup: radius 0..{MAX_RADIUS}, got {radius}")
    if coords_x.dtype != torch.float32 or not coords_x.is_contiguous():
        raise ValueError("corr_lookup: coords_x must be contiguous fp32")
    if coords_x.dim() != 4 or coords_x.shape[-1] != 1:
        raise ValueError(f"corr_lookup: coords_x must be (B, H, W1, 1), got {tuple(coords_x.shape)}")
    lead = tuple(coords_x.shape[:3])
    dtype = pyramid[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"corr_lookup: pyramid dtype must be fp32 or bf16, got {dtype}")
    for v in pyramid:
        if v.device != coords_x.device or v.dtype != dtype or not v.is_contiguous():
            raise ValueError("corr_lookup: levels must be contiguous, of one dtype, on the coords' device")
        if v.dim() != 4 or tuple(v.shape[:3]) != lead or v.shape[3] < 1:
            raise ValueError(f"corr_lookup: level shape {tuple(v.shape)} does not match coords {lead}")

    taps = 2 * radius + 1
    out = torch.empty((*lead, L * taps), dtype=torch.float32, device=coords_x.device)
    npix = lead[0] * lead[1] * lead[2]
    ptrs = [v.data_ptr() for v in pyramid] + [None] * (MAX_LEVELS - L)
    widths = [v.shape[3] for v in pyramid] + [0] * (MAX_LEVELS - L)
    fn = _lib()
    with torch.cuda.device(coords_x.device):
        stream = torch.cuda.current_stream(coords_x.device).cuda_stream
        err = fn(*ptrs, *widths, L, coords_x.data_ptr(), out.data_ptr(), npix, radius,
                 int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "corr_lookup")
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0
