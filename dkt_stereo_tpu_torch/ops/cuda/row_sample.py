"""K5: PCVNet's Gaussian row sampling over every pyramid level in one
launch (``csrc/row_sample.cu``), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/row_sample.py::row_sample_pallas`` (forward).

:func:`gaussian_row_sample` takes the plain path
(:func:`gaussian_row_sample_plain`, ``sample_row_1d`` per level, the same
function as JAX ``nn/pcv.py::gaussian_corr_lookup``) only for CPU tensors;
for CUDA tensors it launches the kernel or raises. The kernel has no
backward yet: on CUDA it refuses inputs that require grad while grad mode is
on, rather than cut the graph (sigma reaches the positions undetached in
train mode, JAX ``models/pcvnet.py:96-97``).
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.sampler import sample_row_1d

MAX_LEVELS = 4

__all__ = ["gaussian_row_sample", "gaussian_row_sample_plain"]


def _log2(compress_factor: int) -> int:
    cf = int(compress_factor)
    if cf < 1 or cf & (cf - 1):
        raise ValueError(f"gaussian_row_sample: compress_factor must be a power of two, got "
                         f"{compress_factor}")
    return cf.bit_length() - 1


def gaussian_row_sample_plain(levels, pos: torch.Tensor, compress_factor: int) -> torch.Tensor:
    """Level i samples its (B, H, W1, W2_i) rows at ``pos / cf^i`` (linear,
    zero padding; ``ops/sampler.py::sample_row_1d``); the levels' (B, H, W1,
    K) outputs are concatenated level-major -> (B, H, W1, L*K) fp32. A NaN
    position gives NaN."""
    return torch.cat([sample_row_1d(vol, pos / compress_factor**i)
                      for i, vol in enumerate(levels)], dim=-1)


def _launcher():
    """``row_sample_launch``: four level pointers, four widths, the level
    count, pos, out, pixels, K, log2 of the compress factor, bf16 flag,
    stream."""
    fn = _build.load("row_sample").row_sample_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(levels, pos: torch.Tensor):
    """Validate the arguments on either device; returns the volumes' dtype."""
    L = len(levels)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"gaussian_row_sample: 1..{MAX_LEVELS} levels, got {L}")
    if pos.dtype != torch.float32 or not pos.is_contiguous() or pos.dim() != 4 or pos.shape[-1] < 1:
        raise ValueError(f"gaussian_row_sample: pos must be a contiguous fp32 (B, H, W1, K) "
                         f"tensor, got {pos.dtype} {tuple(pos.shape)}")
    lead = tuple(pos.shape[:3])
    dtype = levels[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gaussian_row_sample: volume dtype must be fp32 or bf16, got {dtype}")
    for v in levels:
        if (v.dtype != dtype or v.device != pos.device or not v.is_contiguous() or v.dim() != 4
                or tuple(v.shape[:3]) != lead or v.shape[3] < 1):
            raise ValueError(f"gaussian_row_sample: every level must be a contiguous {dtype} "
                             f"(*{lead}, W2) tensor on {pos.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    return dtype


def gaussian_row_sample(levels, pos: torch.Tensor, compress_factor: int) -> torch.Tensor:
    """``levels``: 1..4 contiguous (B, H, W1, W2_i) volumes, all fp32 or all
    bf16; ``pos``: contiguous (B, H, W1, K) fp32 level-0 positions, on the
    levels' device. Returns (B, H, W1, L*K) fp32: level i sampled at ``pos /
    compress_factor^i``, level-major. ``compress_factor`` must be a power of
    two."""
    levels = list(levels)
    log2_cf = _log2(compress_factor)
    dtype = _check(levels, pos)
    if pos.device.type == "cpu":
        return gaussian_row_sample_plain(levels, pos, compress_factor)
    if pos.device.type != "cuda":
        raise ValueError(f"gaussian_row_sample: unsupported device {pos.device}")
    _build.refuse_grad("gaussian_row_sample", "Queue 2 K5 backward", pos, *levels)

    L, lead, K = len(levels), tuple(pos.shape[:3]), pos.shape[3]
    out = torch.empty((*lead, L * K), dtype=torch.float32, device=pos.device)
    ptrs = [v.data_ptr() for v in levels] + [None] * (MAX_LEVELS - L)
    widths = [v.shape[3] for v in levels] + [0] * (MAX_LEVELS - L)
    fn = _launcher()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(*ptrs, *widths, L, pos.data_ptr(), out.data_ptr(), lead[0] * lead[1] * lead[2],
                 K, log2_cf, int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "gaussian_row_sample")
    gaussian_row_sample.launches += 1
    return out


gaussian_row_sample.launches = 0
