"""K5: PCVNet's Gaussian row sampling over every pyramid level in one
launch (``csrc/row_sample.cu``) and its backward (``csrc/row_sample_bwd.cu``:
dvol of every level and dpos in one launch), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/row_sample.py::row_sample_pallas`` and its
custom VJP.

:func:`gaussian_row_sample` takes the plain path
(:func:`gaussian_row_sample_plain`, ``sample_row_1d`` per level, the same
function as JAX ``nn/pcv.py::gaussian_corr_lookup``, differentiated by
autograd) only for CPU tensors; for CUDA tensors it goes through
:class:`GaussianRowSample`, whose forward and backward launch the kernels or
raise. The backward gives each level its gradient in that level's dtype and
the level-0 positions theirs (the chain through ``pos / cf^i`` included):
sigma reaches the positions undetached in train mode (JAX
``models/pcvnet.py:96-97``), so the position gradient carries the loss from
the lookup back into the previous iteration's updater.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.sampler import sample_row_1d

MAX_LEVELS = 4
# the backward stages a pixel's levels * K taps in shared memory, 16 bytes
# each and 8 more a sample for the counting sort; beyond this a block of
# one pixel would not fit
MAX_TAPS = 3072

__all__ = ["GaussianRowSample", "gaussian_row_sample", "gaussian_row_sample_bwd",
           "gaussian_row_sample_bwd_plain", "gaussian_row_sample_plain"]


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


def gaussian_row_sample_bwd_plain(levels, pos: torch.Tensor, g: torch.Tensor,
                                  compress_factor: int, need_vol: bool = True,
                                  need_pos: bool = True):
    """The VJP of :func:`gaussian_row_sample_plain` written out: ``g`` (B, H,
    W1, L*K) -> ``(dlevels, dpos)``. Level i's x0 = floor(pos / cf^i) tap
    gets ``g * (1 - w)`` and its x0 + 1 tap ``g * w`` (w = x - x0), summed
    in fp32 and cast once to the level's dtype, as the JAX kernel does; a
    tap outside the row gets nothing. ``dpos`` (fp32) is ``sum_i (g *
    v_i[x0 + 1] - g * v_i[x0]) / cf^i`` with taps outside the row read as
    0: the two-tap form at exact integers too. ``dlevels`` or ``dpos`` is
    None when not asked for. A NaN position gives NaN in its row's dvol (at
    index 0, where its clamped taps point) and zero dpos."""
    K = pos.shape[-1]
    g = g.float()
    dlevels = [] if need_vol else None
    dpos = torch.zeros_like(pos, dtype=torch.float32) if need_pos else None
    for i, vol in enumerate(levels):
        gi = g[..., i * K:(i + 1) * K]
        x = pos.float() / compress_factor**i
        x0 = torch.floor(x)
        w = x - x0
        S = vol.shape[-1]
        taps = []
        for ix, weight in ((x0, 1 - w), (x0 + 1, w)):
            inb = (ix >= 0) & (ix <= S - 1)
            taps.append((ix.nan_to_num(0.0).clamp(0, S - 1).long(), inb, weight))
        if need_vol:
            d = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
            for idx, inb, weight in taps:
                d.scatter_add_(-1, idx, gi * weight * inb)
            dlevels.append(d.to(vol.dtype))
        if need_pos:
            v0, v1 = (torch.gather(vol, -1, idx).float() * inb for idx, inb, _ in taps)
            dpos = dpos + (gi * v1 - gi * v0) / compress_factor**i
    return dlevels, dpos


def _launcher(name: str):
    """``row_sample_launch``: four level pointers, four widths, the level
    count, pos, out, pixels, K, log2 of the compress factor, bf16 flag,
    stream. ``row_sample_bwd_launch``: four level pointers, four dvol
    pointers, four widths, the level count, pos, g, dpos, pixels, K, log2
    of the compress factor, bf16 flag, stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "row_sample":
            fn.argtypes = [p] * 4 + [i] * 5 + [p, p, ll, i, i, i, p]
        else:
            fn.argtypes = [p] * 8 + [i] * 5 + [p, p, p, ll, i, i, i, p]
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


def _level_args(levels):
    pad = MAX_LEVELS - len(levels)
    return [v.data_ptr() for v in levels] + [None] * pad, [v.shape[3] for v in levels] + [0] * pad


def _launch_fwd(levels, pos, compress_factor):
    log2_cf = _log2(compress_factor)
    dtype = _check(levels, pos)
    L, lead, K = len(levels), tuple(pos.shape[:3]), pos.shape[3]
    out = torch.empty((*lead, L * K), dtype=torch.float32, device=pos.device)
    ptrs, widths = _level_args(levels)
    fn = _launcher("row_sample")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(*ptrs, *widths, L, pos.data_ptr(), out.data_ptr(), lead[0] * lead[1] * lead[2],
                 K, log2_cf, int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "gaussian_row_sample")
    gaussian_row_sample.launches += 1
    return out


def gaussian_row_sample_bwd(levels, pos: torch.Tensor, g: torch.Tensor, compress_factor: int,
                            need_vol: bool = True, need_pos: bool = True):
    """The lookup's VJP: ``g`` (B, H, W1, L*K) fp32 -> ``(dlevels, dpos)``,
    one dvol per level in its dtype and the level-0 positions' fp32
    gradient; either is None when not asked for. CPU tensors take
    :func:`gaussian_row_sample_bwd_plain`; CUDA tensors launch the kernel
    (one launch for both) or raise."""
    levels = list(levels)
    log2_cf = _log2(compress_factor)
    dtype = _check(levels, pos)
    L, lead, K = len(levels), tuple(pos.shape[:3]), pos.shape[3]
    if (g.dtype != torch.float32 or not g.is_contiguous() or g.device != pos.device
            or tuple(g.shape) != (*lead, L * K)):
        raise ValueError(f"gaussian_row_sample_bwd: g must be a contiguous fp32 {(*lead, L * K)} "
                         f"tensor on {pos.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    if not (need_vol or need_pos):
        return None, None
    if pos.device.type == "cpu":
        return gaussian_row_sample_bwd_plain(levels, pos, g, compress_factor, need_vol, need_pos)
    if pos.device.type != "cuda":
        raise ValueError(f"gaussian_row_sample_bwd: unsupported device {pos.device}")
    if L * K > MAX_TAPS:
        raise ValueError(f"gaussian_row_sample_bwd: levels * K must be at most {MAX_TAPS}, got "
                         f"{L * K}")
    dlevels = [torch.empty_like(v) for v in levels] if need_vol else None
    dpos = torch.empty_like(pos) if need_pos else None
    ptrs, widths = _level_args(levels)
    dptrs = [d.data_ptr() for d in dlevels] if need_vol else [None] * L
    dptrs += [None] * (MAX_LEVELS - L)
    fn = _launcher("row_sample_bwd")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(*ptrs, *dptrs, *widths, L, pos.data_ptr(), g.data_ptr(),
                 dpos.data_ptr() if need_pos else None, lead[0] * lead[1] * lead[2], K, log2_cf,
                 int(dtype == torch.bfloat16), stream)
    _build.check_launch(err, "gaussian_row_sample_bwd")
    gaussian_row_sample_bwd.launches += 1
    return dlevels, dpos


class GaussianRowSample(torch.autograd.Function):
    """The lookup with its hand-written backward: ``apply(pos,
    compress_factor, *levels)``. Saves the positions and the levels (the
    JAX residuals, row_sample.py:150-160); the backward computes only the
    gradients ``ctx.needs_input_grad`` asks for, in one launch. CPU tensors
    run the plain versions of both directions."""

    @staticmethod
    def forward(ctx, pos, compress_factor, *levels):
        ctx.compress_factor = compress_factor
        ctx.save_for_backward(pos, *levels)
        if pos.device.type == "cpu":
            return gaussian_row_sample_plain(levels, pos, compress_factor)
        return _launch_fwd(levels, pos, compress_factor)

    @staticmethod
    def backward(ctx, g):
        pos, *levels = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        # the model folds and casts the lookup's output, so autograd may
        # hand back a strided gradient; the kernel reads it densely
        dlevels, dpos = gaussian_row_sample_bwd(levels, pos, g.contiguous(), ctx.compress_factor,
                                                need_vol=any(need),
                                                need_pos=ctx.needs_input_grad[0])
        dlevels = [d if n else None for d, n in zip(dlevels, need)] if dlevels else [None] * len(need)
        return (dpos, None, *dlevels)


def gaussian_row_sample(levels, pos: torch.Tensor, compress_factor: int) -> torch.Tensor:
    """``levels``: 1..4 contiguous (B, H, W1, W2_i) volumes, all fp32 or all
    bf16; ``pos``: contiguous (B, H, W1, K) fp32 level-0 positions, on the
    levels' device. Returns (B, H, W1, L*K) fp32: level i sampled at ``pos /
    compress_factor^i``, level-major, differentiable with respect to the
    levels and the positions. ``compress_factor`` must be a power of two."""
    levels = list(levels)
    if pos.device.type == "cpu":
        _log2(compress_factor)
        _check(levels, pos)
        return gaussian_row_sample_plain(levels, pos, compress_factor)
    if pos.device.type != "cuda":
        raise ValueError(f"gaussian_row_sample: unsupported device {pos.device}")
    # the arguments are checked where the kernel is launched
    return GaussianRowSample.apply(pos, compress_factor, *levels)


gaussian_row_sample.launches = 0
gaussian_row_sample_bwd.launches = 0
