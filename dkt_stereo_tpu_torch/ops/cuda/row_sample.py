"""K5: PCVNet's Gaussian row sampling over every pyramid level in one
launch (``csrc/row_sample.cu``) and its backward (``csrc/row_sample_bwd.cu``:
dvol of every level and dpos in one launch), the port of the Pallas
``dkt_stereo_tpu/ops/pallas/row_sample.py::row_sample_pallas`` and its
custom VJP.

:func:`gaussian_row_sample` returns what PCVNet's motion encoder reads:
the lookup of :func:`gaussian_row_sample_plain` ((B, H, W, L*G*S) fp32,
level-major, then Gaussian, then sample: the JAX signature) folded by
:func:`fold_lookup` to (B*G, L*S, H, W), channel l*S + s, and cast once to
the compute dtype: ``fold_lookup(plain, L, G).to(dtype)``. The folded
tensor is channels-last in memory ((B, G, H, W, L, S)), the layout cuDNN's
NHWC convolutions read without a layout transform. CPU tensors take that
plain path (differentiated by autograd); CUDA tensors go through
:class:`GaussianRowSample`, whose forward kernel writes the folded tensor in
``dtype`` itself and whose backward kernel reads the gradient folded and in
``dtype``: no cast or copy around the kernels. The backward gives each
level its gradient in that level's dtype and the level-0 positions theirs
(the chain through ``pos / cf^i`` included): sigma reaches the positions
undetached in train mode (JAX ``models/pcvnet.py:96-97``), so the position
gradient carries the loss from the lookup back into the previous
iteration's updater.

The forward takes any number of levels up to :data:`MAX_LEVELS` (its
parameter block) and any K whose staging fits a block's shared memory
(:func:`fwd_plan` picks the pixels a block owns and raises past that
limit). A non-finite position gives NaN in the forward, as in the plain
twin and JAX; the backward gives it no contribution and zero dpos. The
backward takes up to :data:`MAX_BWD_LEVELS` levels and :data:`MAX_TAPS`
taps a pixel; on CUDA tensors that need a gradient, :func:`gaussian_row_sample`
refuses more before it launches the forward.
"""

from __future__ import annotations

import ctypes

import torch

from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.sampler import sample_row_1d

MAX_LEVELS = 32  # kMaxLevels of the forward kernel's parameter block
MAX_BWD_LEVELS = 4
MAX_SMEM = 232_448  # a block's shared memory on the H100
PIXELS_PER_BLOCK = (64, 32, 16, 8)
# the backward stages a pixel's levels * K taps in shared memory, 16 bytes
# each and 8 more a sample for the counting sort; beyond this a block of
# one pixel would not fit
MAX_TAPS = 3072

__all__ = ["GaussianRowSample", "fold_lookup", "fwd_plan", "gaussian_row_sample",
           "gaussian_row_sample_bwd", "gaussian_row_sample_bwd_plain",
           "gaussian_row_sample_folded_plain", "gaussian_row_sample_plain", "unfold_lookup"]


def _log2(compress_factor: int) -> int:
    cf = int(compress_factor)
    if cf < 1 or cf & (cf - 1):
        raise ValueError(f"gaussian_row_sample: compress_factor must be a power of two, got "
                         f"{compress_factor}")
    return cf.bit_length() - 1


def fold_lookup(x: torch.Tensor, levels: int, gauss_num: int) -> torch.Tensor:
    """The motion encoder's fold: the (B, H, W, L*G*S) lookup, level-major,
    then Gaussian, then sample, to (B*G, L*S, H, W), channel l*S + s of
    image b*G + g (JAX ``nn/pcv.py``'s reshape of the lookup for the
    per-Gaussian convs), channels-last in memory ((B, G, H, W, L, S))."""
    B, H, W, C = x.shape
    G = gauss_num
    S = C // (levels * G)
    if levels * G * S != C:
        raise ValueError(f"fold_lookup: {C} channels are not {levels} levels x {G} Gaussians "
                         f"x S samples")
    y = x.reshape(B, H, W, levels, G, S).permute(0, 4, 1, 2, 3, 5)
    return y.reshape(B * G, H, W, levels * S).permute(0, 3, 1, 2)


def unfold_lookup(y: torch.Tensor, levels: int, gauss_num: int) -> torch.Tensor:
    """The inverse of :func:`fold_lookup`: (B*G, L*S, H, W) in any memory
    layout -> (B, H, W, L*G*S), contiguous, level-major."""
    BG, LS, H, W = y.shape
    G, S = gauss_num, LS // levels
    return y.reshape(BG // G, G, levels, S, H, W).permute(0, 4, 5, 2, 1, 3).reshape(
        BG // G, H, W, levels * G * S).contiguous()


def gaussian_row_sample_plain(levels, pos: torch.Tensor, compress_factor: int) -> torch.Tensor:
    """Level i samples its (B, H, W1, W2_i) rows at ``pos / cf^i`` (linear,
    zero padding; ``ops/sampler.py::sample_row_1d``); the levels' (B, H, W1,
    K) outputs are concatenated level-major -> (B, H, W1, L*K) fp32. A NaN
    position gives NaN."""
    return torch.cat([sample_row_1d(vol, pos / compress_factor**i)
                      for i, vol in enumerate(levels)], dim=-1)


def gaussian_row_sample_folded_plain(levels, pos: torch.Tensor, compress_factor: int,
                                     gauss_num: int,
                                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """What :func:`gaussian_row_sample` returns, by the plain path on any
    device: ``fold_lookup(gaussian_row_sample_plain(...), L, G).to(dtype)``,
    differentiable by autograd."""
    return fold_lookup(gaussian_row_sample_plain(levels, pos, compress_factor), len(levels),
                       gauss_num).to(dtype)


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


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def fwd_smem_bytes(widths, K: int, gauss_num: int, vol_itemsize: int, out_itemsize: int,
                   pixels: int) -> int:
    """Shared memory of one forward block (``row_sample.cu::make_plan``): the
    levels' row offsets, the tile's positions, each level's rows (every span
    from anywhere in its first 16-byte chunk), then the output's G runs, one
    a Gaussian, of pixels*L*S values each."""
    L = len(widths)
    LS = L * (K // gauss_num)
    span = lambda n: _round16(n) + 16  # noqa: E731
    return (_round16(L * 4) + span(pixels * K * 4)
            + sum(span(pixels * w * vol_itemsize) for w in widths)
            + gauss_num * span(pixels * LS * out_itemsize))


def fwd_plan(widths, K: int, gauss_num: int, vol_itemsize: int,
             out_itemsize: int) -> tuple[int, int]:
    """(pixels a block, shared-memory bytes) of the forward kernel: the
    widest block of which four fit an SM's shared memory, else the widest
    that fits at all, else ValueError naming the limit."""
    widths = [int(w) for w in widths]
    if not 1 <= len(widths) <= MAX_LEVELS:
        raise ValueError(f"gaussian_row_sample: 1..{MAX_LEVELS} levels (the kernel's parameter "
                         f"block), got {len(widths)}")

    def smem(p):
        return fwd_smem_bytes(widths, K, gauss_num, vol_itemsize, out_itemsize, p)

    for budget in (MAX_SMEM // 4, MAX_SMEM):
        for pixels in PIXELS_PER_BLOCK:
            if smem(pixels) <= budget:
                return pixels, smem(pixels)
    raise ValueError(f"gaussian_row_sample: widths {widths} at K {K} need {smem(8)} B of shared "
                     f"memory at 8 pixels a block, more than the {MAX_SMEM} B a block has")


def _launcher(name: str):
    """``row_sample_launch``: level pointers and widths (host arrays), the
    level count, pos, out, B, H*W, K, G, log2 of the compress factor, two
    bf16 flags (levels, out), pixels a block, stream.
    ``row_sample_bwd_launch``: four level pointers, four dvol pointers, four
    widths, the level count, pos, g, dpos, pixels, K, log2 of the compress
    factor, bf16 flag (levels), G, H*W, bf16 flag (g), stream."""
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "row_sample":
            fn.argtypes = [ctypes.POINTER(p), ctypes.POINTER(i), i, p, p] + [i] * 8 + [p]
        else:
            fn.argtypes = [p] * 8 + [i] * 5 + [p, p, p, ll] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _check(levels, pos: torch.Tensor, max_levels: int = MAX_LEVELS):
    """Validate the arguments on either device; returns the volumes' dtype."""
    L = len(levels)
    if not 1 <= L <= max_levels:
        raise ValueError(f"gaussian_row_sample: 1..{max_levels} levels, got {L}")
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


def _check_bwd_limits(L: int, K: int, device: torch.device) -> None:
    """The backward's limits: its parameter block of :data:`MAX_BWD_LEVELS`
    levels, and on the card :data:`MAX_TAPS` taps a pixel."""
    if not 1 <= L <= MAX_BWD_LEVELS:
        raise ValueError(f"gaussian_row_sample_bwd: 1..{MAX_BWD_LEVELS} levels (the backward "
                         f"kernel's parameter block), got {L}")
    if device.type == "cuda" and L * K > MAX_TAPS:
        raise ValueError(f"gaussian_row_sample_bwd: levels * K must be at most {MAX_TAPS}, got "
                         f"{L * K}")


def _check_fold(pos: torch.Tensor, gauss_num: int, dtype) -> None:
    if gauss_num < 1 or pos.shape[-1] % gauss_num:
        raise ValueError(f"gaussian_row_sample: K = {pos.shape[-1]} positions are not "
                         f"gauss_num = {gauss_num} Gaussians of equal size")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gaussian_row_sample: the output dtype must be fp32 or bf16, got "
                         f"{dtype}")


def _launch_fwd(levels, pos, compress_factor, gauss_num, dtype):
    """The kernel's folded output in ``dtype``, channels-last in memory."""
    log2_cf = _log2(compress_factor)
    vdt = _check(levels, pos)
    _check_fold(pos, gauss_num, dtype)
    L, (B, H, W, K) = len(levels), pos.shape
    if (L - 1) * log2_cf > 126:
        raise ValueError(f"gaussian_row_sample: cf^{L - 1} is beyond fp32's normal range")
    pixels, _ = fwd_plan([v.shape[3] for v in levels], K, gauss_num, vdt.itemsize,
                         dtype.itemsize)
    out = torch.empty((B * gauss_num, L * K // gauss_num, H, W), dtype=dtype, device=pos.device,
                      memory_format=torch.channels_last)
    n = len(levels)
    ptrs = (ctypes.c_void_p * n)(*[v.data_ptr() for v in levels])
    widths = (ctypes.c_int * n)(*[v.shape[3] for v in levels])
    fn = _launcher("row_sample")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(ptrs, widths, L, pos.data_ptr(), out.data_ptr(), B, H * W, K, gauss_num,
                 log2_cf, int(vdt == torch.bfloat16), int(dtype == torch.bfloat16), pixels,
                 stream)
    _build.check_launch(err, "gaussian_row_sample")
    gaussian_row_sample.launches += 1
    return out


def gaussian_row_sample_bwd(levels, pos: torch.Tensor, g: torch.Tensor, compress_factor: int,
                            gauss_num: int, need_vol: bool = True, need_pos: bool = True):
    """The lookup's VJP: ``g``, the gradient of :func:`gaussian_row_sample`'s
    folded (B*G, L*S, H, W) output in fp32 or bf16, dense in the folded
    layout -> ``(dlevels, dpos)``, one dvol per level in its dtype and the
    level-0 positions' fp32 gradient; either is None when not asked for.
    CPU tensors take :func:`gaussian_row_sample_bwd_plain` of the unfolded
    gradient; CUDA tensors launch the kernel (one launch for both) or
    raise."""
    levels = list(levels)
    log2_cf = _log2(compress_factor)
    dtype = _check(levels, pos)
    _check_fold(pos, gauss_num, g.dtype)
    L, (B, H, W, K) = len(levels), pos.shape
    _check_bwd_limits(L, K, pos.device)
    want = (B * gauss_num, L * K // gauss_num, H, W)
    if (tuple(g.shape) != want or g.device != pos.device
            or (pos.device.type == "cuda"
                and not g.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError(f"gaussian_row_sample_bwd: g must be a {want} tensor on {pos.device}, "
                         f"dense channels-last, got {g.dtype} {tuple(g.shape)} strides "
                         f"{g.stride()} on {g.device}")
    if not (need_vol or need_pos):
        return None, None
    if pos.device.type == "cpu":
        return gaussian_row_sample_bwd_plain(levels, pos, unfold_lookup(g, L, gauss_num),
                                             compress_factor, need_vol, need_pos)
    if pos.device.type != "cuda":
        raise ValueError(f"gaussian_row_sample_bwd: unsupported device {pos.device}")
    dlevels = [torch.empty_like(v) for v in levels] if need_vol else None
    dpos = torch.empty_like(pos) if need_pos else None
    pad = MAX_BWD_LEVELS - L
    ptrs = [v.data_ptr() for v in levels] + [None] * pad
    widths = [v.shape[3] for v in levels] + [0] * pad
    dptrs = [d.data_ptr() for d in dlevels] if need_vol else [None] * L
    dptrs += [None] * pad
    fn = _launcher("row_sample_bwd")
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        err = fn(*ptrs, *dptrs, *widths, L, pos.data_ptr(), g.data_ptr(),
                 dpos.data_ptr() if need_pos else None, B * H * W, K, log2_cf,
                 int(dtype == torch.bfloat16), gauss_num, H * W, int(g.dtype == torch.bfloat16),
                 stream)
    _build.check_launch(err, "gaussian_row_sample_bwd")
    gaussian_row_sample_bwd.launches += 1
    return dlevels, dpos


class GaussianRowSample(torch.autograd.Function):
    """The lookup with its hand-written backward: ``apply(pos,
    compress_factor, gauss_num, dtype, *levels)`` returns the folded (B*G,
    L*S, H, W) tensor in ``dtype``. Saves the positions and the levels (the
    JAX residuals, row_sample.py:150-160); the backward computes only the
    gradients ``ctx.needs_input_grad`` asks for, in one launch. CPU tensors
    run the plain versions of both directions."""

    @staticmethod
    def forward(ctx, pos, compress_factor, gauss_num, dtype, *levels):
        ctx.compress_factor, ctx.gauss_num = compress_factor, gauss_num
        ctx.save_for_backward(pos, *levels)
        if pos.device.type == "cpu":
            return gaussian_row_sample_folded_plain(levels, pos, compress_factor, gauss_num,
                                                    dtype)
        return _launch_fwd(levels, pos, compress_factor, gauss_num, dtype)

    @staticmethod
    def backward(ctx, g):
        pos, *levels = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        # the kernel reads g densely in the folded layout; cuDNN's convolution
        # of the channels-last input hands that back, any other layout costs
        # one counted copy (the plain backward on the CPU takes any layout)
        if pos.device.type == "cuda" and not g.is_contiguous(memory_format=torch.channels_last):
            g = g.contiguous(memory_format=torch.channels_last)
            gaussian_row_sample_bwd.g_copies += 1
        dlevels, dpos = gaussian_row_sample_bwd(levels, pos, g, ctx.compress_factor,
                                                ctx.gauss_num, need_vol=any(need),
                                                need_pos=ctx.needs_input_grad[0])
        dlevels = [d if n else None for d, n in zip(dlevels, need)] if dlevels else [None] * len(need)
        return (dpos, None, None, None, *dlevels)


def gaussian_row_sample(levels, pos: torch.Tensor, compress_factor: int, gauss_num: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``levels``: contiguous (B, H, W1, W2_i) volumes, all fp32 or all bf16;
    ``pos``: contiguous (B, H, W1, K) fp32 level-0 positions, K = G*S
    Gaussian-major, on the levels' device. Returns the motion encoder's
    input, ``fold_lookup(gaussian_row_sample_plain(levels, pos, cf), L,
    G).to(dtype)``: (B*G, L*S, H, W1) in ``dtype`` (fp32 or bf16),
    channels-last in memory, level i sampled at ``pos / cf^i``,
    differentiable with respect to the levels and the positions.
    ``compress_factor`` must be a power of two. On CUDA tensors that need a
    gradient, the backward's limits (:func:`_check_bwd_limits`) are checked
    before the forward is launched."""
    levels = list(levels)
    if pos.device.type == "cpu":
        _log2(compress_factor)
        _check(levels, pos)
        _check_fold(pos, gauss_num, dtype)
        return gaussian_row_sample_folded_plain(levels, pos, compress_factor, gauss_num, dtype)
    if pos.device.type != "cuda":
        raise ValueError(f"gaussian_row_sample: unsupported device {pos.device}")
    # the arguments are checked where the kernel is launched, the backward's
    # limits here, so that a step past them fails before its forward
    if torch.is_grad_enabled() and (pos.requires_grad or any(v.requires_grad for v in levels)):
        _check_bwd_limits(len(levels), pos.shape[-1], pos.device)
    return GaussianRowSample.apply(pos, compress_factor, gauss_num, dtype, *levels)


gaussian_row_sample.launches = 0
gaussian_row_sample_bwd.launches = 0
gaussian_row_sample_bwd.g_copies = 0  # gradients copied to the folded layout before the kernel
