"""K2: one fused full-resolution encoder stage (``csrc/encoder_stage.cu``),
the port of the Pallas ``dkt_stereo_tpu/ops/pallas/encoder_conv.py::
encoder_stage``, its VJP (``encoder_stage_ad``), and the instance-norm fold
:func:`in_affine`.

The JAX kernel works on a width-to-depth packed, row-shifted frame (a TPU
lane and VMEM layout); this one takes logical (B, H, W, 64) NHWC tensors and
returns statistics per logical channel.

:func:`encoder_stage` takes the plain path (:func:`encoder_stage_plain`)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Under grad mode, with an input that requires grad, it runs through
:class:`EncoderStage`, whose backward (:func:`encoder_stage_bwd`) runs the
adjoint conv on flipped, IO-transposed taps, as the JAX VJP does
(``_stage_ad_bwd``): in bf16 one launch of the adjoint kernel, in fp32 one
more launch of the stage kernel with the identity affine. Otherwise it
launches exactly as at inference, and writes no ``h`` residual. Both bf16
kernels are wgmma fed by TMA, with taps packed by :func:`_pack_taps`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dkt_stereo_tpu_torch.ops.cuda import _build

CHANNELS = 64

__all__ = ["EncoderStage", "encoder_stage", "encoder_stage_adjoint", "encoder_stage_adjoint_plain",
           "encoder_stage_bwd", "encoder_stage_bwd_plain", "encoder_stage_plain", "in_affine"]


def in_affine(stats_sum, stats_sumsq, count, eps=1e-5):
    """Fold instance normalisation into (a, b) with ``x_norm = a*x + b`` from
    per-(sample, channel) sums over ``count`` pixels (the single-pass
    ``var = E[y^2] - mean^2`` of ``encoder_conv.py::in_affine``). The variance
    is clamped at 0 before ``rsqrt``, where cancellation could make it
    negative and the JAX form would give NaN."""
    mean = stats_sum / count
    var = (stats_sumsq / count - mean * mean).clamp_min(0.0)
    a = torch.rsqrt(var + eps)
    return a, -mean * a


def _bc(t):
    """(B, C) per-sample vector -> broadcastable over (B, H, W, C)."""
    return t[:, None, None, :]


def _prologue(u, a1, b1, v, a2, b2, relu_u):
    """h = [relu](a1*u + b1) [then relu(h + relu(a2*v + b2))], fp32."""
    h = u.float() * _bc(a1) + _bc(b1)
    if relu_u:
        h = h.clamp_min(0.0)
    if v is not None:
        hv = (v.float() * _bc(a2) + _bc(b2)).clamp_min(0.0)
        h = (h + hv).clamp_min(0.0)
    return h


def encoder_stage_plain(u, a1, b1, w, v=None, a2=None, b2=None, emit_h=False, relu_u=True):
    """Plain version of :func:`encoder_stage`, with the kernel's rounding
    points: h is rounded to the activation dtype, the conv accumulates in
    fp32 over the rounded h and weights, statistics come from the fp32 sums.
    Autocast is off inside, so an enclosing autocast region does not move
    the conv to bf16.
    """
    dt = u.dtype
    with torch.autocast(u.device.type, enabled=False):
        h = _prologue(u, a1, b1, v, a2, b2, relu_u).to(dt)
        acc = F.conv2d(h.float().permute(0, 3, 1, 2), w.to(dt).float(), padding=1)
        out = (
            acc.permute(0, 2, 3, 1).to(dt).contiguous(),
            acc.sum(dim=(2, 3)),
            acc.square().sum(dim=(2, 3)),
        )
    return out + (h,) if emit_h else out


def _lib(name="encoder_stage_launch"):
    """``encoder_stage_launch``: u, a1, b1, v, a2, b2, w, y, sum, sumsq, h,
    B, H, W, channels, relu_u, bf16 flag, stream. ``encoder_stage_adjoint_launch``:
    g, packed taps, y, B, H, W, stream."""
    fn = getattr(_build.load("encoder_stage"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "encoder_stage_launch":
            fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        else:
            fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"encoder_stage: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch(counter, u, a1, b1, w, v, a2, b2, emit_h, relu_u, stats=True):
    """Check the arguments, launch the kernel once on the current stream and
    add one to ``counter.launches``. Returns ``(y, sum, sumsq[, h])``; with
    ``stats`` False (fp32 only) the kernel skips the statistics and both are
    None."""
    if u.device.type != "cuda":
        raise ValueError(f"encoder_stage: unsupported device {u.device}")
    if u.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encoder_stage: u must be fp32 or bf16, got {u.dtype}")
    if u.dim() != 4 or u.shape[-1] != CHANNELS:
        raise ValueError(f"encoder_stage: u must be (B, H, W, {CHANNELS}), got {tuple(u.shape)}")
    B, H, W, C = u.shape
    dev, f32 = u.device, torch.float32
    _check("u", u, (B, H, W, C), u.dtype, dev)
    _check("a1", a1, (B, C), f32, dev)
    _check("b1", b1, (B, C), f32, dev)
    if tuple(w.shape) != (C, C, 3, 3) or w.device != dev:
        raise ValueError(f"encoder_stage: w must be ({C}, {C}, 3, 3) on {dev}, got {tuple(w.shape)}")
    if v is not None:
        _check("v", v, (B, H, W, C), u.dtype, dev)
        _check("a2", a2, (B, C), f32, dev)
        _check("b2", b2, (B, C), f32, dev)

    if u.dtype == torch.bfloat16:
        for name, t in (("u", u), ("v", v)):
            if t is not None:
                tma_operand_check(name, t.shape, t.stride(), t.data_ptr())
        taps = _pack_taps(w)
    else:
        taps = w.detach().float().permute(2, 3, 1, 0).contiguous()  # HWIO
    y = torch.empty_like(u)
    ssum = torch.zeros((B, C), dtype=f32, device=dev) if stats else None
    sssq = torch.zeros((B, C), dtype=f32, device=dev) if stats else None
    h = torch.empty_like(u) if emit_h else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(u), ptr(a1), ptr(b1), ptr(v), ptr(a2), ptr(b2), ptr(taps), ptr(y),
                 ptr(ssum), ptr(sssq), ptr(h), B, H, W, C, int(relu_u),
                 int(u.dtype == torch.bfloat16), stream)
    _build.check_launch(err, "encoder_stage")
    counter.launches += 1
    out = (y, ssum, sssq)
    return out + (h,) if emit_h else out


def encoder_stage(u, a1, b1, w, v=None, a2=None, b2=None, emit_h=False, relu_u=True):
    """``y = conv3x3(relu(a1*u + b1 [+ relu(a2*v + b2)]))`` with zero SAME
    padding and no bias.

    u, v: (B, H, W, 64) NHWC, fp32 or bf16. a*, b*: (B, 64) fp32 per-sample
    affines. w: (64, 64, 3, 3) OIHW conv weight (cast to u's dtype).
    Returns ``(y, sum, sumsq[, h])``: y (B, H, W, 64) in u's dtype; sum and
    sumsq (B, 64) fp32 over all H*W pixels of the fp32 conv output; h the
    transformed input in u's dtype when ``emit_h``. Differentiable in every
    tensor argument through :class:`EncoderStage`."""
    tensors = (u, a1, b1, w, v, a2, b2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return EncoderStage.apply(*tensors, emit_h, relu_u)
    if u.device.type == "cpu":
        return encoder_stage_plain(u, a1, b1, w, v, a2, b2, emit_h, relu_u)
    return _launch(encoder_stage, u, a1, b1, w, v, a2, b2, emit_h, relu_u)


encoder_stage.launches = 0


def _identity(g):
    """The identity affine (a = 1, b = 0), fp32 (B, C), for g (B, H, W, C)."""
    ones = torch.ones((g.shape[0], g.shape[-1]), dtype=torch.float32, device=g.device)
    return ones, torch.zeros_like(ones)


def _flip_transpose(w):
    """The adjoint taps of an OIHW 3x3 conv: spatial flip + IO transpose
    (JAX ``_flip_transpose``, ``encoder_conv.py:369``)."""
    return w.detach().flip(2, 3).transpose(0, 1)


_TAP_INDEX: dict = {}


def _tap_index(device, adjoint):
    """For each element of the packed taps, its flat index in the OIHW
    weight (cached per device and orientation): packed[t, co, p, e] is
    w[co, ci, ky, kx] for the forward and flip_transpose(w)[co, ci, ky, kx]
    = w[ci, co, 2 - ky, 2 - kx] for the adjoint, with t = 3 ky + kx and
    ci = 8 (p ^ (co % 8)) + e."""
    idx = _TAP_INDEX.get((device, adjoint))
    if idx is None:
        C = CHANNELS
        t, co, p, e = torch.meshgrid(torch.arange(9), torch.arange(C), torch.arange(C // 8),
                                     torch.arange(8), indexing="ij")
        ci = (p ^ (co % 8)) * 8 + e
        ky, kx = t // 3, t % 3
        if adjoint:
            idx = ((ci * C + co) * 3 + 2 - ky) * 3 + 2 - kx
        else:
            idx = ((co * C + ci) * 3 + ky) * 3 + kx
        idx = idx.reshape(-1).to(device)
        _TAP_INDEX[(device, adjoint)] = idx
    return idx


def _pack_taps(w, adjoint=False):
    """The taps of OIHW ``w`` (flipped and IO-transposed with ``adjoint``)
    as the bf16 kernels copy them into shared memory: (9, 64, 8, 8) bf16,
    tap-major (ky * 3 + kx), one row of 64 input channels per output
    channel (the K-major A operand of wgmma, 128 bytes a row), with the
    16-byte chunk c of row ``co`` stored at chunk ``c ^ (co % 8)``: the
    128-byte swizzle the kernels' descriptors read. One gather and one
    cast."""
    C = CHANNELS
    flat = w.detach().reshape(-1).index_select(0, _tap_index(w.device, adjoint))
    return flat.to(torch.bfloat16).view(9, C, C // 8, 8)


def tma_operand_check(name, shape, stride, data_ptr, op="encoder_stage"):
    """Raise unless a tensor of this shape, element stride and address can
    be a bf16 (B, H, W, 64) operand of the bf16 kernels' TMA maps: dense
    NHWC and a 16-byte-aligned base (byte strides are then multiples of
    128). The launchers refuse more tiles than an int counts."""
    if len(shape) != 4 or shape[-1] != CHANNELS or min(shape) < 1:
        raise ValueError(f"{op}: {name} must be (B, H, W, {CHANNELS}), got {tuple(shape)}")
    B, H, W, C = shape
    if tuple(stride) != (H * W * C, W * C, C, 1):
        raise ValueError(f"{op}: {name} must be contiguous, got strides {tuple(stride)} for "
                         f"shape {tuple(shape)}")
    if data_ptr % 16:
        raise ValueError(f"{op}: {name} must be 16-byte aligned for TMA, got address "
                         f"{data_ptr:#x}")


def encoder_stage_adjoint_plain(g, w):
    """Plain version of :func:`encoder_stage_adjoint`: the plain stage with
    the identity affine, no ReLU and the adjoint taps."""
    ones, zeros = _identity(g)
    return encoder_stage_plain(g, ones, zeros, _flip_transpose(w), relu_u=False)[0]


def encoder_stage_adjoint(g, w):
    """The adjoint of a stage's zero-SAME 3x3 conv with OIHW weights ``w``,
    applied to g (B, H, W, 64) on the card in the activation dtype: the
    flipped, IO-transposed taps, no affine, ReLU, v or statistics, as JAX's
    VJP calls ``encoder_stage`` (``encoder_conv.py:411-422``). bf16 is one
    launch of the adjoint kernel; fp32 one launch of the stage kernel with
    the identity affine. The result is rounded to g's dtype. Counts in
    ``encoder_stage_bwd.launches``."""
    if g.device.type != "cuda":
        raise ValueError(f"encoder_stage_adjoint: unsupported device {g.device}")
    if g.dtype != torch.bfloat16:
        ones, zeros = _identity(g)
        return _launch(encoder_stage_bwd, g, ones, zeros, _flip_transpose(w), None, None, None,
                       False, False, stats=False)[0]
    if tuple(w.shape) != (CHANNELS, CHANNELS, 3, 3) or w.device != g.device:
        raise ValueError(f"encoder_stage_adjoint: w must be ({CHANNELS}, {CHANNELS}, 3, 3) on "
                         f"{g.device}, got {tuple(w.shape)} on {w.device}")
    tma_operand_check("g", g.shape, g.stride(), g.data_ptr(), "encoder_stage_adjoint")
    y = torch.empty_like(g)
    taps = _pack_taps(w, adjoint=True)
    B, H, W, _ = g.shape
    fn = _lib("encoder_stage_adjoint_launch")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(g.data_ptr(), taps.data_ptr(), y.data_ptr(), B, H, W, stream)
    _build.check_launch(err, "encoder_stage_adjoint")
    encoder_stage_bwd.launches += 1
    return y


def _stage_bwd(adjoint, u, a1, b1, w, y, h, gy, gs, gss, v=None, a2=None, b2=None,
               gh_out=None, relu_u=True, needs=(True,) * 7):
    """The steps of JAX ``_stage_ad_bwd`` on logical tensors, with the
    adjoint conv ``adjoint(g, w)`` given by the caller. Zero SAME padding
    takes the place of JAX's valid-region masks. ``needs`` says which of
    (u, a1, b1, w, v, a2, b2) get a gradient; the others get None."""
    dt = u.dtype
    # the cotangent of the raw conv output: y also feeds sum y and sum y^2.
    # JAX takes y here as stored (rounded), not the fp32 accumulator
    g_y = gy.float() + _bc(gs) + 2.0 * y.float() * _bc(gss)
    g_u = g_a1 = g_b1 = g_w = g_v = g_a2 = g_b2 = None
    if any(needs[i] for i in (0, 1, 2, 4, 5, 6)):
        # the adjoint conv reads g_y rounded to the activation dtype; g_h
        # comes out rounded too, and only then is gh_out added in fp32
        g_h = adjoint(g_y.to(dt).contiguous(), w).float()
        if gh_out is not None:
            g_h += gh_out.float()
        # back through the ReLU gates and the affines
        if v is not None:
            g_h *= h > 0  # the outer relu: h = relu(relu?(t1) + relu(t2))
            g_t2 = g_h * (v.float() * _bc(a2) + _bc(b2) > 0)
            g_v = (g_t2 * _bc(a2)).to(v.dtype) if needs[4] else None
            g_a2 = (g_t2 * v.float()).sum(dim=(1, 2)) if needs[5] else None
            g_b2 = g_t2.sum(dim=(1, 2)) if needs[6] else None
            del g_t2
        g_t1 = g_h * (u.float() * _bc(a1) + _bc(b1) > 0) if relu_u else g_h
        g_u = (g_t1 * _bc(a1)).to(dt) if needs[0] else None
        g_a1 = (g_t1 * u.float()).sum(dim=(1, 2)) if needs[1] else None
        g_b1 = g_t1.sum(dim=(1, 2)) if needs[2] else None
        del g_t1, g_h
    if needs[3]:
        # nine tap contractions of the fp32 h with the unrounded g_y over
        # (B, H, W), rounded to the weight's working dtype as JAX rounds its
        # dense taps, then returned in the weight's own dtype
        g_w = torch.ops.aten.convolution_backward(
            g_y.permute(0, 3, 1, 2), h.float().permute(0, 3, 1, 2), w.detach().float(), None,
            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]
        g_w = g_w.to(dt).to(w.dtype)
    return g_u, g_a1, g_b1, g_w, g_v, g_a2, g_b2


def encoder_stage_bwd_plain(u, a1, b1, w, y, h, gy, gs, gss, v=None, a2=None, b2=None,
                            gh_out=None, relu_u=True, needs=(True,) * 7):
    """Plain version of :func:`encoder_stage_bwd`: the adjoint conv is
    :func:`encoder_stage_adjoint_plain`."""
    return _stage_bwd(encoder_stage_adjoint_plain, u, a1, b1, w, y, h, gy, gs, gss, v, a2, b2,
                      gh_out, relu_u, needs)


def encoder_stage_bwd(u, a1, b1, w, y, h, gy, gs, gss, v=None, a2=None, b2=None,
                      gh_out=None, relu_u=True, needs=(True,) * 7):
    """The VJP of one stage (JAX ``_stage_ad_bwd``, ``encoder_conv.py:394``)
    from the forward's inputs, its outputs ``y`` and ``h`` (always kept by
    :class:`EncoderStage`), and the cotangents of y, sum, sumsq and, with
    the emitted h, of h. Returns the gradients of (u, a1, b1, w, v, a2, b2),
    None where ``needs`` says so. The adjoint conv is one kernel launch
    (:func:`encoder_stage_adjoint`); the rest is PyTorch, as it is XLA in
    JAX."""
    return _stage_bwd(encoder_stage_adjoint, u, a1, b1, w, y, h, gy, gs, gss, v, a2, b2,
                      gh_out, relu_u, needs)


encoder_stage_bwd.launches = 0


class EncoderStage(torch.autograd.Function):
    """:func:`encoder_stage` with a backward. The forward always writes h,
    the backward's residual (JAX ``_stage_ad_fwd``), and returns it only
    when ``emit_h`` asks. CPU tensors take the plain forward and
    :func:`encoder_stage_bwd_plain`; CUDA tensors the kernel and
    :func:`encoder_stage_bwd`. The backward runs with autocast off, so its
    fp32 cotangent and weight contraction stay fp32."""

    @staticmethod
    def forward(ctx, u, a1, b1, w, v, a2, b2, emit_h, relu_u):
        if u.device.type == "cpu":
            y, s, ss, h = encoder_stage_plain(u, a1, b1, w, v, a2, b2, True, relu_u)
        else:
            y, s, ss, h = _launch(encoder_stage, u, a1, b1, w, v, a2, b2, True, relu_u)
        ctx.save_for_backward(u, a1, b1, w, v, a2, b2, y, h)
        ctx.relu_u = relu_u
        return (y, s, ss, h) if emit_h else (y, s, ss)

    @staticmethod
    def backward(ctx, gy, gs, gss, gh_out=None):
        u, a1, b1, w, v, a2, b2, y, h = ctx.saved_tensors
        bwd = encoder_stage_bwd_plain if u.device.type == "cpu" else encoder_stage_bwd
        with torch.autocast(u.device.type, enabled=False):
            grads = bwd(u, a1, b1, w, y, h, gy, gs, gss, v, a2, b2, gh_out, ctx.relu_u,
                        ctx.needs_input_grad[:7])
        return (*grads, None, None)
