"""K2: one fused full-resolution encoder stage (``csrc/encoder_stage.cu``),
the port of the Pallas ``dkt_stereo_tpu/ops/pallas/encoder_conv.py::
encoder_stage``, plus the instance-norm fold :func:`in_affine`.

The JAX kernel works on a width-to-depth packed, row-shifted frame (a TPU
lane and VMEM layout); this one takes logical (B, H, W, 64) NHWC tensors and
returns statistics per logical channel.

:func:`encoder_stage` takes the plain path (:func:`encoder_stage_plain`)
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dkt_stereo_tpu_torch.ops.cuda import _build

CHANNELS = 64

__all__ = ["encoder_stage", "encoder_stage_plain", "in_affine"]


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


def _prologue(u, a1, b1, v, a2, b2, relu_u):
    """h = [relu](a1*u + b1) [then relu(h + relu(a2*v + b2))], fp32."""
    h = u.float() * a1[:, None, None, :] + b1[:, None, None, :]
    if relu_u:
        h = h.clamp_min(0.0)
    if v is not None:
        hv = (v.float() * a2[:, None, None, :] + b2[:, None, None, :]).clamp_min(0.0)
        h = (h + hv).clamp_min(0.0)
    return h


def encoder_stage_plain(u, a1, b1, w, v=None, a2=None, b2=None, emit_h=False, relu_u=True):
    """Plain version of :func:`encoder_stage`, with the kernel's rounding
    points: h is rounded to the activation dtype, the conv accumulates in
    fp32 over the rounded h and weights, statistics come from the fp32 sums.
    """
    dt = u.dtype
    h = _prologue(u, a1, b1, v, a2, b2, relu_u).to(dt)
    acc = F.conv2d(h.float().permute(0, 3, 1, 2), w.to(dt).float(), padding=1)
    out = (
        acc.permute(0, 2, 3, 1).to(dt).contiguous(),
        acc.sum(dim=(2, 3)),
        acc.square().sum(dim=(2, 3)),
    )
    return out + (h,) if emit_h else out


def _lib():
    lib = _build.load("encoder_stage")
    fn = lib.encoder_stage_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"encoder_stage: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def encoder_stage(u, a1, b1, w, v=None, a2=None, b2=None, emit_h=False, relu_u=True):
    """``y = conv3x3(relu(a1*u + b1 [+ relu(a2*v + b2)]))`` with zero SAME
    padding and no bias.

    u, v: (B, H, W, 64) NHWC, fp32 or bf16. a*, b*: (B, 64) fp32 per-sample
    affines. w: (64, 64, 3, 3) OIHW conv weight (cast to u's dtype).
    Returns ``(y, sum, sumsq[, h])``: y (B, H, W, 64) in u's dtype; sum and
    sumsq (B, 64) fp32 over all H*W pixels of the fp32 conv output; h the
    transformed input in u's dtype when ``emit_h``."""
    if u.device.type == "cpu":
        return encoder_stage_plain(u, a1, b1, w, v, a2, b2, emit_h, relu_u)
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

    w_hwio = w.to(u.dtype).permute(2, 3, 1, 0).contiguous()
    y = torch.empty_like(u)
    ssum = torch.zeros((B, C), dtype=f32, device=dev)
    sssq = torch.zeros((B, C), dtype=f32, device=dev)
    h = torch.empty_like(u) if emit_h else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(u), ptr(a1), ptr(b1), ptr(v), ptr(a2), ptr(b2), ptr(w_hwio), ptr(y),
                 ptr(ssum), ptr(sssq), ptr(h), B, H, W, C, int(relu_u),
                 int(u.dtype == torch.bfloat16), stream)
    _build.check_launch(err, "encoder_stage")
    encoder_stage.launches += 1
    out = (y, ssum, sssq)
    return out + (h,) if emit_h else out


encoder_stage.launches = 0
