"""Precision of the plain references: exact fp32 (no TF32) and the control's
float8 e4m3 rounding of a product's operands, for any model reference."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_fp32():
    """Matrix products and convolutions in full fp32 (no TF32) inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, back in ``x``'s dtype. The gradient passes
    straight through."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def identity(x):
    return x
