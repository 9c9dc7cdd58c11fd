"""Host-side layouts of the port's CUDA kernels, on the CPU: K2's packed
taps, forward and adjoint (unpacked here with the byte address the bf16
kernels' wgmma descriptors read), and the checks their TMA operands must
pass. No JAX."""

import numpy as np
import pytest
import torch

from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import (
    _flip_transpose, _pack_taps, encoder_stage_adjoint, tma_operand_check)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_adjoint_taps_unpacks_to_the_flipped_transposed_taps(dtype):
    w = torch.from_numpy(np.random.default_rng(9).standard_normal((64, 64, 3, 3),
                                                                  dtype=np.float32)).to(dtype)
    packed = _pack_taps(w, adjoint=True)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous() and packed.numel() == 9 * 64 * 64
    # HWIO taps (ky, kx, ci, co) of the adjoint conv, in the kernel's dtype
    want = _flip_transpose(w).to(torch.bfloat16).permute(2, 3, 1, 0)
    ky, kx, ci, co = torch.meshgrid(*(torch.arange(n) for n in (3, 3, 64, 64)), indexing="ij")
    # tap blocks of 64 rows x 128 bytes; row co holds input channel ci in
    # 16-byte chunk (ci // 8) ^ (co % 8): the 128-byte swizzle
    byte = (ky * 3 + kx) * 8192 + co * 128 + ((ci // 8) ^ (co % 8)) * 16 + (ci % 8) * 2
    assert torch.equal(packed.reshape(-1)[byte // 2], want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_taps_unpacks_to_the_forward_taps(dtype):
    w = torch.from_numpy(np.random.default_rng(10).standard_normal((64, 64, 3, 3),
                                                                   dtype=np.float32)).to(dtype)
    packed = _pack_taps(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous() and packed.numel() == 9 * 64 * 64
    # HWIO taps (ky, kx, ci, co) of the forward conv, in the kernel's dtype
    want = w.to(torch.bfloat16).permute(2, 3, 1, 0)
    ky, kx, ci, co = torch.meshgrid(*(torch.arange(n) for n in (3, 3, 64, 64)), indexing="ij")
    byte = (ky * 3 + kx) * 8192 + co * 128 + ((ci // 8) ^ (co % 8)) * 16 + (ci % 8) * 2
    assert torch.equal(packed.reshape(-1)[byte // 2], want)
    # one cached index per orientation: the adjoint's packing differs
    assert not torch.equal(_pack_taps(w, adjoint=True), packed)
    assert torch.equal(_pack_taps(w), packed)


def _dense(shape):
    B, H, W, C = shape
    return (H * W * C, W * C, C, 1)


@pytest.mark.parametrize("shape,stride,ptr,match", [
    ((2, 13, 61, 64), None, 1 << 20, None),
    ((1, 1, 1, 64), None, 16, None),
    ((2, 13, 61, 64), None, (1 << 20) + 8, "16-byte aligned"),
    ((2, 13, 61, 32), None, 1 << 20, r"\(B, H, W, 64\)"),
    ((13, 61, 64), (61 * 64, 64, 1), 1 << 20, r"\(B, H, W, 64\)"),
    ((2, 0, 61, 64), (0, 61 * 64, 64, 1), 1 << 20, r"\(B, H, W, 64\)"),
    ((2, 13, 61, 64), (13 * 64 * 64, 64 * 64, 64, 1), 1 << 20, "contiguous"),
])
def test_tma_operand_check(shape, stride, ptr, match):
    stride = _dense(shape) if stride is None else stride
    if match is None:
        tma_operand_check("g", shape, stride, ptr)
    else:
        with pytest.raises(ValueError, match=match):
            tma_operand_check("g", shape, stride, ptr)


def test_encoder_stage_adjoint_refuses_cpu_tensors():
    # the plain twin is encoder_stage_adjoint_plain; the launch is card-only
    g = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_stage_adjoint(g, torch.zeros((64, 64, 3, 3)))


@pytest.mark.parametrize("name", ["u", "v", "h"])
def test_tma_operand_check_names_the_forward_operand(name):
    # the forward stage's TMA operands: a misaligned or strided one is
    # refused under its own name
    shape = (2, 13, 61, 64)
    with pytest.raises(ValueError, match=f"encoder_stage: {name} must be 16-byte aligned"):
        tma_operand_check(name, shape, _dense(shape), (1 << 20) + 2)
    with pytest.raises(ValueError, match=f"encoder_stage: {name} must be contiguous"):
        tma_operand_check(name, shape, (13 * 61 * 128, 61 * 128, 128, 1), 1 << 20)
    tma_operand_check(name, shape, _dense(shape), 1 << 20)
