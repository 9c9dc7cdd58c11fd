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


# --- K5's forward and K4's backward: shared-memory plans (no JAX) ------------


def _r16(n):
    return (n + 15) // 16 * 16


@pytest.mark.parametrize("widths,ev,eo,pixels", [
    ((180, 45, 11), 2, 2, 64),  # the PCV step's levels, bf16 -> bf16
    ((320, 80, 20), 2, 2, 32),  # the PCV frame's
    ((320, 80, 20), 4, 4, 16),  # fp32 -> fp32
    ((160, 80, 40), 2, 2, 32),  # fast.json's 1/8 grid
])
def test_k5_forward_plan_at_the_main_shapes(widths, ev, eo, pixels):
    """K 36 = 4 Gaussians x 9 samples, 3 levels: a table of level offsets,
    the tile's positions and rows (each span with 16 bytes to start
    anywhere), 4 channels-last runs of pixels x 27 outputs; the widest
    block of which four fit an SM (58,112 B)."""
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import fwd_plan, fwd_smem_bytes

    def smem(p):
        rows = sum(_r16(p * w * ev) + 16 for w in widths)
        return _r16(3 * 4) + _r16(p * 36 * 4) + 16 + rows + 4 * (_r16(p * 27 * eo) + 16)

    assert fwd_plan(widths, 36, 4, ev, eo) == (pixels, smem(pixels))
    assert smem(pixels) <= 232_448 // 4 < (smem(2 * pixels) if pixels < 64 else 10**9)
    assert fwd_smem_bytes(widths, 36, 4, ev, eo, pixels) == smem(pixels)


def test_k5_forward_plan_falls_back_and_names_its_limit():
    """Past a quarter of an SM the plan takes the widest block that fits at
    all; past 232,448 B at 8 pixels, or past 32 levels, it raises."""
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import MAX_SMEM, fwd_plan, fwd_smem_bytes

    pixels, nbytes = fwd_plan((6000,), 36, 4, 2, 2)
    assert MAX_SMEM // 4 < nbytes == fwd_smem_bytes((6000,), 36, 4, 2, 2, pixels) <= MAX_SMEM
    assert fwd_smem_bytes((6000,), 36, 4, 2, 2, 2 * pixels) > MAX_SMEM
    with pytest.raises(ValueError, match="232448 B a block has"):
        fwd_plan((20000,), 36, 4, 2, 2)
    with pytest.raises(ValueError, match=r"1\.\.32 levels"):
        fwd_plan((8,) * 33, 36, 4, 2, 2)


@pytest.mark.parametrize("levels,K,device,refused", [
    (4, 36, "cuda", None),  # the PCV configs' 3 levels fit with room
    (5, 36, "cuda", r"1\.\.4 levels"),  # past the backward's parameter block
    (5, 36, "cpu", r"1\.\.4 levels"),  # the plain backward keeps the kernel's contract
    (4, 769, "cuda", "at most 3072"),  # a pixel's taps past one block's shared memory
    (4, 769, "cpu", None),  # the plain backward has no shared memory
])
def test_k5_backward_limits(levels, K, device, refused):
    """K5's backward limits: up to 4 levels, and on the card up to 3,072
    taps a pixel. ``gaussian_row_sample`` checks them on CUDA tensors that
    need a gradient before it launches the forward."""
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
        MAX_BWD_LEVELS, MAX_TAPS, _check_bwd_limits)

    assert (MAX_BWD_LEVELS, MAX_TAPS) == (4, 3072)
    if refused is None:
        _check_bwd_limits(levels, K, torch.device(device))
    else:
        with pytest.raises(ValueError, match=refused):
            _check_bwd_limits(levels, K, torch.device(device))


@pytest.mark.parametrize("part,size,pixels", [("geo", 48, 32), ("corr", 184, 64)])
def test_k4_backward_plan_at_the_main_shapes(part, size, pixels):
    """IGEV's training step (2 levels, radius 4, C 8, bf16): an int4 and a
    g slot a (pixel, level), C*9 or 9 fp32 with 16 bytes to start anywhere,
    then the widest level's span of the tile; four blocks an SM."""
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import bwd_plan, bwd_smem_bytes

    per = 8 if part == "geo" else 1

    def smem(p):
        return 2 * p * 16 + 2 * p * (_r16(per * 9 * 4) + 16) + _r16(p * size * per * 2)

    assert bwd_plan(2, 4, 8, part, size, 2) == (pixels, smem(pixels))
    assert smem(pixels) <= 232_448 // 4 < (smem(2 * pixels) if pixels < 64 else 10**9)
    assert bwd_smem_bytes(2, 4, 8, part, pixels, size, 2) == smem(pixels)


def test_k4_plans_past_the_former_caps_and_their_limits():
    """5 levels at radius 12 fit (the kernels once stopped at 4 and 8); the
    forward's staging is 256 threads x (2r+1) floats beside 24 bytes a
    level; past 232,448 B, or past 32 levels, the plans raise."""
    from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import MAX_SMEM, bwd_plan, fwd_smem_bytes

    assert fwd_smem_bytes(2, 4) == 2 * 24 + 256 * 9 * 4
    assert fwd_smem_bytes(5, 12) == 5 * 24 + 256 * 25 * 4 <= MAX_SMEM
    for part in ("geo", "corr"):
        pixels, nbytes = bwd_plan(5, 12, 8, part, 48, 2)
        assert pixels in (64, 32, 16, 8) and nbytes <= MAX_SMEM
        with pytest.raises(ValueError, match="232448 B a block has"):
            bwd_plan(2, 5000, 8, part, 48, 2)
        with pytest.raises(ValueError, match=r"1\.\.32 levels"):
            bwd_plan(33, 4, 8, part, 48, 2)
