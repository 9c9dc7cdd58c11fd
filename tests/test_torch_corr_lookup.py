"""K1's contract on the CPU: the wrapper ``ops/cuda/corr_lookup.py`` returns
the motion encoder's input, ``corr_lookup_pallas(...)`` (interpret mode)
permuted to NCHW and cast once to the compute dtype, with the strides that
``.to`` gives; its backward, through autograd and through ``CorrLookup``'s
plain backward, against ``jax.vjp`` of the same function with a bf16 or
fp32 cotangent; NaN coordinates (NaN in the same places as JAX, forward and
VJP); 5 and 6 levels and radius 12, beyond RAFT's 4 and 4; and the
kernels' shared-memory plans, which need no JAX.

The kernels themselves run only on the card (``chip_smoke.py`` phases 2
and 7 hold them against these plain versions there); on CPU tensors the
wrapper takes the plain path and launches nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from dkt_stereo_tpu_torch.ops.cuda import corr_lookup as k1
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import (
    CorrLookup, bwd_plan, corr_lookup, corr_lookup_bwd, fwd_plan)
from tests.test_torch_train import jit_vjp

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _case(levels, radius, B=1, H=4, W=32, nan=False):
    """Seeded levels (fp32, B x H x W x W/2^i), coordinates with the hostile
    values of tests/test_torch_kernels.py (far out of range, (-1, 0], exact
    integers, the last column and past it) and, with ``nan``, NaN ones, and
    a cotangent of the output's (B, H, W, C) shape."""
    rng = np.random.default_rng(levels * 100 + radius + nan)
    pyr = [rng.standard_normal((B, H, W, W >> i)).astype(np.float32) for i in range(levels)]
    coords = rng.uniform(-3 - radius, W + 3 + radius, (B, H, W, 1)).astype(np.float32)
    flat = coords.reshape(-1)
    flat[:12] = [-1e9, 1e9, -1.0, -0.75, -1e-6, 0.0, 5.0, 17.0, W - 1.0, W - 0.5, W, W + 0.25]
    if nan:
        flat[[12, 40, 77]] = np.nan
    g = rng.standard_normal((B, H, W, levels * (2 * radius + 1))).astype(np.float32)
    return pyr, coords, g


@functools.lru_cache(maxsize=None)
def _jax_vjp(case, vol, out):
    """JAX's forward for ``_case(*case)`` cast to ``out`` and NCHW, and its
    VJP for the NCHW cotangent g in ``out`` (JAX's cast VJP reads it
    exactly in fp32), the levels in ``vol``."""
    pyr, coords, g = _case(*case)
    radius, odt = case[1], DT[out][0]
    jpyr = tuple(jnp.asarray(v, DT[vol][0]) for v in pyr)

    def f(*p):
        res = corr_lookup_pallas(p, jnp.asarray(coords), radius, True)
        return res.transpose(0, 3, 1, 2).astype(odt)

    res, grads = jit_vjp(f, jpyr, jnp.asarray(g.transpose(0, 3, 1, 2)).astype(odt))
    return (np.asarray(res.astype(jnp.float32)),
            [np.asarray(d.astype(jnp.float32)) for d in grads])


@pytest.mark.parametrize("vol", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_wrapper_is_the_motion_encoders_input(vol, out):
    """View, strides and dtype of ``plain.permute(0, 3, 1, 2).to(dt)``;
    values 1e-5 from the Pallas kernel in fp32. In bf16 every value is the
    wrapper's own fp32 value rounded once (RNE) and, at this seed, bit-equal
    to JAX's fp32 value rounded once."""
    pyr, coords, _ = _case(4, 4)
    (jv, tv), (jo, to) = DT[vol], DT[out]
    want = corr_lookup_pallas(tuple(jnp.asarray(v, jv) for v in pyr), jnp.asarray(coords), 4, True)
    levels = [_t(v).to(tv) for v in pyr]
    got = corr_lookup(levels, _t(coords), 4, to)
    f32 = corr_lookup(levels, _t(coords), 4)
    ref = f32.to(to)
    assert got.dtype == to and got.shape == (1, 36, 4, 32)
    assert got.stride() == ref.stride() == (4 * 32 * 36, 1, 32 * 36, 36)
    assert got.permute(0, 2, 3, 1).is_contiguous()
    np.testing.assert_allclose(f32.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, ref)
    if out == "bfloat16":
        jwant = np.asarray(want.transpose(0, 3, 1, 2).astype(jo).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), jwant)


@pytest.mark.parametrize("vol", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["autograd", "function"])
def test_backward_matches_jax_vjp(vol, out, route):
    """d/dvolume through the wrapper (autograd of the plain path) and
    through ``CorrLookup`` (its plain backward), with a cotangent in the
    output's dtype as autograd hands it back, against ``jax.vjp``: fp32
    1e-6, bf16 levels one bf16 step of the level's scale. The coordinates
    get no gradient."""
    pyr, coords, g = _case(4, 4)
    (jv, tv), (jo, to) = DT[vol], DT[out]
    _, want = _jax_vjp((4, 4), vol, out)
    levels = [_t(v).to(tv).requires_grad_(True) for v in pyr]
    # the model detaches its coordinates; CorrLookup gives them no gradient
    # even where they require one
    c = _t(coords).requires_grad_(route == "function")
    if route == "autograd":
        res = corr_lookup(levels, c, 4, to)
    else:
        res = CorrLookup.apply(c, 4, to, *levels)
    assert res.dtype == to and res.shape == (1, 36, 4, 32)
    copies = corr_lookup_bwd.g_copies
    # a channels-last cotangent, as cuDNN hands it back for this input
    res.backward(_t(g).to(to).permute(0, 3, 1, 2))
    assert corr_lookup_bwd.g_copies == copies
    assert c.grad is None
    assert [v.grad.dtype for v in levels] == [tv] * 4
    # bf16 levels: CorrLookup rounds fp32 sums once, as JAX does (one step
    # where the sums differ in their last fp32 bit); autograd of the plain
    # path scatter-adds the two weights of a column into the bf16 gradient,
    # rounding twice
    steps = {"float32": 0, "bfloat16": 1 if route == "function" else 2}[vol]
    for d, w in zip(levels, want):
        tol = 1e-6 if vol == "float32" else steps * 2**-8 * float(np.abs(w).max())
        np.testing.assert_allclose(d.grad.float().numpy(), w, atol=tol, rtol=0)


def test_function_copies_a_strided_cotangent_once():
    """An NCHW-contiguous cotangent is strided in (B, H, W, C): the
    backward makes it dense once and counts it."""
    pyr, coords, g = _case(4, 4)
    levels = [_t(v).requires_grad_(True) for v in pyr]
    copies = corr_lookup_bwd.g_copies
    CorrLookup.apply(_t(coords), 4, torch.float32, *levels).backward(
        _t(g).permute(0, 3, 1, 2).contiguous())
    assert corr_lookup_bwd.g_copies == copies + 1
    _, want = _jax_vjp((4, 4), "float32", "float32")
    for d, w in zip(levels, want):
        np.testing.assert_allclose(d.grad.numpy(), w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_nan_coordinates_match_jax(out):
    """A NaN coordinate gives NaN in its 2r+1 outputs of every level and a
    NaN d/dvolume row in every level, exactly where JAX has them; the other
    values agree as in the tests above."""
    pyr, coords, g = _case(4, 4, 1, 4, 32, True)
    to = DT[out][1]
    jout, want = _jax_vjp((4, 4, 1, 4, 32, True), "float32", out)
    levels = [_t(v).requires_grad_(True) for v in pyr]
    res = CorrLookup.apply(_t(coords), 4, to, *levels)
    res.backward(_t(g).to(to).permute(0, 3, 1, 2))
    got = res.detach().float().numpy()
    nan_pix = np.isnan(coords[..., 0])
    assert nan_pix.sum() == 3
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jout))
    assert np.isnan(got.transpose(0, 2, 3, 1)[nan_pix]).all()
    assert not np.isnan(got.transpose(0, 2, 3, 1)[~nan_pix]).any()
    # bf16: one rounding each of fp32 values 1e-5 apart, one bf16 step
    np.testing.assert_allclose(got, jout, atol=1e-5, rtol=0 if out == "float32" else 2**-8)
    for d, w in zip(levels, want):
        d = d.grad.numpy()
        np.testing.assert_array_equal(np.isnan(d), np.isnan(w))
        assert np.isnan(d[nan_pix]).all() and not np.isnan(d[~nan_pix]).any()
        np.testing.assert_allclose(d, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("levels,radius", [(5, 12), (6, 12), (6, 4)])
def test_more_levels_and_a_larger_radius_match_jax(levels, radius):
    """More levels and a larger radius than RAFT's: forward 1e-5 and
    VJP 1e-6 against the Pallas kernel, fp32, at 1x2x64."""
    case = (levels, radius, 1, 2, 64)
    pyr, coords, g = _case(*case)
    jout, want = _jax_vjp(case, "float32", "float32")
    lv = [_t(v).requires_grad_(True) for v in pyr]
    res = CorrLookup.apply(_t(coords), radius, torch.float32, *lv)
    assert res.shape == (1, levels * (2 * radius + 1), 2, 64)
    np.testing.assert_allclose(res.detach().numpy(), jout, atol=1e-5)
    res.backward(_t(g).permute(0, 3, 1, 2))
    for d, w in zip(lv, want):
        np.testing.assert_allclose(d.grad.numpy(), w, atol=1e-6, rtol=0)


def test_wrapper_refuses_other_dtypes_and_devices():
    pyr, coords, _ = _case(4, 4)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        corr_lookup([_t(v) for v in pyr], _t(coords), 4, torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        corr_lookup([torch.zeros(1, 2, 8, 8, device="meta")],
                    torch.zeros(1, 2, 8, 1, device="meta"))


# --- the kernels' shared-memory plans (no JAX) --------------------------------


@pytest.mark.parametrize("vol,out,want", [
    # 256 items: 16 B of metadata, a slot of 48 B (bf16) or 64 B (fp32) each,
    # then 64 pixels x 36 outputs
    (2, 2, (64, 256 * 16 + 256 * 48 + 64 * 36 * 2)),
    (4, 4, (64, 256 * 16 + 256 * 64 + 64 * 36 * 4)),
    (4, 2, (64, 256 * 16 + 256 * 64 + 64 * 36 * 2)),
    (2, 4, (64, 256 * 16 + 256 * 48 + 64 * 36 * 4)),
])
def test_forward_plan_at_the_main_shapes(vol, out, want):
    """4 levels, radius 4 (RAFT's frame and step): 64 pixels a block."""
    assert fwd_plan(4, 4, vol, out) == want
    assert want[1] <= 48 * 1024  # no opt-in to large shared memory


def test_backward_plan_at_the_main_shapes():
    """64 pixels x 36 g values, 256 windows of 11 floats, 256 int2."""
    assert bwd_plan(4, 4) == (64, 64 * 36 * 4 + 256 * 11 * 4 + 256 * 8)


@pytest.mark.parametrize("levels,radius,vol,out", [
    (5, 12, 2, 2), (5, 12, 4, 4), (6, 12, 4, 4), (32, 4, 4, 4), (4, 60, 4, 4), (1, 200, 4, 4)])
def test_plans_shrink_blocks_to_fit_shared_memory(levels, radius, vol, out):
    """Past the main shapes a block owns fewer pixels (a multiple of 8, so
    every span stays 16-byte aligned) and its staging fits 232,448 B."""
    for (pixels, smem), fn in ((fwd_plan(levels, radius, vol, out), k1.fwd_smem_bytes),
                               (bwd_plan(levels, radius), k1.bwd_smem_bytes)):
        assert pixels in (64, 32, 16, 8) and smem <= k1.MAX_SMEM
        args = (levels, radius, vol, out) if fn is k1.fwd_smem_bytes else (levels, radius)
        assert smem == fn(*args, pixels)
        if pixels < 64:
            assert fn(*args, 2 * pixels) > k1.MAX_SMEM


@pytest.mark.parametrize("levels,radius,match", [
    (33, 4, r"1\.\.32 levels"), (0, 4, r"1\.\.32 levels"), (4, -1, "radius"),
    (4, 1000, "232448 B a block has")])
def test_plans_name_their_limits(levels, radius, match):
    with pytest.raises(ValueError, match=match):
        fwd_plan(levels, radius, 4, 4)
    with pytest.raises(ValueError, match=match):
        bwd_plan(levels, radius)
