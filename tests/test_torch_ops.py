"""Port ops (dkt_stereo_tpu_torch.ops / nn.norms) vs the JAX package's.

Inputs come from a seeded numpy generator and go to both sides. fp32 ops
agree to 1e-5 max-abs (same arithmetic, reordered sums); the matmul-built
correlation pyramid to 1e-4 (a 16..64-term dot product per entry, summed
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.nn.norms import InstanceNorm as JInstanceNorm
from dkt_stereo_tpu.ops import corr as jcorr
from dkt_stereo_tpu.ops import pad as jpad
from dkt_stereo_tpu.ops import resize as jresize
from dkt_stereo_tpu.ops import sampler as jsampler
from dkt_stereo_tpu.ops import upsample as jupsample
from dkt_stereo_tpu.ops.pallas import encoder_conv as jenc
from dkt_stereo_tpu_torch.nn.norms import InstanceNorm
from dkt_stereo_tpu_torch.ops import corr, pad, resize, sampler, upsample
from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import in_affine


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("hw", [(30, 61), (32, 64), (5, 9)])
def test_pad_roundtrip_matches_jax(rng, mode, hw):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want, spec_j = jpad.pad_input(jnp.asarray(x), 8, mode)
    got, spec = pad.pad_input(_t(x), 8, mode)
    assert spec == spec_j == jpad.pad_dims(*hw, 8, mode) == pad.pad_dims(*hw, 8, mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pad.unpad_input(got, spec).numpy(), x)


def test_sample_row_1d_and_coords_grid_match_jax(rng):
    rows = rng.standard_normal((2, 3, 16)).astype(np.float32)
    x = rng.uniform(-3, 19, (2, 3, 40)).astype(np.float32)
    # zero-padding edge cases: (-1, 0], exact integers, the last index, past it
    x[0, 0, :8] = [-1.0, -0.5, -1e-7, 0.0, 7.0, 15.0, 15.25, 16.0]
    x[1, 2, :3] = [-1e9, 1e9, 3e6]
    want = np.asarray(jsampler.sample_row_1d(jnp.asarray(rows), jnp.asarray(x)))
    np.testing.assert_allclose(sampler.sample_row_1d(_t(rows), _t(x)).numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(
        sampler.coords_grid_x(2, 3, 5).numpy(), np.asarray(jsampler.coords_grid_x(2, 3, 5))
    )


@pytest.mark.parametrize("out_hw", [(8, 12), (3, 5), (4, 6)])
def test_interp_bilinear_align_matches_jax(rng, out_hw):
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    want = np.asarray(jresize.interp_bilinear_align(jnp.asarray(x), out_hw))
    got = _nhwc(resize.interp_bilinear_align(_nchw(x), out_hw))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_pool2x_matches_jax(rng, hw):
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(jresize.pool2x(jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(resize.pool2x(_nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("w", [32, 29])
def test_corr_pyramid_and_lookup_match_jax(rng, w):
    """Odd trailing widths drop the last column at every level."""
    f1 = rng.standard_normal((1, 4, w, 16)).astype(np.float32)
    f2 = rng.standard_normal((1, 4, w, 16)).astype(np.float32)
    for a, b in zip(jcorr.fmap_pyramid(jnp.asarray(f2), 4), corr.fmap_pyramid(_t(f2), 4)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    want = jcorr.corr_pyramid_fused(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = corr.corr_pyramid_fused(_t(f1), _t(f2), 4)
    assert [g.shape[-1] for g in got] == [v.shape[-1] for v in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)

    coords = rng.uniform(-6, w + 6, (1, 4, w, 1)).astype(np.float32)
    lw = np.asarray(jcorr.corr_lookup(list(want), jnp.asarray(coords), 4))
    lg = corr.corr_lookup([_t(np.asarray(a)) for a in want], _t(coords), 4)
    np.testing.assert_allclose(lg.numpy(), lw, atol=1e-5)


def test_corr_pyramid_bf16_storage(rng):
    """bf16 features and storage: products still accumulate in fp32, so the
    only difference from JAX is the final rounding of each entry."""
    f1 = rng.standard_normal((1, 4, 16, 32)).astype(np.float32)
    f2 = rng.standard_normal((1, 4, 16, 32)).astype(np.float32)
    j1, j2 = jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16)
    t1, t2 = _t(f1).bfloat16(), _t(f2).bfloat16()
    want = jcorr.corr_pyramid_fused(j1, j2, 4, out_dtype=jnp.bfloat16)
    got = corr.corr_pyramid_fused(t1, t2, 4, out_dtype=torch.bfloat16)
    for a, b in zip(want, got):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a.astype(jnp.float32))
        # one bf16 rounding step of the stored value (2^-8 relative)
        np.testing.assert_allclose(b.float().numpy(), a, atol=2 ** -8 * np.abs(a).max())


def test_convex_upsample_matches_jax(rng):
    B, H, W, f = 2, 4, 6, 4
    flow = rng.standard_normal((B, H, W, 1)).astype(np.float32) * 5
    mask = rng.standard_normal((B, H, W, 9 * f * f)).astype(np.float32)
    want = np.asarray(jupsample.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), f))
    got = _nhwc(upsample.convex_upsample(_nchw(flow), _nchw(mask), f))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_instance_norm_matches_jax(rng):
    x = (rng.standard_normal((2, 6, 10, 8)) * 3 + 1).astype(np.float32)
    want = np.asarray(JInstanceNorm().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(InstanceNorm()(_nchw(x))), want, atol=1e-5)
    # bf16: single-pass fp32 statistics, bf16 elementwise math on both sides
    want = np.asarray(JInstanceNorm().apply({}, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = _nhwc(InstanceNorm()(_nchw(x).bfloat16()).float())
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_instance_norm_bf16_clamps_negative_variance():
    """A constant plane has E[x^2] - mean^2 <= 0 up to rounding; the port
    clamps the variance at 0 (a deliberate divergence from the JAX form,
    which can give NaN there) and returns finite zeros."""
    x = torch.full((1, 3, 5, 7), 3.3, dtype=torch.bfloat16)
    out = InstanceNorm()(x)
    assert torch.isfinite(out).all() and out.abs().max() == 0


def test_in_affine_matches_jax(rng):
    s = rng.standard_normal((2, 8)).astype(np.float32) * 50
    ss = (s**2 / 100 + rng.uniform(1, 5, (2, 8))).astype(np.float32) * 100
    # JAX takes w2d sums: per logical channel = sum of the two phases
    aj, bj = jenc.in_affine(
        jnp.asarray(np.concatenate([s / 2, s / 2], -1)),
        jnp.asarray(np.concatenate([ss / 2, ss / 2], -1)), 100.0,
    )
    a, b = in_affine(_t(s), _t(ss), 100.0)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj)[:, :8], rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj)[:, :8], rtol=1e-5, atol=1e-6)
