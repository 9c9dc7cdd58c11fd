"""IGEV's ops in the port vs the JAX package's: K4's plain twin (the CPU
path of ``ops/cuda/geo_lookup.py``) against the Pallas ``geo_lookup_pallas``
in interpret mode and the XLA ``geo_lookup``; the combined volume's
pyramids; the GWC volume, the soft-argmin, the context upsampling, the
nearest resize and the unscaled init correlation.

Inputs come from a seeded numpy generator and go to both sides, fp32.
K4's bound is 1e-5 max-abs: the same taps and weights on the same values.
The Pallas kernel's bf16x2 split of its selector matmuls (``_dot_f32``,
geo_lookup.py:59-71) costs ~2^-18 relative on the TPU's MXU; on the CPU the
dots run in fp32, and the kernel's own distance to the XLA lookup is
checked to sit inside the same bound first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.ops import corr as jcorr
from dkt_stereo_tpu.ops import geometry as jgeo
from dkt_stereo_tpu.ops import resize as jresize
from dkt_stereo_tpu.ops import upsample as jupsample
from dkt_stereo_tpu.ops import volumes as jvolumes
from dkt_stereo_tpu.ops.pallas.geo_lookup import geo_lookup_pallas
from dkt_stereo_tpu_torch.ops import corr, resize, upsample, volumes
from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import geo_lookup
from dkt_stereo_tpu_torch.ops.geometry import CombinedGeoEncodingVolume


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _geo_inputs(rng, B=1, H=4, W=24, D=12, C=8, levels=2):
    """Random pyramids (geo level i: D >> i slots; corr level i: W >> i
    columns) and disparities in range, negative, above D, far out of range,
    at exact integers and at the edges of the zero padding."""
    geo = [(4 * rng.standard_normal((B, H, W, D >> i, C))).astype(np.float32)
           for i in range(levels)]
    cor = [(4 * rng.standard_normal((B, H, W, W >> i))).astype(np.float32) for i in range(levels)]
    disp = rng.uniform(-6, D + 6, (B, H, W, 1)).astype(np.float32)
    disp.reshape(-1)[:10] = [-1e9, 1e9, -3.0, -0.5, 0.0, 5.0, D - 1.0, D + 0.25, 2.5e4, -7e3]
    coords = np.broadcast_to(np.arange(W, dtype=np.float32)[None, None, :, None],
                             (B, H, W, 1)).copy()
    return geo, cor, disp, coords


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geo_lookup_plain_matches_pallas_and_xla(rng, dtype):
    """The plain twin against the Pallas kernel (interpret mode) and the XLA
    lookup, on the same (possibly bf16-rounded) volume values: 1e-5. The
    Pallas kernel is first held to the XLA lookup at the same bound."""
    geo, cor, disp, coords = _geo_inputs(rng)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jg, jc = tuple(jnp.asarray(v, jdt) for v in geo), tuple(jnp.asarray(v, jdt) for v in cor)
    pallas = np.asarray(geo_lookup_pallas(jg, jc, jnp.asarray(disp), jnp.asarray(coords), 4, True))
    xla = np.asarray(jgeo.geo_lookup(list(jg), list(jc), jnp.asarray(disp), jnp.asarray(coords), 4))
    assert pallas.shape == (1, 4, 24, 2 * 9 * 9)
    assert float(np.abs(pallas - xla).max()) <= 1e-5
    got = geo_lookup([_t(v).to(tdt) for v in geo], [_t(v).to(tdt) for v in cor], _t(disp),
                     _t(coords), 4)
    assert got.dtype == torch.float32 and got.shape == pallas.shape
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), xla, atol=1e-5)


def test_geo_lookup_on_cpu_launches_nothing(rng):
    """CPU tensors take the plain path; other non-CUDA devices are refused."""
    geo, cor, disp, coords = _geo_inputs(rng, H=2, W=8, D=4)
    before = geo_lookup.launches
    geo_lookup([_t(v) for v in geo], [_t(v) for v in cor], _t(disp), _t(coords), 2)
    assert geo_lookup.launches == before
    meta = torch.zeros(1, 2, 8, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        geo_lookup([torch.zeros(1, 2, 8, 4, 8, device="meta")],
                   [torch.zeros(1, 2, 8, 8, device="meta")], meta, meta)


@pytest.mark.parametrize("D", [12, 11])
def test_combined_volume_pyramids_and_lookup_match_jax(rng, D):
    """The geo pyramid (pairs averaged along D, an odd last slot dropped),
    the unscaled init-corr pyramid and the lookup through them, from the
    port's (B, C, D, H, W) volume and the JAX (B, D, H, W, C) one."""
    B, H, W, C = 1, 4, 16, 8
    f1, f2 = (rng.standard_normal((B, H, W, 24)).astype(np.float32) for _ in range(2))
    vol = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    want = jgeo.CombinedGeoEncodingVolume(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(vol),
                                          num_levels=2, radius=4)
    got = CombinedGeoEncodingVolume(_t(f1), _t(f2), _t(vol).permute(0, 4, 1, 2, 3), 2, 4)
    for g, w in zip(got.geo_pyramid, want.geo_pyramid):
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    for g, w in zip(got.corr_pyramid, want.init_corr_pyramid):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    disp = rng.uniform(-2, D + 2, (B, H, W, 1)).astype(np.float32)
    coords = np.broadcast_to(np.arange(W, dtype=np.float32)[None, None, :, None], disp.shape)
    np.testing.assert_allclose(got(_t(disp), _t(coords)).numpy(),
                               np.asarray(want(jnp.asarray(disp), jnp.asarray(coords))),
                               atol=1e-4)


@pytest.mark.parametrize("scaled", [True, False])
def test_corr_pyramid_fused_scaled_option_matches_jax(rng, scaled):
    f1, f2 = (rng.standard_normal((1, 3, 16, 32)).astype(np.float32) for _ in range(2))
    want = jcorr.corr_pyramid_fused(jnp.asarray(f1), jnp.asarray(f2), 2, scaled=scaled)
    got = corr.corr_pyramid_fused(_t(f1), _t(f2), 2, scaled=scaled)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("maxdisp", [6, 20])
def test_gwc_volume_matches_jax(rng, maxdisp):
    """(B, C, H, W) features -> (B, G, D, H, W) against the JAX (B, D, H, W,
    G) volume; ``maxdisp`` beyond the width leaves zero slices."""
    f1, f2 = (rng.standard_normal((2, 5, 16, 24)).astype(np.float32) for _ in range(2))
    want = np.asarray(jvolumes.build_gwc_volume(jnp.asarray(f1), jnp.asarray(f2), maxdisp, 8))
    got = volumes.build_gwc_volume(_t(f1).permute(0, 3, 1, 2), _t(f2).permute(0, 3, 1, 2),
                                   maxdisp, 8)
    assert got.shape == (2, 8, maxdisp, 5, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-6)


def test_disparity_regression_matches_jax(rng):
    logits = rng.standard_normal((2, 3, 5, 12)).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    want = np.asarray(jvolumes.disparity_regression(jnp.asarray(prob), 12))
    got = volumes.disparity_regression(_t(prob).permute(0, 3, 1, 2), 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_context_upsample_matches_jax(rng):
    disp = rng.uniform(0, 30, (2, 5, 7, 1)).astype(np.float32)
    w = rng.random((2, 20, 28, 9)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    want = np.asarray(jupsample.context_upsample(jnp.asarray(disp), jnp.asarray(w)))
    got = upsample.context_upsample(_t(disp).permute(0, 3, 1, 2), _t(w).permute(0, 3, 1, 2))
    assert got.shape == (2, 20, 28)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(7, 9), (10, 12), (3, 4)])
def test_interp_nearest_matches_jax_and_torch(rng, out_hw):
    x = rng.standard_normal((1, 5, 6, 3)).astype(np.float32)
    want = np.asarray(jresize.interp_nearest(jnp.asarray(x), out_hw))
    got = resize.interp_nearest(_t(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    ref = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=out_hw, mode="nearest")
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
