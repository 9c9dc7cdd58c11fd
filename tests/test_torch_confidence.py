"""The confidence tools (``dkt/confidence.py``) against the JAX package's on
the CPU: Gaussian-window SSIM, the reprojection error on the shared
disparity warp, left-right uniqueness and neighbourhood agreement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.dkt import confidence as jconf
from dkt_stereo_tpu_torch.dkt import confidence as conf


def _pair(rng, B=2, H=24, W=40):
    return tuple(rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))


def test_gaussian_window_and_ssim_match_jax():
    """The window is JAX's array; the SSIM map (a depthwise 11x11 conv with
    zero padding) within 1e-5 of JAX's, and 1 for an image against
    itself."""
    assert np.array_equal(conf.gaussian_window(), jconf.gaussian_window())
    assert np.array_equal(conf.gaussian_window(7, 2.0), jconf.gaussian_window(7, 2.0))
    a, b = _pair(np.random.default_rng(0))
    got = conf.ssim_gaussian(torch.tensor(a), torch.tensor(b))
    want = np.asarray(jconf.ssim_gaussian(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == a.shape
    assert float((got - torch.tensor(want)).abs().max()) <= 1e-5
    same = conf.ssim_gaussian(torch.tensor(a), torch.tensor(a))
    assert float((same - 1).abs().max()) <= 1e-4


@pytest.mark.parametrize("with_disp", [True, False])
def test_reprojection_error_matches_jax(with_disp):
    """Per pixel (B, H, W), with a negative disparity and a valid mask, or
    neither (the unwarped pair): within 1e-5 of JAX's."""
    rng = np.random.default_rng(1)
    a, b = _pair(rng)
    args = [torch.tensor(a), torch.tensor(b)]
    jargs = [jnp.asarray(a), jnp.asarray(b)]
    if with_disp:
        disp = -rng.uniform(0, 10, (2, 24, 40, 1)).astype(np.float32)
        mask = (rng.uniform(0, 1, (2, 24, 40, 1)) > 0.2).astype(np.float32)
        args += [torch.tensor(disp), torch.tensor(mask)]
        jargs += [jnp.asarray(disp), jnp.asarray(mask)]
    got = conf.reprojection_error(*args)
    want = np.asarray(jconf.reprojection_error(*jargs))
    assert got.shape == want.shape == (2, 24, 40)
    assert float((got - torch.tensor(want)).abs().max()) <= 1e-5


@pytest.mark.parametrize("low, high", [(0, 30), (-40, 60), (0, 4)])
def test_uniqueness_and_agreement_match_jax(low, high):
    """Equal to JAX's, value for value: disparities past the image's width
    and negative ones land on slots JAX's scatter wraps or drops, and few
    distinct values make many pixels share a landing position."""
    d = np.random.default_rng(2).uniform(low, high, (2, 12, 20)).astype(np.float32)
    got = conf.uniqueness(torch.tensor(d))
    want = np.asarray(jconf.uniqueness(jnp.asarray(d)))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert 0 < float(got.mean()) < 1
    for r, tau in ((1, 1.0), (2, 3.0)):
        got = conf.agreement(torch.tensor(d), r, tau)
        assert np.array_equal(got.numpy(), np.asarray(jconf.agreement(jnp.asarray(d), r, tau)))
