"""Port encoders and update block vs the JAX modules, with weights carried
across by ``state_dict_from_flax``. fp32 on both sides.

Tolerances: 1e-4 relative to the output scale for the encoders (instance-
norm statistics and three stages of 3x3 convs summed in another order),
1e-5 for the update block (shallower, no statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.nn.blocks import BasicEncoder as JBasicEncoder
from dkt_stereo_tpu.nn.blocks import MultiBasicEncoder as JMultiBasicEncoder
from dkt_stereo_tpu.nn.gru import BasicMultiUpdateBlock as JUpdateBlock
from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder, MultiBasicEncoder
from dkt_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from dkt_stereo_tpu_torch.weights import state_dict_from_flax


def _numpy_tree(v):
    return jax.tree_util.tree_map(np.asarray, {k: dict(x) for k, x in v.items()})


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _close(got, want, rel):
    got = got.detach().permute(0, 2, 3, 1).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - np.asarray(want)).max()) <= rel * scale


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).standard_normal((2, 24, 40, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def fnet_jax(images):
    m = JBasicEncoder(256, "instance", 2, dtype=jnp.float32)
    x = jnp.asarray(images)
    v = m.init(jax.random.PRNGKey(0), x)
    return _numpy_tree(v), np.asarray(m.apply(v, x))


@pytest.mark.parametrize("fused", [False, True])
def test_basic_encoder_matches_jax(images, fnet_jax, fused):
    """Both port paths against the JAX XLA encoder (which the JAX package's
    own tests hold equal to its fused Pallas path); one parameter set."""
    variables, want = fnet_jax
    m = BasicEncoder(256, "instance", 2, fused_fullres=fused)
    m.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        _close(m(_nchw(images)), want, 1e-4)


def test_multi_basic_encoder_batchnorm_matches_jax(images):
    """The cnet of pallas.json: eval-mode BatchNorm with random running
    statistics and affines (so the BN actually acts), three scales, two
    heads each."""
    dims = ((128, 128, 128), (128, 128, 128))
    m = JMultiBasicEncoder(dims, "batch", 2, 3, dtype=jnp.float32)
    x = jnp.asarray(images[:1])
    v = _numpy_tree(m.init(jax.random.PRNGKey(1), x))
    rng = np.random.default_rng(1)

    def jitter(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(jitter, v)
    want = m.apply(v, x)
    port = MultiBasicEncoder(dims, "batch", 2, 3).eval()
    port.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got = port(_nchw(images[:1]))
    assert len(got) == len(want) == 3
    for g_scale, w_scale in zip(got, want):
        for g, w in zip(g_scale, w_scale):
            _close(g, np.asarray(w), 1e-4)


@pytest.mark.parametrize("with_mask", [True, False])
def test_update_block_matches_jax(with_mask):
    rng = np.random.default_rng(2)
    B, H, W = 1, 8, 16
    shapes = [(B, H, W, 128), (B, H // 2, W // 2, 128), (B, H // 4, W // 4, 128)]
    net = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    inp = [[rng.standard_normal(s).astype(np.float32) * 0.5 for _ in range(3)] for s in shapes]
    corr = rng.standard_normal((B, H, W, 36)).astype(np.float32)
    flow = np.concatenate([rng.standard_normal((B, H, W, 1)) * 3, np.zeros((B, H, W, 1))], -1)
    flow = flow.astype(np.float32)

    jm = JUpdateBlock(3, 2, (128, 128, 128), jnp.float32)
    jargs = (tuple(map(jnp.asarray, net)), tuple(tuple(map(jnp.asarray, t)) for t in inp),
             jnp.asarray(corr), jnp.asarray(flow))
    v = jm.init(jax.random.PRNGKey(2), *jargs)
    jnet, jmask, jdelta = jm.apply(v, *jargs, mask_pred=None if with_mask else False)

    # the JAX tree nests the block under the model's scan step: re-root it
    sd = state_dict_from_flax({"params": {"step": {"update_block": _numpy_tree(v)["params"]}}})
    port = BasicMultiUpdateBlock(3, 2, (128, 128, 128), 4, 4)
    port.load_state_dict({k.removeprefix("update_block."): t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        pnet, pmask, pdelta = port(
            [_nchw(n) for n in net], [[_nchw(t) for t in s] for s in inp],
            _nchw(corr), _nchw(flow), with_mask=with_mask,
        )
    for g, w in zip(pnet, jnet):
        _close(g, np.asarray(w), 1e-5)
    _close(pdelta, np.asarray(jdelta), 1e-5)
    if with_mask:
        _close(pmask, np.asarray(jmask), 1e-5)
    else:
        assert pmask is None
