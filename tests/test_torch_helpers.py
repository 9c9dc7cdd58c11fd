"""The port's exported helpers vs the JAX package's: ``bilinear_sampler``,
``upflow``, ``pool4x``, ``gauss_blur``, ``forward_interpolate``,
``BottleneckBlock``, ``SepConvGRU`` and ``register_model``.

Inputs and weights are seeded numpy draws fed to both sides; the modules'
weights cross through ``state_dict_from_flax`` and load strictly. fp32
outputs agree within 1e-5 of their scale (the same arithmetic, sums in
another order); masks, pooling windows and the host-side
``forward_interpolate`` agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dkt_stereo_tpu.nn as jnn
import dkt_stereo_tpu.ops as jops
from dkt_stereo_tpu.nn.blocks import BottleneckBlock as JBottleneckBlock
from dkt_stereo_tpu.nn.gru import SepConvGRU as JSepConvGRU
from dkt_stereo_tpu.ops import misc as jmisc
from dkt_stereo_tpu.ops import resize as jresize
from dkt_stereo_tpu.ops import sampler as jsampler
import dkt_stereo_tpu_torch.nn as tnn
import dkt_stereo_tpu_torch.ops as tops
from dkt_stereo_tpu_torch.models import registry
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.nn.blocks import BottleneckBlock
from dkt_stereo_tpu_torch.nn.gru import SepConvGRU
from dkt_stereo_tpu_torch.ops import misc, resize, sampler
from dkt_stereo_tpu_torch.weights import state_dict_from_flax


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _close(got, want, rel=1e-5):
    """``got`` (NCHW torch) within ``rel`` of max|want| of ``want`` (NHWC)."""
    got = got.detach().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _draw(module, rng, *inputs):
    """Seeded variables in the shapes of ``module.init``: He-normal
    kernels, N(0, 0.05) biases, U(0.8, 1.2) scales, running means N(0, 0.1)
    and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_out = int(np.prod(shape[:-2])) * shape[-1]
            return (np.sqrt(2.0 / fan_out) * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            lo, hi = (0.8, 1.2) if name == "scale" else (0.5, 1.5)
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return ((0.1 if name == "mean" else 0.05) * rng.standard_normal(shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {k: dict(v) for k, v in tree.items()}


# --- ops ----------------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(9, 14), (1, 12), (7, 1)])
def test_bilinear_sampler_matches_jax(rng, hw):
    """Out-of-bounds taps read zero, as JAX's gather form and the
    reference's ``grid_sample`` do; the mask is equal, also for an image one
    row high (the reference leaves y unnormalised there) and one column
    wide (sampled as pixels, where the reference divides by 0)."""
    H, W = hw
    img = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    coords = np.stack([rng.uniform(-2.5, W + 1.5, (2, 6, 8)),
                       rng.uniform(-2.5, H + 1.5, (2, 6, 8))], -1).astype(np.float32)
    coords[0, 0, :6] = [[-1, 0], [0, 0], [W - 1, H - 1], [W - 0.5, 0], [-0.25, H - 1], [3, 0.5]]
    want, want_mask = jsampler.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords), mask=True)
    got, got_mask = sampler.bilinear_sampler(_nchw(img), torch.tensor(coords), mask=True)
    _close(got, want)
    assert got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    _close(tops.bilinear_sampler(_nchw(img), torch.tensor(coords)), want)


def test_upflow_and_pool4x_match_jax(rng):
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    for factor in (8, 4):
        _close(resize.upflow(_nchw(flow), factor), jresize.upflow(jnp.asarray(flow), factor))
    for hw in ((23, 37), (8, 8), (5, 6)):
        x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        _close(resize.pool4x(_nchw(x)), jresize.pool4x(jnp.asarray(x)))


@pytest.mark.parametrize("n,std", [(5, 1.0), (3, 0.5), (7, 2.0)])
def test_gauss_blur_matches_jax(rng, n, std):
    x = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    _close(misc.gauss_blur(_nchw(x), n, std), jmisc.gauss_blur(jnp.asarray(x), n, std))


def test_forward_interpolate_matches_jax(rng):
    """Host numpy on both sides: equal arrays, with flow that leaves the
    image in places."""
    flow = rng.uniform(-6, 6, (2, 11, 15)).astype(np.float32)
    got = misc.forward_interpolate(flow)
    assert got.dtype == np.float32 and got.shape == flow.shape
    np.testing.assert_array_equal(got, jmisc.forward_interpolate(flow))


def test_package_exports_match_jax():
    """Every name the JAX ``ops`` and ``nn`` packages export, and
    ``pool4x``, is exported by the port's, imported at first use."""
    jax_ops = {n for n in vars(jops) if not n.startswith("_") and callable(getattr(jops, n))
               and getattr(getattr(jops, n), "__module__", "").startswith("dkt_stereo_tpu.ops")}
    jax_nn = {n for n in vars(jnn) if not n.startswith("_") and isinstance(getattr(jnn, n), type)}
    assert jax_ops | {"pool4x"} == set(tops.__all__)
    assert jax_nn == set(tnn.__all__)
    for n in tops.__all__:
        assert callable(getattr(tops, n)), n
    assert tnn.BottleneckBlock is BottleneckBlock and tnn.SepConvGRU is SepConvGRU
    with pytest.raises(AttributeError):
        tops.no_such_op


# --- modules ------------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm_fn", ["group", "batch", "instance", "none"])
def test_bottleneck_block_matches_jax(norm_fn, stride):
    """Each norm, with and without the strided downsample: group norms over
    ``planes // 4`` channels take ``planes // 8`` groups, and the
    downsample's norm is ``norm4`` (``downsample.1``), not the third conv's
    ``norm3``."""
    rng = np.random.default_rng(10 * stride + len(norm_fn))
    cin = 32 if stride == 1 else 16
    x = rng.standard_normal((2, 12, 18, cin)).astype(np.float32)
    m = JBottleneckBlock(cin, 32, norm_fn, stride)
    variables = _draw(m, rng, jnp.asarray(x))
    want = m.apply(variables, jnp.asarray(x))
    port = BottleneckBlock(cin, 32, norm_fn, stride)
    sd = state_dict_from_flax(variables)
    port.load_state_dict(sd, strict=True)
    if norm_fn == "group":
        assert [port.norm1.num_groups, port.norm3.num_groups] == [4, 4]
    if stride == 2 and norm_fn in ("group", "batch"):
        assert torch.equal(sd["downsample.1.weight"], sd["norm4.weight"])
        assert not torch.equal(sd["norm3.weight"], sd["norm4.weight"])
    with torch.no_grad():
        _close(port(_nchw(x)), want)


def test_sep_conv_gru_matches_jax(rng):
    h = np.tanh(rng.standard_normal((2, 9, 13, 16))).astype(np.float32)
    xs = [rng.standard_normal((2, 9, 13, c)).astype(np.float32) for c in (8, 4)]
    m = JSepConvGRU(hidden_dim=16)
    variables = _draw(m, rng, *(jnp.asarray(a) for a in [h] + xs))
    want = m.apply(variables, *(jnp.asarray(a) for a in [h] + xs))
    port = SepConvGRU(16, 12)
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert port.convq2.weight.shape == (16, 28, 5, 1)
    with torch.no_grad():
        _close(port(_nchw(h), *(_nchw(a) for a in xs)), want)


@pytest.mark.parametrize("module", ["bottleneck", "sepconvgru"])
def test_new_modules_round_trip_reference_state_dicts(module):
    """A state dict under the reference's torch names (the module's own,
    both ``norm4`` and ``downsample.1`` for the bottleneck) loads strictly
    into a fresh module, which then computes the same; the JAX tree's keys
    are the same set."""
    torch.manual_seed(0)
    if module == "bottleneck":
        make = lambda: BottleneckBlock(16, 32, "batch", 2)  # noqa: E731
        inputs = (torch.randn(1, 16, 10, 12),)
        jm, jin = JBottleneckBlock(16, 32, "batch", 2), (jnp.zeros((1, 10, 12, 16)),)
    else:
        make = lambda: SepConvGRU(8, 6)  # noqa: E731
        inputs = (torch.randn(1, 8, 7, 9), torch.randn(1, 6, 7, 9))
        jm, jin = JSepConvGRU(8), (jnp.zeros((1, 7, 9, 8)), jnp.zeros((1, 7, 9, 6)))
    a = make()
    with torch.no_grad():
        for p in a.parameters():
            p.normal_(0, 0.3)
        for name, buf in a.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    sd = a.state_dict()
    b = make()
    b.load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert torch.equal(a(*inputs), b(*inputs))
    jkeys = set(state_dict_from_flax(_draw(jm, np.random.default_rng(0), *jin)))
    assert jkeys == set(sd)


def test_register_model_builds_and_adapts(rng):
    """A model registered through ``register_model`` is what ``get_model``
    returns and ``create_model`` builds; ``make_loss_adapter`` takes its
    loss, by the reference's name where it is one of the port's losses."""

    class TinyConfig:
        @classmethod
        def from_dict(cls, d):
            c = cls()
            c.width = d["width"]
            return c

    class Tiny(torch.nn.Module):
        def __init__(self, cfg, iters=32, test_mode=True):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, cfg.width, 3, padding=1)

    calls = []

    def tiny_loss(out, gt, valid):
        calls.append(out)
        return torch.zeros(()), {}, valid, True

    try:
        assert registry.register_model("Tiny", Tiny, TinyConfig, tiny_loss) is Tiny
        assert registry.get_model("Tiny") == (Tiny, TinyConfig)
        model = registry.create_model({"model": "Tiny", "width": 5}, device="cpu", seed=3)
        assert isinstance(model, Tiny) and model.conv.out_channels == 5 and not model.training
        assert model.conv.weight.std() > 0 and torch.all(model.conv.bias == 0)
        registry.make_loss_adapter("Tiny")("out", None, None)
        assert calls == ["out"]
        registry.register_model("TinyRAFT", RAFTStereo, RAFTStereoConfig,
                                registry.sequence_loss_raft)
        adapt = registry.make_loss_adapter("TinyRAFT")
        gt = torch.tensor(rng.uniform(0, 5, (1, 8, 8)).astype(np.float32))
        preds = torch.stack([gt + 0.5, gt - 0.25])
        loss, metrics, _, _ = adapt({"disp_preds": preds}, gt, torch.ones(1, 8, 8))
        want = registry.make_loss_adapter("RAFTStereo")({"disp_preds": preds}, gt,
                                                        torch.ones(1, 8, 8))[0]
        assert torch.equal(loss, want)
    finally:
        for name in ("Tiny", "TinyRAFT"):
            registry.MODELS.pop(name, None)
            registry.LOSSES.pop(name, None)
            registry.DEFAULT_LOSS.pop(name, None)
    with pytest.raises(KeyError, match="unknown model"):
        registry.get_model("Tiny")
