"""The port's PCVNet inference slice against the JAX package, on the CPU:
K5's plain twin (``ops/cuda/row_sample.py`` on CPU tensors) against the
JAX XLA Gaussian lookup and ``gaussian_corr_lookup_pallas`` in interpret
mode; the wrapper's argument checks; the pooled pyramid and the unscaled
convex upsample; each module that the forward runs, with weights carried
across by ``weights.state_dict_from_flax``; the whole test-mode model
(base.json and fast.json, fp32) through ``make_forward_fn`` / ``_run_one``
against the JAX model with ``reg`` and with ``reg_cuda``; the cascade dict
and an ``init_param`` second stage; the bf16 forward; the weight bridge;
the registry.

fp32 on both sides unless a test says otherwise. Bounds are relative to
the output's scale: 1e-4 for the lookup (the JAX package's own bound
between its XLA and Pallas samplers, tests/test_pallas_row_sample.py), the
encoder, RefineNet and the update block's outputs (batch-norm folds and
stacks of 3x3 convs summed in another order), 1e-5 for the motion encoder
and the updater. The whole model's bound is 2e-2 px, the JAX package's own bound
between its XLA and Pallas lookups after 2 iterations
(tests/test_pallas_row_sample.py:61-80): the closed-form mixture updates
amplify fp32 rounding of the lookup at a handful of pixels.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.models import PCVNet as JPCVNet
from dkt_stereo_tpu.models import PCVNetConfig as JConfig
from dkt_stereo_tpu.nn.pcv import BasicMotionEncoderPCV as JMotionEncoder
from dkt_stereo_tpu.nn.pcv import BasicMultiUpdateBlockPCV as JUpdateBlock
from dkt_stereo_tpu.nn.pcv import ParametersUpdater as JUpdater
from dkt_stereo_tpu.nn.pcv import PCVMultiBasicEncoder as JEncoder
from dkt_stereo_tpu.nn.pcv import RefineNet as JRefineNet
from dkt_stereo_tpu.nn.pcv import gaussian_corr_lookup as jgaussian_corr_lookup
from dkt_stereo_tpu.nn.pcv import gaussian_corr_lookup_pallas
from dkt_stereo_tpu.nn.pcv import gaussian_corr_pyramid as jgaussian_corr_pyramid
from dkt_stereo_tpu.ops.corr import corr_pyramid_fused as jcorr_pyramid_fused
from dkt_stereo_tpu.ops.pad import pad_input as jpad_input
from dkt_stereo_tpu.ops.pad import unpad_input as junpad
from dkt_stereo_tpu.ops.upsample import convex_upsample as jconvex_upsample
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
from dkt_stereo_tpu_torch.models.pcvnet import PCVNet, PCVNetConfig
from dkt_stereo_tpu_torch.models.registry import create_model, get_model, make_loss_adapter
from dkt_stereo_tpu_torch.nn.pcv import (
    BasicMotionEncoderPCV, BasicMultiUpdateBlockPCV, ParametersUpdater, PCVMultiBasicEncoder,
    RefineNet, gaussian_corr_lookup, gaussian_corr_pyramid, gaussian_positions)
from dkt_stereo_tpu_torch.ops.corr import corr_pyramid_fused
from dkt_stereo_tpu_torch.ops.cuda.row_sample import fold_lookup, gaussian_row_sample
from dkt_stereo_tpu_torch.ops.upsample import convex_upsample
from dkt_stereo_tpu_torch.weights import state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
BASE = load_model_config(str(ROOT / "configs/pcvnet/base.json"))
FAST = load_model_config(str(ROOT / "configs/pcvnet/fast.json"))
FP32 = {"mixed_precision": False}
ITERS = 2
G, S, L = 4, 9, 3
# image sizes whose pyramid levels are all >= 2 wide (base: 64/16/4 at the
# 1/4 grid; fast: 32/16/8 at the 1/8 grid), as tests/test_pcv_parity.py's;
# the Pallas lookup in interpret mode unrolls over the grid's rows, so the
# whole-model images are 16 high (padded to multiples of 16, not 32)
SIZES = {"base": (16, 256), "fast": (16, 256)}
PAD = 16
CONFIGS = {"base": BASE, "fast": FAST}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _numpy_tree(v):
    return jax.tree_util.tree_map(np.asarray, {k: dict(x) for k, x in v.items()})


def _randomize_norms(tree, rng):
    """Random batch-norm affines and statistics, so that the folds matter."""
    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "var"):
                d[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean" or (k == "bias" and v.ndim == 1 and "scale" in d):
                d[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
    walk(tree)
    return tree


def _load(module, variables, prefix):
    """Load a JAX sub-module's variables into the port's module: nested at
    ``prefix`` (a PCVNet scope, so the PCV name rules apply) and stripped
    of it again after the mapping (``step.FDM`` maps to ``FDM``)."""
    nested = {}
    for coll, tree in variables.items():
        for p in reversed(prefix.split(".")):
            tree = {p: tree}
        nested[coll] = tree
    sd = state_dict_from_flax(nested)
    head = prefix.replace("step.FDM", "FDM") + "."
    module.load_state_dict({k.removeprefix(head): v for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)
    return err


# ---------------------------------------------------------------- K5 and ops

def _mixture(rng, B, H, W1, W2, cf):
    """Mixture centres and widths (B, H, W1, G): realistic ones, and pixels
    whose positions are out of range, far out of range, or exact integers
    on every level (0 and W2 - 1 included)."""
    mu = rng.uniform(-8, W2 + 8, (B, H, W1, G)).astype(np.float32)
    sigma = rng.uniform(0.1, 16, (B, H, W1, G)).astype(np.float32)
    flat_mu, flat_sigma = mu.reshape(-1, G), sigma.reshape(-1, G)
    flat_mu[0], flat_sigma[0] = 0.0, 1.0  # -4..4
    flat_mu[1], flat_sigma[1] = W2 - 1.0, 1.0  # W2-5..W2+3
    flat_mu[2], flat_sigma[2] = 2.0 * cf**2, float(cf**2)  # integers on every level
    flat_mu[3], flat_sigma[3] = np.float32([-1e6, 1e6, -40.0, W2 + 40.0]), 2.0
    return mu, sigma


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_lookups(pyr, mu, sigma, cf):
    return (jgaussian_corr_lookup(list(pyr), mu, sigma, S, cf),
            gaussian_corr_lookup_pallas(tuple(pyr), mu, sigma, S, cf, interpret=True))


# interpret mode unrolls the Pallas kernel over the B*H rows of a block, so
# B*H stays small
@pytest.mark.parametrize("dtype, shape, cf, out", [
    ("float32", (2, 1, 37), 4, "float32"),  # widths 37/9/2, a level of width 2
    ("bfloat16", (2, 1, 37), 4, "bfloat16"),
    ("bfloat16", (1, 2, 40), 2, "bfloat16"),  # fast.json's factor: 40/20/10
    ("float32", (1, 2, 40), 2, "bfloat16"),  # an fp32 pyramid under mixed precision
])
def test_gaussian_lookup_matches_jax(rng, dtype, shape, cf, out):
    """K5's plain twin through the wrapper vs the JAX XLA lookup and the
    Pallas kernel (interpret mode), on the same (bf16-rounded) pyramid and
    the same fp32 mixture: the unfolded lookup within 1e-4 of the output's
    scale (the JAX package's bound between its two samplers), and the
    wrapper's folded output in ``out`` against the Pallas lookup folded and
    cast the same way: fp32 within 1e-5 of the scale, bf16 equal to the
    plain twin rounded once. The port's ``gaussian_corr_pyramid`` equals the
    JAX one bit for bit."""
    B, H, W = shape
    jdt, tdt = DTYPES[dtype]
    odt = DTYPES[out][1]
    vol = rng.standard_normal((B, H, W, W)).astype(np.float32)
    jpyr = [np.asarray(v) for v in jgaussian_corr_pyramid(jnp.asarray(vol), L, cf)]
    pyr = gaussian_corr_pyramid(_t(vol), L, cf)
    assert [v.shape[-1] for v in pyr] == [W, W // cf, W // cf**2]
    for a, b in zip(pyr, jpyr):
        np.testing.assert_array_equal(a.numpy(), b)
    mu, sigma = _mixture(rng, B, H, W, W, cf)
    want_xla, want_pallas = (np.asarray(a) for a in _jax_lookups(
        tuple(jnp.asarray(v).astype(jdt) for v in jpyr), jnp.asarray(mu), jnp.asarray(sigma), cf))
    levels = [_t(v).to(tdt) for v in jpyr]
    pos = gaussian_positions(_nchw(mu), _nchw(sigma), S)
    # the nn.pcv entry point is the unfolded lookup, in the JAX signature
    plain = gaussian_corr_lookup(levels, _nchw(mu), _nchw(sigma), S, cf).numpy()
    assert plain.shape == want_xla.shape == (B, H, W, L * G * S) and plain.dtype == np.float32
    scale = float(np.abs(want_xla).max())
    errs = [float(np.abs(plain - w).max()) for w in (want_xla, want_pallas)]
    assert max(errs) <= 1e-4 * scale
    n = gaussian_row_sample.launches
    got = gaussian_row_sample(levels, pos, cf, G, odt)
    assert gaussian_row_sample.launches == n  # the CPU path launches nothing
    assert got.shape == (B * G, L * S, H, W) and got.dtype == odt
    assert got.permute(0, 2, 3, 1).is_contiguous()  # channels-last in memory
    assert torch.equal(got, fold_lookup(_t(plain), L, G).to(odt))
    want = fold_lookup(_t(want_pallas), L, G).to(odt).float()
    err = float((got.float() - want).abs().max())
    print(f"K5 plain twin {dtype} {shape} cf {cf} -> {out}: max_abs vs XLA {errs[0]:.3e}, vs "
          f"Pallas {errs[1]:.3e}; folded vs folded Pallas {err:.3e} (scale {scale:.2f})")
    if out == "float32":
        assert err <= 1e-5 * scale
    else:  # one rounding of fp32 values that agree to 1e-5: at most one bf16 step
        assert err <= 2**-8 * float(want.abs().max())


@pytest.mark.parametrize("channels_last", [True, False])
def test_fold_lookup_is_the_motion_encoders_reshape(channels_last):
    """``fold_lookup`` puts lookup channel l*G*S + g*S + s of pixel (b, h, w)
    at channel l*S + s of image b*G + g, channels-last in memory, and
    ``unfold_lookup`` inverts it from that layout or from an NCHW copy (a
    gradient autograd may hand back)."""
    from dkt_stereo_tpu_torch.ops.cuda.row_sample import unfold_lookup

    B, H, W = 2, 3, 5
    x = torch.arange(B * H * W * L * G * S, dtype=torch.float32).reshape(B, H, W, L * G * S)
    y = fold_lookup(x, L, G)
    assert y.shape == (B * G, L * S, H, W) and y.is_contiguous(memory_format=torch.channels_last)
    if not channels_last:
        y = y.contiguous()
        assert not y.is_contiguous(memory_format=torch.channels_last)
    for b, h, w, l, g, s in ((0, 0, 0, 0, 0, 0), (1, 2, 4, 2, 3, 8), (1, 0, 3, 1, 2, 5)):
        assert y[b * G + g, l * S + s, h, w] == x[b, h, w, l * G * S + g * S + s]
    assert torch.equal(unfold_lookup(y, L, G), x)


def test_gaussian_lookup_nan_position():
    """On the CPU a NaN position gives NaN at its pixel only, as the kernel
    does; huge positions read nothing."""
    levels = [torch.randn(1, 1, 3, 16), torch.randn(1, 1, 3, 4)]
    pos = torch.full((1, 1, 3, 2), 5.5)
    pos[0, 0, 1, 0] = float("nan")
    pos[0, 0, 2] = torch.tensor([1e9, -1e9])
    out = gaussian_row_sample(levels, pos, 4, 1)  # (1, L*K, 1, 3): channel l*K + k
    assert out.shape == (1, 4, 1, 3)
    assert torch.isnan(out[0, [0, 2], 0, 1]).all() and torch.isfinite(out[0, [1, 3], 0, 1]).all()
    assert torch.isfinite(out[0, :, 0, 0]).all() and (out[0, :, 0, 2] == 0).all()


def test_wrapper_checks_arguments():
    """Power-of-two compress factors, 1..32 levels of one dtype (fp32 or
    bf16) sharing pos's leading shape and device, contiguous fp32 (B, H,
    W1, K) positions, K a multiple of gauss_num, an fp32 or bf16 output; a
    device that is neither CPU nor CUDA raises."""
    levels = [torch.zeros(1, 2, 3, 8), torch.zeros(1, 2, 3, 2)]
    pos = torch.zeros(1, 2, 3, 36)
    assert gaussian_row_sample(levels, pos, 4, 4).shape == (4, 18, 2, 3)
    for cf in (0, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            gaussian_row_sample(levels, pos, cf, 4)
    bad = {
        "pos dtype": (levels, pos.double(), 4, torch.float32),
        "pos layout": (levels, torch.zeros(1, 2, 36, 3).transpose(2, 3), 4, torch.float32),
        "pos rank": (levels, pos[0], 4, torch.float32),
        "no level": ([], pos, 4, torch.float32),
        "33 levels": (levels * 16 + levels[:1], pos, 4, torch.float32),
        "mixed dtypes": ([levels[0], levels[1].bfloat16()], pos, 4, torch.float32),
        "fp16 levels": ([v.half() for v in levels], pos, 4, torch.float32),
        "lead shape": ([levels[0], torch.zeros(1, 2, 4, 2)], pos, 4, torch.float32),
        "level layout": ([torch.zeros(1, 2, 8, 3).transpose(2, 3)], pos, 4, torch.float32),
        "gauss_num": (levels, pos, 5, torch.float32),
        "fp16 output": (levels, pos, 4, torch.float16),
    }
    for name, (lv, p, gn, dt) in bad.items():
        with pytest.raises(ValueError, match="gaussian_row_sample"):
            gaussian_row_sample(lv, p, 4, gn, dt)
            pytest.fail(name)
    with pytest.raises(ValueError, match="unsupported device"):
        gaussian_row_sample([v.to("meta") for v in levels], pos.to("meta"), 4, 4)


@pytest.mark.parametrize("pool_factor", [2, 4])
def test_corr_pyramid_fused_pool_factor_matches_jax(rng, pool_factor):
    """``corr_pyramid_fused(pool_factor=f)`` vs the JAX one, and vs pooling
    the full volume by ``gaussian_corr_pyramid`` (equal because the
    average pool is linear in fmap2), at a width that is not a multiple of
    f^2."""
    f1, f2 = (rng.standard_normal((1, 3, 37, 16)).astype(np.float32) for _ in range(2))
    got = corr_pyramid_fused(_t(f1), _t(f2), L, pool_factor=pool_factor)
    want = jcorr_pyramid_fused(jnp.asarray(f1), jnp.asarray(f2), L, pool_factor=pool_factor)
    pooled = gaussian_corr_pyramid(got[0], L, pool_factor)
    assert [v.shape[-1] for v in got] == [37, 37 // pool_factor, 37 // pool_factor**2]
    for g, w, p in zip(got, want, pooled):
        _close(g.numpy(), w, 1e-5)
        _close(g.numpy(), p.numpy(), 1e-5)


def test_convex_upsample_unscaled_matches_jax(rng):
    """The mixture weights' convex upsample (``scale=False``) and the
    scaled one vs JAX, NCHW here and NHWC there."""
    f = 4
    flow = rng.uniform(0, 1, (1, 5, 6, G)).astype(np.float32)
    mask = rng.standard_normal((1, 5, 6, 9 * f * f)).astype(np.float32)
    for scale in (False, True):
        want = jconvex_upsample(jnp.asarray(flow), jnp.asarray(mask), f, scale=scale)
        got = convex_upsample(_nchw(flow), _nchw(mask), f, scale=scale)
        _close(_nhwc(got), want, 1e-6)


# ------------------------------------------------------------------- modules

def test_encoder_matches_jax(rng):
    """Randomized batch-norm statistics and distinct head widths: the heads
    read outputs08 dim[0], outputs16 dim[1] and outputs32 dim[3]; with the
    dual input the heads and the low-level features see the first half of
    the batch and ``v`` the whole batch. base.json's strides (layer2 at
    stride 1); fast.json's run in the whole model below."""
    downsample = 2
    dims = ((24, 40, 56, 72), (16, 32, 48, 64))
    x = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jm = JEncoder(dims, "batch", downsample, 3, True, jnp.float32)
    v = _randomize_norms(_numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))),
                         rng)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load(PCVMultiBasicEncoder(dims, "batch", downsample), v, "cnet")
    with torch.no_grad():
        got = port(_nchw(x))
    widths = [[g.shape[1] for g in heads] for heads in got[:3]]
    assert widths == [[24, 16], [40, 32], [72, 64]]
    assert got[3].shape[0] == 2 and got[4].shape[:2] == (1, 32)
    for g, w in zip([*got[0], *got[1], *got[2], got[3], got[4]],
                    [*want[0], *want[1], *want[2], want[3], want[4]]):
        _close(_nhwc(g), w, 1e-4)


def _mixture_maps(rng, B, H, W):
    mu = rng.uniform(0, 40, (B, H, W, G)).astype(np.float32)
    sigma = rng.uniform(0.1, 16, (B, H, W, G)).astype(np.float32)
    w = rng.uniform(0.05, 1, (B, H, W, G)).astype(np.float32)
    return mu, sigma, (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _corr_features(rng, B, H, W):
    """(B, H, W, L*G*S) lookup output whose levels have distinct offsets,
    so that a fold that mixed up levels, Gaussians or samples would differ
    at O(1)."""
    c = rng.standard_normal((B, H, W, L, G, S)) + 3.0 * np.arange(L)[:, None, None]
    c = c + 0.5 * np.arange(G)[:, None] + 0.1 * np.arange(S)
    return c.reshape(B, H, W, L * G * S).astype(np.float32)


def test_motion_encoder_matches_jax(rng):
    """The encoder on the folded lookup (``fold_lookup``: (B, H, W, L, G, S)
    -> (B*G, L*S, H, W), what ``gaussian_row_sample`` returns) against the
    JAX encoder on the unfolded one, and the parameter branch."""
    B, H, W = 1, 6, 10
    mu, sigma, w = _mixture_maps(rng, B, H, W)
    corr = _corr_features(rng, B, H, W)
    jargs = tuple(jnp.asarray(a) for a in (mu, corr, w, sigma))
    jm = JMotionEncoder(G, S, L, jnp.float32)
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), *jargs))
    want = jax.jit(jm.apply)(v, *jargs)
    port = _load(BasicMotionEncoderPCV(G, S, L), v, "step.FDM.encoder")
    with torch.no_grad():
        got = port(_nchw(mu), fold_lookup(_t(corr), L, G), _nchw(w), _nchw(sigma))
    assert got.shape == (B, 48 * G + 64, H, W)
    _close(_nhwc(got), want, 1e-5)


def test_parameters_updater_matches_jax(rng):
    B, H, W = 1, 5, 7
    hidden = rng.standard_normal((B, H, W, 128)).astype(np.float32)
    mu, sigma, w = _mixture_maps(rng, B, H, W)
    jargs = tuple(jnp.asarray(a) for a in (hidden, mu, sigma, w))
    jm = JUpdater(G, jnp.float32)
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), *jargs))
    want = jax.jit(jm.apply)(v, *jargs)  # (mu, w, sigma)
    port = _load(ParametersUpdater(128, G), v, "step.FDM.ParametersUpdater")
    with torch.no_grad():
        got = port(*(_nchw(a) for a in (hidden, mu, sigma, w)))
    for g, wt in zip(got, want):
        assert g.dtype == torch.float32
        _close(_nhwc(g), wt, 1e-5)


def test_update_block_matches_jax(rng):
    """One iteration's slow-fast schedule: the motion features once, gru16
    alone, then gru16 + gru08, then all three with the updater and the mask
    head. The motion features are held to 1e-5; the outputs of the five
    chained GRU updates to 1e-4 (measured 1.6e-5 on the hidden states)."""
    B, H, W = 1, 8, 16
    net = [np.tanh(rng.standard_normal((B, H >> i, W >> i, 128))).astype(np.float32)
           for i in range(3)]
    inp = [[(0.5 * rng.standard_normal((B, H >> i, W >> i, 128))).astype(np.float32)
            for _ in range(3)] for i in range(3)]
    mu, sigma, w = _mixture_maps(rng, B, H, W)
    corr = _corr_features(rng, B, H, W)
    jnet = [jnp.asarray(n) for n in net]
    jinp = tuple(tuple(jnp.asarray(c) for c in i) for i in inp)
    jmix = tuple(jnp.asarray(a) for a in (corr, mu, w, sigma))
    jm = JUpdateBlock(3, 2, (128,) * 4, G, S, L, jnp.float32)
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(3), jnet, jinp, *jmix))

    def call(**flags):
        return jax.jit(functools.partial(jm.apply, **flags))

    slow = dict(iter16=True, iter08=False, iter04=False, update=False)
    mid = dict(iter16=True, iter08=True, iter04=False, update=False)
    jnet, mfl = call(**slow)(v, jnet, jinp, *jmix)
    jnet, mfl = call(**mid)(v, jnet, jinp, *jmix, motion_features_list=mfl)
    want_net, want_mask, want_mu, want_sigma, want_w = call()(
        v, jnet, jinp, *jmix, motion_features_list=mfl)

    port = _load(BasicMultiUpdateBlockPCV(3, 2, (128,) * 4, G, S, L), v, "step.FDM")
    tmix = dict(mu=_nchw(mu), w=_nchw(w), sigma=_nchw(sigma))
    with torch.no_grad():
        got_mfl = port.motion_features(tmix["mu"], fold_lookup(_t(corr), L, G), tmix["w"],
                                       tmix["sigma"])
        tnet = [_nchw(n) for n in net]
        tinp = [[_nchw(c) for c in i] for i in inp]
        tnet = port(tnet, tinp, got_mfl, **slow)
        tnet = port(tnet, tinp, got_mfl, **mid)
        got_net, got_mask, got_mu, got_sigma, got_w = port(tnet, tinp, got_mfl, **tmix)
    for g, wt in zip(got_mfl, mfl):
        _close(_nhwc(g), wt, 1e-5)
    for g, wt in zip([*got_net, got_mask, got_mu, got_sigma, got_w],
                     [*want_net, want_mask, want_mu, want_sigma, want_w]):
        _close(_nhwc(g), wt, 1e-4)
    with torch.no_grad():
        assert port(tnet, tinp, got_mfl, **tmix, with_mask=False)[1] is None


def test_refinenet_matches_jax(rng):
    """The dilated refinement (dilations 3 and 7) at a map larger than both
    receptive fields."""
    B, H, W = 1, 18, 26
    mu, sigma, w = _mixture_maps(rng, B, H, W)
    disp = (w * mu).sum(-1, keepdims=True)
    feats = rng.standard_normal((B, H, W, 32)).astype(np.float32)
    jargs = tuple(jnp.asarray(a) for a in (w, sigma, mu, disp, feats))
    jm = JRefineNet(G, jnp.float32)
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(4), *jargs))
    want = jax.jit(jm.apply)(v, *jargs)
    port = _load(RefineNet(G), v, "refineNet")
    with torch.no_grad():
        got = port(*(_nchw(a) for a in (w, sigma, mu, disp, feats)))
    _close(_nhwc(got), want, 1e-4)


# --------------------------------------------------------------- whole model

@pytest.fixture(scope="module")
def jax_params():
    """One JAX init of base.json (fp32, test mode) per config: fast.json's
    tree differs only in the mask head's last conv (8x8 instead of 4x4
    sub-pixels), which gets its own seeded draw at the base kernel's
    scale."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.uniform(0, 255, (1, *SIZES["base"], 3)).astype(np.float32))
    model = JPCVNet(JConfig.from_dict({**BASE, **FP32}), ITERS, test_mode=True)
    base = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), x, x))
    fast = jax.tree_util.tree_map(lambda a: a, base)
    head = dict(base["params"]["step"]["FDM"]["mask_conv2"])
    k = head["kernel"]
    head["kernel"] = (float(k.std()) * rng.standard_normal((*k.shape[:3], 64 * 9))
                      ).astype(np.float32)
    head["bias"] = np.zeros(64 * 9, np.float32)
    fast["params"]["step"]["FDM"] = {**fast["params"]["step"]["FDM"], "mask_conv2": head}
    return {"base": base, "fast": fast}


def _images(seed, hw):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, (*hw, 3)).astype(np.float32) for _ in range(2))


def _port(name, variables, **kw):
    model = PCVNet(PCVNetConfig.from_dict({**CONFIGS[name], **FP32}), iters=ITERS, **kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _jax_model(name, impl="reg", **kw):
    cfg = JConfig.from_dict({**CONFIGS[name], **FP32, "corr_implementation": impl})
    return JPCVNet(cfg, ITERS, test_mode=True, **kw)


@pytest.mark.parametrize("name, impl", [
    ("base", "reg"), ("base", "reg_cuda"), ("fast", "reg"), ("fast", "reg_cuda")])
def test_slice_matches_jax(jax_params, name, impl):
    """base.json / fast.json in fp32 through make_forward_fn/_run_one on the
    CPU (K5's plain twin) vs the JAX model with the XLA lookup (reg) and
    with the Pallas one in interpret mode (reg_cuda): 2e-2 px."""
    hw = SIZES[name]
    img1, img2 = _images(6, hw)
    variables = jax_params[name]
    x1, spec = jpad_input(jnp.asarray(img1[None]), PAD, "sintel")
    x2, _ = jpad_input(jnp.asarray(img2[None]), PAD, "sintel")
    _, want = jax.jit(_jax_model(name, impl).apply)(variables, x1, x2)
    want = np.asarray(junpad(want[..., None], spec))[0, ..., 0]
    n = gaussian_row_sample.launches
    disp, seconds = _run_one(make_forward_fn(_port(name, variables), device="cpu"), img1, img2,
                             divide_factor=PAD)
    assert gaussian_row_sample.launches == n
    assert disp.shape == want.shape == hw and seconds > 0
    assert float(np.abs(want).max()) > 5.0  # the iterations moved the disparity
    err = float(np.abs(disp - want).max())
    print(f"PCVNet {name} vs JAX {impl}: max_abs {err:.3e} px (max |disp| "
          f"{float(np.abs(want).max()):.1f} px)")
    assert err <= 2e-2


def test_cascade_and_second_stage_match_jax(jax_params):
    """The cascade dict (the last iteration's upsampled mixture) and a
    second stage started from the JAX dict through ``init_param`` (f_sc
    scaling, align-corners resize of mu and sigma, nearest resize of w).
    Bound: 2e-2 in the dict's own units (px for disp, mu and sigma; w
    within [0, 1] gets 1e-3) and 2e-2 px for the second stage."""
    variables = jax_params["base"]
    img1, img2 = (jnp.asarray(a[None]) for a in _images(7, SIZES["base"]))
    want = jax.jit(_jax_model("base", cascade=True).apply)(variables, img1, img2)
    got = _port("base", variables, cascade=True)(_t(img1), _t(img2))
    assert set(got) == set(want) == {"disp", "mu", "sigma", "w"}
    for k, tol in (("disp", 2e-2), ("mu", 2e-2), ("sigma", 2e-2), ("w", 1e-3)):
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (1, *SIZES["base"], 1 if k == "disp" else G), k
        assert float(np.abs(g - w).max()) <= tol, k
    init = {k: np.asarray(v) for k, v in want.items()}
    _, want2 = jax.jit(_jax_model("base").apply)(variables, img1, img2, None, init)
    with torch.no_grad():
        _, got2 = _port("base", variables)(_t(img1), _t(img2),
                                            init_param={k: _t(v) for k, v in init.items()})
    assert got2.shape == (1, *SIZES["base"])
    assert float(np.abs(got2.numpy() - np.asarray(want2)).max()) <= 2e-2


def test_mixed_precision_forward_runs_on_cpu():
    """base.json as shipped (bf16 autocast, bf16 pyramid) and fast.json from
    a seed: finite output of the input's size; the same seed gives the same
    weights."""
    x = torch.tensor(np.random.default_rng(8).uniform(0, 255, (2, 1, 32, 128, 3)),
                     dtype=torch.float32)
    for config in (BASE, FAST):
        model = create_model(config, iters=2, device="cpu", seed=0)
        with torch.inference_mode():
            none, disp = model(x[0], x[1])
        assert none is None and disp.shape == (1, 32, 128) and disp.dtype == torch.float32
        assert torch.isfinite(disp).all()
    again = create_model(FAST, iters=2, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_state_dict_from_flax_matches_export_reference_pth(jax_params):
    """Key for key and value for value, the JAX package's own exporter given
    the port's state dict as its template; the port then loads it
    strictly."""
    port = PCVNet(PCVNetConfig.from_dict(BASE), iters=1)
    ours = state_dict_from_flax(jax_params["base"])
    theirs = export_reference_pth(jax_params["base"], port.state_dict())
    assert set(ours) == set(theirs) == set(port.state_dict())
    for key in ("FDM.conv2_out.0.weight", "conv2.0.conv1.weight", "conv2.1.weight",
                "cnet.low_level_conv.2.weight", "refineNet.conv0.2.weight",
                "refineNet.conv_softmask.0.bias", "FDM.mask.2.weight"):
        assert key in ours, key
    for k, t in ours.items():
        assert t.dtype == theirs[k].dtype and torch.equal(t, theirs[k]), k
    port.load_state_dict(ours, strict=True)


def test_registry_and_unported_modes():
    """The registry entry; train mode builds (in train mode, the shipped
    config's remat off) and the model's default loss adapter is the PCV
    loss, which reads ``output_list``; without a card the default device
    raises."""
    assert get_model("PCVNet") == (PCVNet, PCVNetConfig)
    assert PCVNetConfig.from_dict(BASE).compress_factor == 4
    assert PCVNetConfig.from_dict(FAST).compress_factor == 2
    model = create_model(BASE, iters=1, device="cpu", test_mode=False)
    assert isinstance(model, PCVNet) and model.training and not model.test_mode
    assert not model.cfg.remat_iters
    loss_fn = make_loss_adapter("PCVNet", BASE)
    ones = torch.ones(1, 2, 3)
    out = {"output_list": (ones, ones[None], ones[None, ..., None].expand(1, 1, 2, 3, G),
                           None, None)}
    loss, metrics, mask, ok = loss_fn(out, -ones, ones)
    assert float(loss) == 0.0 and bool(ok) and bool(mask.all()) and len(metrics) == 14
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(BASE)
