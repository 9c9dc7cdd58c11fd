"""The port's no-volume correlation ("alt" and "alt_cuda") against the JAX
package, on the CPU: K3's plain twin (``ops/corr.py::corr_lookup_alt``)
against the JAX XLA lookup and against ``corr_lookup_alt_pallas`` in
interpret mode, the gradients of ``CorrLookupAlt`` against ``jax.grad`` of
the Pallas lookup, the whole test-mode forward in both modes, and one
train-mode forward and its gradients with ``alt_cuda``.

Inputs and weights are seeded numpy; the JAX Pallas kernel runs in
interpret mode, as the JAX package's own tests run it. The port's CPU path
is the plain version of every kernel.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.losses.sequence import sequence_loss_raft as jsequence_loss_raft
from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JConfig
from dkt_stereo_tpu.ops.corr import corr_lookup_alt as jcorr_lookup_alt
from dkt_stereo_tpu.ops.corr import fmap_pyramid as jfmap_pyramid
from dkt_stereo_tpu.ops.pad import pad_input as jpad_input
from dkt_stereo_tpu.ops.pad import unpad_input as jnp_unpad
from dkt_stereo_tpu.ops.pallas.corr_alt import corr_lookup_alt_pallas
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
from dkt_stereo_tpu_torch.models import raft_stereo
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.ops.corr import corr_lookup_alt, fmap_pyramid
from dkt_stereo_tpu_torch.ops.cuda import corr_alt
from dkt_stereo_tpu_torch.ops.cuda.corr_alt import CorrLookupAlt
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_train import jit_vjp

ROOT = Path(__file__).resolve().parents[1]
ALT = load_model_config(str(ROOT / "configs/raft_stereo/alt_pallas.json"))
TRAIN = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
FP32 = {"mixed_precision": False, "corr_dtype": "float32"}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _features(rng, B, H, W, D, dtype):
    """fmap1, fmap2 and coordinates in [-2, W+2], on both sides; fmap2
    pooled by each side's own ``fmap_pyramid``."""
    jdt, tdt = DTYPES[dtype]
    f1, f2 = (rng.standard_normal((B, H, W, D)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-2, W + 2, (B, H, W, 1)).astype(np.float32)
    jax_side = (jnp.asarray(f1).astype(jdt), jnp.asarray(f2).astype(jdt), jnp.asarray(coords))
    port_side = (_t(f1).to(tdt), _t(f2).to(tdt), _t(coords))
    return jax_side, port_side


@jax.jit
def _jax_lookups(f1, f2, coords):
    """JAX's XLA lookup and its Pallas kernel (interpret mode) over the
    transposed pyramid, as ``models/raft_stereo.py`` calls them."""
    pyr = jfmap_pyramid(f2, 4)
    f2t = tuple(jnp.swapaxes(f, -1, -2) for f in pyr)
    return jcorr_lookup_alt(f1, pyr, coords, 4), corr_lookup_alt_pallas(f1, f2t, coords, 4, True)


# interpret mode unrolls the kernel's loop over the B*H rows of a block, so
# the shapes keep B*H small
@pytest.mark.parametrize("dtype, shape", [
    ("float32", (2, 1, 37, 256)),   # odd widths 37/18/9/4, the model's D
    ("bfloat16", (2, 1, 37, 256)),
    ("float32", (1, 1, 517, 32)),   # W1 > 512: JAX's chunked path (_pick_cols)
    ("bfloat16", (1, 1, 517, 32)),
    ("float32", (2, 1, 37, 3)),     # depths K3 once refused: not a multiple of 8
    ("bfloat16", (2, 1, 37, 20)),
])
def test_corr_lookup_alt_matches_jax(rng, dtype, shape):
    """The plain twin vs JAX XLA and Pallas (interpret), fp32 sums over the
    same (bf16-rounded) features in another order. Bound: 1e-4 x the
    output's scale, the JAX package's own bound between its Pallas and
    materialized lookups (tests/test_pallas_corr.py:105); measured ~5e-7.
    Both sides pool fmap2 identically, bit for bit."""
    (jf1, jf2, jc), (f1, f2, c) = _features(rng, *shape, dtype)
    want_xla, want_pallas = (np.asarray(a) for a in _jax_lookups(jf1, jf2, jc))
    pyr = fmap_pyramid(f2, 4)
    for got_level, want_level in zip(pyr, jfmap_pyramid(jf2, 4)):
        np.testing.assert_array_equal(got_level.float().numpy(),
                                      np.asarray(want_level.astype(jnp.float32)))
    got = corr_lookup_alt(f1, pyr, c, 4).numpy()
    assert got.shape == want_xla.shape == (*shape[:3], 36) and got.dtype == np.float32
    scale = float(np.abs(want_xla).max())
    assert float(np.abs(got - want_xla).max()) <= 1e-4 * scale
    assert float(np.abs(got - want_pallas).max()) <= 1e-4 * scale


def test_corr_lookup_alt_nan_position():
    """A NaN coordinate reads a clamped index with weight 0: its pixel's
    outputs are NaN (no out-of-range gather), the others are unaffected."""
    f1, f2 = torch.randn(1, 1, 5, 16), torch.randn(1, 1, 5, 16)
    coords = torch.tensor([0.5, float("nan"), 2.0, 1e9, -1e9]).view(1, 1, 5, 1)
    out = corr_lookup_alt(f1, fmap_pyramid(f2, 2), coords, 2)
    assert torch.isnan(out[0, 0, 1]).all()
    assert torch.isfinite(out[0, 0, [0, 2, 3, 4]]).all()
    assert (out[0, 0, 3:] == 0).all()


def test_corr_lookup_alt_nan_positions_match_pallas(rng):
    """NaN coordinates among finite ones: the plain twin's NaN mask equals
    ``corr_lookup_alt_pallas``'s in interpret mode (every tap of the pixel
    at every level), and the gradients of ``CorrLookupAlt`` (its recompute
    backward) have ``jax.vjp``'s NaN mask for fmap1 and the pyramid; the
    finite values within the bounds above."""
    B, H, W, D = 1, 2, 16, 8
    f1, f2 = (rng.standard_normal((B, H, W, D)).astype(np.float32) for _ in range(2))
    c = rng.uniform(-2, W + 2, (B, H, W, 1)).astype(np.float32)
    c.reshape(-1)[[3, 20]] = np.nan
    g = rng.standard_normal((B, H, W, 36)).astype(np.float32)

    def lookup(a, b):
        f2t = tuple(jnp.swapaxes(f, -1, -2) for f in jfmap_pyramid(b, 4))
        return corr_lookup_alt_pallas(a, f2t, jnp.asarray(c), 4, True)

    out, grads = jit_vjp(lookup, (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(g))
    want = [np.asarray(d) for d in grads]
    t1, t2 = _t(f1).requires_grad_(True), _t(f2).requires_grad_(True)
    got_out = CorrLookupAlt.apply(t1, _t(c), 4, *fmap_pyramid(t2, 4))
    got_out.backward(_t(g))
    out, got_out = np.asarray(out), got_out.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got_out), np.isnan(out))
    assert np.isnan(got_out[0, 0, 3]).all() and np.isnan(got_out[0, 1, 4]).all()
    assert np.isnan(got_out).sum() == 2 * 36
    fin = ~np.isnan(out)
    assert float(np.abs(got_out[fin] - out[fin]).max()) <= 1e-4 * float(np.abs(out[fin]).max())
    for d, w in zip((t1.grad.numpy(), t2.grad.numpy()), want):
        np.testing.assert_array_equal(np.isnan(d), np.isnan(w))
        assert np.isnan(d).any()
        fin = ~np.isnan(w)
        assert float(np.abs(d[fin] - w[fin]).max()) <= 1e-4 * float(np.abs(w[fin]).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corr_lookup_alt_function_grads_match_jax(rng, dtype):
    """Gradients of ``sum(out^2)`` through ``CorrLookupAlt`` (its recompute
    backward, on the CPU) and the port's pooling, vs ``jax.grad`` of
    ``corr_lookup_alt_pallas`` (interpret mode) through JAX's pooling, as
    tests/test_pallas_corr.py:121-137 does. Each gradient comes back in its
    input's dtype. Bound: fp32 1e-4 x max|grad| (sums in another order;
    measured ~1e-6); bf16 2^-7 x max|grad|, one bf16 rounding of fp32 sums
    that may differ in their last bits."""
    (jf1, jf2, jc), (f1, f2, c) = _features(rng, 1, 2, 16, 64, dtype)

    def loss(f1, f2):
        f2t = tuple(jnp.swapaxes(f, -1, -2) for f in jfmap_pyramid(f2, 4))
        return (corr_lookup_alt_pallas(f1, f2t, jc, 4, True) ** 2).sum()

    grads = jax.jit(jax.grad(loss, argnums=(0, 1)))(jf1, jf2)
    want = [np.asarray(g.astype(jnp.float32)) for g in grads]
    f1.requires_grad_(True)
    f2.requires_grad_(True)
    launches = corr_alt.corr_lookup_alt.launches
    out = CorrLookupAlt.apply(f1, c, 4, *fmap_pyramid(f2, 4))
    (out**2).sum().backward()
    assert corr_alt.corr_lookup_alt.launches == launches  # CPU: the plain path
    assert f1.grad.dtype == f2.grad.dtype == DTYPES[dtype][1]
    rel = 1e-4 if dtype == "float32" else 2**-7
    for got, w in zip((f1.grad, f2.grad), want):
        assert float(np.abs(got.float().numpy() - w).max()) <= rel * float(np.abs(w).max())


def test_corr_lookup_alt_wrapper_devices():
    """CPU tensors take the plain path (no launch); devices that are
    neither CPU nor CUDA are refused. Only fmap1's gradient is asked for
    here, and the levels get none."""
    f1 = torch.randn(1, 2, 8, 16, requires_grad=True)
    levels = fmap_pyramid(torch.randn(1, 2, 8, 16), 2)
    c = torch.rand(1, 2, 8, 1) * 8
    n = corr_alt.corr_lookup_alt.launches
    out = corr_alt.corr_lookup_alt(f1, levels, c, 2)
    assert out.shape == (1, 2, 8, 10) and corr_alt.corr_lookup_alt.launches == n
    CorrLookupAlt.apply(f1, c, 2, *levels).sum().backward()
    assert f1.grad is not None and all(v.grad is None for v in levels)
    with pytest.raises(ValueError, match="unsupported device"):
        corr_alt.corr_lookup_alt(f1.detach().to("meta"), [v.to("meta") for v in levels],
                                 c.to("meta"), 2)


# --- the whole model ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["alt_cuda", "alt"])
def test_alt_pyramids_under_mixed_precision(rng, monkeypatch, mode):
    """alt_pallas.json as shipped (bf16 autocast) on the CPU: alt_cuda pools
    and stores the right features in bf16, alt pools them in fp32 from the
    bf16-rounded fmap2, as the JAX model does (models/raft_stereo.py:276-289;
    their levels >= 1 differ by one bf16 rounding). Each level the lookup
    receives equals JAX's fmap_pyramid under that mode's rule, bit for bit;
    fmap1 reaches the lookup in bf16 either way."""
    name = "corr_lookup_alt" if mode == "alt_cuda" else "corr_lookup_alt_plain"
    lookup, seen = getattr(raft_stereo, name), []

    def spy(fmap1, pyramid, coords, r):
        seen.append((fmap1, list(pyramid)))
        return lookup(fmap1, pyramid, coords, r)

    monkeypatch.setattr(raft_stereo, name, spy)
    model = create_model({**ALT, "corr_implementation": mode}, iters=1, device="cpu", seed=0)
    x = _t(rng.uniform(0, 255, (2, 1, 32, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        model(x[0], x[1])
    fmap1, levels = seen[0]
    jdt, tdt = DTYPES["bfloat16" if mode == "alt_cuda" else "float32"]
    assert fmap1.dtype == torch.bfloat16 and [v.dtype for v in levels] == [tdt] * 4
    want = jfmap_pyramid(jnp.asarray(levels[0].float().numpy()).astype(jdt), 4)
    for got, w in zip(levels, want):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(w.astype(jnp.float32)))

ITERS = 3
B, H, W = 1, 32, 64


def _jax_config(base, mode, **kw):
    return JConfig.from_dict({**base, **FP32, "corr_implementation": mode, **kw})


@pytest.fixture(scope="module")
def jax_variables():
    """One JAX init at 1x32x64, shared by the tests below: train.json's
    model and alt_pallas.json's (both with batch-norm context) have the same
    parameter tree whatever the corr mode and the model's mode."""
    model = JRAFTStereo(_jax_config(TRAIN, "alt_cuda"), iters=1, test_mode=False)
    x = jnp.zeros((B, H, W, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x, x)
    return jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in variables.items()})


@pytest.fixture(scope="module")
def jax_forward(jax_variables):
    """The JAX test-mode forward (fp32, XLA encoder) with each alt mode, at
    1x30x60 padded to 32x64."""
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (30, 60, 3)).astype(np.float32) for _ in range(2))
    x1, spec = jpad_input(jnp.asarray(img1[None]), 32, "sintel")
    x2, _ = jpad_input(jnp.asarray(img2[None]), 32, "sintel")
    disp = {}
    for mode in ("alt_cuda", "alt"):
        model = JRAFTStereo(_jax_config(ALT, mode, pallas_encoder=False), iters=ITERS,
                            test_mode=True)
        _, d = jax.jit(model.apply)(jax_variables, x1, x2)
        disp[mode] = np.asarray(jnp_unpad(d[..., None], spec))[0, ..., 0]
    return (img1, img2), disp


@pytest.mark.parametrize("mode", ["alt_cuda", "alt"])
def test_alt_forward_matches_jax(jax_variables, jax_forward, mode):
    """alt_pallas.json's model (fp32, XLA-equivalent encoder) in each alt
    mode through make_forward_fn / _run_one on the CPU vs the JAX model in
    the same mode, from one JAX init loaded strictly (the alt modes share
    the volume modes' parameter tree). Bound 2.5e-3 px, that of
    tests/test_torch_raft.py:53: fp32 sums in another order, carried
    through 3 GRU iterations of random weights."""
    (img1, img2), want = jax_forward
    model = RAFTStereo(RAFTStereoConfig.from_dict(
        {**ALT, **FP32, "corr_implementation": mode, "pallas_encoder": False}), iters=ITERS)
    model.load_state_dict(state_dict_from_flax(jax_variables), strict=True)
    disp, _ = _run_one(make_forward_fn(model, device="cpu"), img1, img2)
    assert disp.shape == want[mode].shape == (30, 60)
    assert float(np.abs(disp - want[mode]).max()) <= 2.5e-3


def test_alt_cuda_train_gradients_match_jax(jax_variables):
    """train.json with alt_cuda and remat_iters, 2 iterations, fp32: the
    per-iteration predictions and the gradients of sequence_loss_raft vs
    ``jax.grad`` of the JAX model, tensor by tensor. The JAX side runs
    ``alt`` with remat off: its alt_cuda VJP differentiates exactly that
    XLA lookup, both modes pool the same fp32 features at fp32, and remat
    leaves the numerics as they are, at a third of alt_cuda's compile time
    in interpret mode (test_alt_forward_matches_jax holds the Pallas
    forward). Bound per tensor, that of
    tests/test_torch_train.py::test_student_gradients_match_jax: L2 error
    <= 5e-3 of the tensor's gradient norm plus 1e-7 of the global norm.
    The fnet is reached only through the lookup's fmap1 and pyramid
    gradients; its gradients must be nonzero."""
    iters = 2
    rng = np.random.default_rng(1)
    jmodel = JRAFTStereo(_jax_config(TRAIN, "alt", remat_iters=False), iters=iters,
                         test_mode=False)
    img1, img2 = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    flow = (-rng.uniform(0, 20, (B, H, W))).astype(np.float32)
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    variables = jax_variables

    def loss_fn(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           img1, img2)
        return jsequence_loss_raft(out["disp_preds"], flow, valid)[0], out["disp_preds"]

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    jgrads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})

    cfg = {**TRAIN, **FP32, "corr_implementation": "alt_cuda", "remat_iters": True}
    model = RAFTStereo(RAFTStereoConfig.from_dict(cfg), iters=iters, test_mode=False)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    out = model.train()(_t(img1), _t(img2))
    assert float((out["disp_preds"].detach() - _t(np.asarray(jpreds))).abs().max()) <= 2.5e-3
    loss = sequence_loss_raft(out["disp_preds"], _t(flow), _t(valid))[0]
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    named = dict(model.named_parameters())
    total = float(torch.stack([jgrads[k].norm() for k in named]).norm())
    for k, p in named.items():
        err = float((p.grad - jgrads[k]).norm())
        assert err <= 5e-3 * float(jgrads[k].norm()) + 1e-7 * total, (k, err)
    fnet = [k for k in named if k.startswith("fnet.") and k.endswith("weight")]
    assert len(fnet) > 10 and all(float(named[k].grad.norm()) > 0 for k in fnet)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _alt_args(B=2, H=3, W=37, D=3, L=4, dtype=torch.bfloat16):
    return (_meta((B, H, W, D), dtype), [_meta((B, H, max(W >> i, 1), D), dtype) for i in range(L)],
            _meta((B, H, W, 1), torch.float32))


@pytest.mark.parametrize("D, L, radius, dtype", [
    (3, 4, 4, torch.bfloat16),     # no bulk copies: plain loads in the kernel
    (20, 5, 12, torch.float32),    # beyond the first kernel's 4 levels and radius 8
    (20, 5, 12, torch.bfloat16),
    (256, 8, 16, torch.float32),   # the most levels and the widest fp32 tiles
    (512, 4, 4, torch.bfloat16),
    (512, 8, 16, torch.float32),   # the widest tiles: fp32 blocks take fewer pixels
])
def test_corr_alt_check_args_accepts(D, L, radius, dtype):
    """The kernel's argument checks (run on meta tensors: shapes, dtypes
    and devices only) take any depth from 1 to 512, up to 8 levels and a
    radius of at least 16; the shared memory they need fits a block."""
    f1, levels, coords = _alt_args(D=D, L=L, dtype=dtype)
    corr_alt.check_args(f1, levels, coords, radius)
    assert corr_alt.smem_bytes(D, dtype == torch.bfloat16, radius) <= 232448


@pytest.mark.parametrize("case, match", [
    ("levels", "1..8 levels"),
    ("depth", r"D must be in \[1, 512\]"),
    ("dtype", "fp32 or bf16"),
    ("radius", "radius must be >= 0"),
    ("smem", "shared memory"),
    ("coords shape", "coords_x must be"),
    ("coords dtype", "coords_x must be"),
    ("coords device", "coords_x must be"),
    ("level dtype", "every level must be"),
    ("level device", "every level must be"),
    ("level shape", "level shape"),
    ("fmap1 rank", r"\(B, H, W1, D\)"),
])
def test_corr_alt_check_args_refuses(case, match):
    f1, levels, coords = _alt_args()
    radius = 4
    if case == "levels":
        levels = levels * 3
    elif case == "depth":
        f1, levels, coords = _alt_args(D=513)
    elif case == "dtype":
        f1, levels, coords = _alt_args(dtype=torch.float16)
    elif case == "radius":
        radius = -1
    elif case == "smem":
        radius = 4000
    elif case == "coords shape":
        coords = _meta((2, 3, 36, 1), torch.float32)
    elif case == "coords dtype":
        coords = _meta((2, 3, 37, 1), torch.bfloat16)
    elif case == "coords device":
        coords = torch.zeros((2, 3, 37, 1))
    elif case == "level dtype":
        levels[1] = _meta(levels[1].shape, torch.float32)
    elif case == "level device":
        levels[2] = torch.zeros(levels[2].shape, dtype=torch.bfloat16)
    elif case == "level shape":
        levels[0] = _meta((2, 3, 37, 4))
    elif case == "fmap1 rank":
        f1 = _meta((3, 37, 3))
    with pytest.raises(ValueError, match=match):
        corr_alt.check_args(f1, levels, coords, radius)
