"""The port's IGEV-Stereo DKT slice vs the JAX package, on the CPU:
``sequence_loss_igev``, K4's backward (the plain version and the
``GeoLookup`` autograd function), IGEV's train-mode forward and student
gradients with ``freeze_backbone`` on and off, ``cascade_upsample2x`` on an
IGEV output, and one whole DKT step from the same weights, batch and draws.

The weights come from one JAX train-mode init at B=2, 32x64, ``max_disp``
32, with random batch-norm statistics and the disparity head's last conv
scaled by 0.05 (random IGEV weights move the disparity by tens to hundreds
of px an iteration, and fp32 reordering then grows with every iteration;
tests/test_torch_igev.py). The JAX side runs ``corr_implementation="reg"``
(the plain lookup) without remat, except for the K4-backward tests, which
take ``jax.vjp`` of ``geo_lookup_pallas`` in interpret mode. The port's CPU
path is the plain version of every kernel. Both sides run fp32, 2
iterations (teachers included).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.losses.sequence import sequence_loss_igev as jsequence_loss_igev
from dkt_stereo_tpu.models import IGEVStereo as JIGEVStereo
from dkt_stereo_tpu.models import IGEVStereoConfig as JConfig
from dkt_stereo_tpu.models.registry import make_loss_adapter as jmake_loss_adapter
from dkt_stereo_tpu.ops.pallas.geo_lookup import geo_lookup_pallas
from dkt_stereo_tpu.train import DKTHyperParams as JHyper
from dkt_stereo_tpu.train import make_dkt_train_step as jmake_dkt_train_step
from dkt_stereo_tpu.train.dkt_step import _cascade_upsample2x
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_igev
from dkt_stereo_tpu_torch.models.igev_stereo import IGEVStereo, IGEVStereoConfig
from dkt_stereo_tpu_torch.ops.cuda import geo_lookup as k4
from dkt_stereo_tpu_torch.ops.cuda.geo_lookup import GeoLookup
from dkt_stereo_tpu_torch.ops.geometry import geo_lookup_bwd_plain
from dkt_stereo_tpu_torch.train.dkt_step import cascade_upsample2x
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_train import _check_step_against_jax

ROOT = Path(__file__).resolve().parents[1]
TRAIN = json.loads((ROOT / "configs/igev_stereo/train.json").read_text())
# fp32 and the plain lookup on both sides; max_disp cut to the test's size
SMALL = {"mixed_precision": False, "corr_dtype": "float32", "max_disp": 32}
B, H, W, ITERS = 2, 32, 64, 2
TRUNK = ("feature.", "stem_2.", "stem_4.", "conv.", "desc.")


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _config(**kw):
    return {**TRAIN, **SMALL, **kw}


def _jax_cfg(**kw):
    return JConfig.from_dict(_config(corr_implementation="reg", remat_iters=False, **kw))


def _jax_loss(cfg):
    return jmake_loss_adapter("IGEVStereo", cfg)


# --- the loss --------------------------------------------------------------------


def test_sequence_loss_igev_matches_jax(rng):
    """Loss, metrics, mask and ok on 3 iterations with invalid, out-of-range
    (|gt| >= max_disp) and NaN GT pixels (masked out, so ok stays true), then
    a NaN prediction and a NaN init (ok false, loss zeroed). fp32 sums in
    another order: 1e-6 relative. The init errors straddle the smooth-L1
    knee at 1 px."""
    preds = (-rng.uniform(0, 30, (3, B, 8, 12))).astype(np.float32)
    gt = (-rng.uniform(0, 30, (B, 8, 12))).astype(np.float32)
    init = (gt + rng.uniform(-3, 3, gt.shape)).astype(np.float32)
    gt[0, 0, :3] = [-200.0, np.nan, np.inf]
    valid = (rng.uniform(0, 1, (B, 8, 12)) > 0.3).astype(np.float32)
    nan_pred = np.where(np.arange(12) == 5, np.nan, preds).astype(np.float32)
    nan_init = np.where(np.arange(12) == 7, np.nan, init).astype(np.float32)
    for p, i, want_ok in ((preds, init, True), (nan_pred, init, False), (preds, nan_init, False)):
        loss, metrics, mask, ok = sequence_loss_igev(_t(p), _t(i), _t(gt), _t(valid), max_disp=64)
        jloss, jmetrics, jmask, jok = jsequence_loss_igev(
            jnp.asarray(p), jnp.asarray(i), jnp.asarray(gt), jnp.asarray(valid), max_disp=64)
        assert ok.dim() == 0 and bool(ok) == bool(jok) == want_ok
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        assert set(metrics) == set(jmetrics) == {"epe", "init_epe", "1px", "3px", "5px"}
        if want_ok:
            assert float(loss) > 0
            for k in metrics:
                np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6)
        else:
            assert float(loss) == 0.0


# --- K4 backward -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def k4_case(request):
    """Pyramids at 1x4x24, geo D 12/6 x 8, corr W2 24/12, r=4, with
    disparities in range, negative, above D and far out of range, an
    incoming gradient, and ``jax.vjp`` of the Pallas lookup (interpret mode)
    per pyramid dtype."""
    rng = np.random.default_rng(11)
    Bk, Hk, Wk, D, C, L = 1, 4, 24, 12, 8, 2
    geo = [rng.standard_normal((Bk, Hk, Wk, D >> i, C)).astype(np.float32) for i in range(L)]
    cor = [rng.standard_normal((Bk, Hk, Wk, Wk >> i)).astype(np.float32) for i in range(L)]
    disp = rng.uniform(-6, D + 6, (Bk, Hk, Wk, 1)).astype(np.float32)
    disp.reshape(-1)[:10] = [-1e9, 1e9, -3.0, -0.5, 0.0, 5.0, D - 1.0, D + 0.25, 2.5e4, -7e3]
    coords = np.broadcast_to(np.arange(Wk, dtype=np.float32)[None, None, :, None],
                             disp.shape).copy()
    g = rng.standard_normal((Bk, Hk, Wk, L * (C + 1) * 9)).astype(np.float32)
    jdt = jnp.dtype(request.param)
    jpyr = [jnp.asarray(v, jdt) for v in geo + cor]
    _, vjp = jax.vjp(lambda *p: geo_lookup_pallas(p[:L], p[L:], jnp.asarray(disp),
                                                  jnp.asarray(coords), 4, True), *jpyr)
    grads = vjp(jnp.asarray(g))  # dgeo_0, dgeo_1, dcorr_0, dcorr_1
    assert [d.dtype for d in grads] == [jdt] * 4
    want = [np.asarray(d.astype(jnp.float32)) for d in grads]
    tdt = getattr(torch, request.param)
    pyr = [_t(v).to(tdt) for v in geo + cor]
    return request.param, pyr, _t(disp), _t(coords), _t(g), want


def _close_levels(got, want, dtype):
    """fp32: the same taps and weights, 1e-5 of the level's largest
    gradient; bf16: one rounding of fp32 sums that may differ in the last
    fp32 bit, so one bf16 step (2^-8) of the level's scale."""
    for d, w in zip(got, want):
        scale = max(float(np.abs(w).max()), 1e-6)
        tol = (1e-5 if dtype == "float32" else 2**-8) * scale
        np.testing.assert_allclose(d.float().numpy(), w, atol=tol, rtol=0)


def test_geo_lookup_bwd_plain_matches_pallas_vjp(k4_case):
    """``geo_lookup_bwd_plain`` vs ``jax.vjp`` of the Pallas lookup: every
    level of both pyramids, shaped and typed as the JAX kernels'
    ``out_shape`` (geo_lookup.py:269, :294); an out-of-range disparity
    gives an all-zero row."""
    dtype, pyr, disp, coords, g, want = k4_case
    meta = [(v.shape, v.dtype) for v in pyr]
    dgeo, dcorr = geo_lookup_bwd_plain(meta[:2], meta[2:], disp, coords, g, 4)
    got = [*dgeo, *dcorr]
    assert [d.dtype for d in got] == [pyr[0].dtype] * 4
    assert [tuple(d.shape) for d in got] == [tuple(v.shape) for v in pyr]
    _close_levels(got, want, dtype)
    assert float(dgeo[0][0, 0, 1].abs().max()) == 0.0  # disparity 1e9


def test_geo_lookup_autograd_function_matches_pallas_vjp(k4_case):
    """Autograd through ``GeoLookup`` on CPU tensors (its plain forward and
    backward) against the same VJP, with a strided incoming gradient as the
    model's permute gives it; disp and coords get no gradient."""
    dtype, pyr, disp, coords, g, want = k4_case
    levels = [v.clone().requires_grad_(True) for v in pyr]
    disp = disp.clone().requires_grad_(True)
    out = GeoLookup.apply(disp, coords, 4, 2, *levels)
    assert out.dtype == torch.float32 and out.shape == g.shape
    strided = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    out.backward(strided)
    assert disp.grad is None
    assert [v.grad.dtype for v in levels] == [pyr[0].dtype] * 4
    _close_levels([v.grad for v in levels], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geo_lookup_bwd_plain_matches_pallas_vjp_past_the_kernels_former_caps(dtype):
    """Three levels at radius 10 (the CUDA kernels once stopped at 4 levels
    and radius 8): ``geo_lookup_bwd_plain`` and autograd through
    ``GeoLookup`` on CPU tensors against ``jax.vjp`` of the Pallas lookup in
    interpret mode, held as the two-level case is."""
    rng = np.random.default_rng(13)
    Bk, Hk, Wk, D, C, L, r = 1, 2, 24, 16, 8, 3, 10
    geo = [rng.standard_normal((Bk, Hk, Wk, D >> i, C)).astype(np.float32) for i in range(L)]
    cor = [rng.standard_normal((Bk, Hk, Wk, Wk >> i)).astype(np.float32) for i in range(L)]
    disp = rng.uniform(-6, D + 6, (Bk, Hk, Wk, 1)).astype(np.float32)
    disp.reshape(-1)[:4] = [-1e9, 1e9, 0.0, D - 1.0]
    coords = np.broadcast_to(np.arange(Wk, dtype=np.float32)[None, None, :, None],
                             disp.shape).copy()
    g = rng.standard_normal((Bk, Hk, Wk, L * (C + 1) * (2 * r + 1))).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jpyr = [jnp.asarray(v, jdt) for v in geo + cor]
    _, vjp = jax.vjp(lambda *p: geo_lookup_pallas(p[:L], p[L:], jnp.asarray(disp),
                                                  jnp.asarray(coords), r, True), *jpyr)
    want = [np.asarray(d.astype(jnp.float32)) for d in vjp(jnp.asarray(g))]
    tdt = getattr(torch, dtype)
    pyr = [_t(v).to(tdt) for v in geo + cor]
    meta = [(v.shape, v.dtype) for v in pyr]
    dgeo, dcorr = geo_lookup_bwd_plain(meta[:L], meta[L:], _t(disp), _t(coords), _t(g), r)
    assert [tuple(d.shape) for d in dgeo + dcorr] == [tuple(v.shape) for v in pyr]
    _close_levels(dgeo + dcorr, want, dtype)
    levels = [v.clone().requires_grad_(True) for v in pyr]
    GeoLookup.apply(_t(disp), _t(coords), r, L, *levels).backward(_t(g))
    _close_levels([v.grad for v in levels], want, dtype)


def test_geo_lookup_nan_positions_match_pallas():
    """NaN disparities and a NaN coordinate among finite ones: the plain
    forward's NaN mask (``ops/geometry.py::geo_lookup``) equals the Pallas
    lookup's in interpret mode (every output of a NaN-disparity pixel, the
    corr taps of a NaN-coordinate pixel), and ``geo_lookup_bwd_plain``'s
    equals ``jax.vjp``'s in every level of dgeo and dcorr (the pixel's whole
    row); the finite values within the bounds above."""
    rng = np.random.default_rng(17)
    Bk, Hk, Wk, D, C, L = 1, 2, 24, 12, 8, 2
    geo = [rng.standard_normal((Bk, Hk, Wk, D >> i, C)).astype(np.float32) for i in range(L)]
    cor = [rng.standard_normal((Bk, Hk, Wk, Wk >> i)).astype(np.float32) for i in range(L)]
    disp = rng.uniform(-2, D + 2, (Bk, Hk, Wk, 1)).astype(np.float32)
    disp.reshape(-1)[[2, 30]] = np.nan
    coords = np.broadcast_to(np.arange(Wk, dtype=np.float32)[None, None, :, None],
                             disp.shape).copy()
    coords.reshape(-1)[5] = np.nan
    g = rng.standard_normal((Bk, Hk, Wk, L * (C + 1) * 9)).astype(np.float32)
    out, vjp = jax.vjp(lambda *p: geo_lookup_pallas(p[:L], p[L:], jnp.asarray(disp),
                                                    jnp.asarray(coords), 4, True),
                       *[jnp.asarray(v) for v in geo + cor])
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    got_out = k4.geo_lookup_plain([_t(v) for v in geo], [_t(v) for v in cor], _t(disp),
                                  _t(coords), 4).numpy()
    out = np.asarray(out)
    np.testing.assert_array_equal(np.isnan(got_out), np.isnan(out))
    assert np.isnan(got_out[0, 0, 2]).all() and np.isnan(got_out[0, 1, 6]).all()
    assert np.isnan(got_out[0, 0, 5]).sum() == L * 9  # the corr taps only
    fin = ~np.isnan(out)
    np.testing.assert_allclose(got_out[fin], out[fin], atol=1e-5 * float(np.abs(out[fin]).max()))
    meta = [(v.shape, torch.float32) for v in geo + cor]
    dgeo, dcorr = geo_lookup_bwd_plain(meta[:L], meta[L:], _t(disp), _t(coords), _t(g), 4)
    got = [d.numpy() for d in dgeo + dcorr]
    for d, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(d), np.isnan(w))
    assert np.isnan(got[0][0, 0, 2]).all() and not np.isnan(got[0][0, 0, 5]).any()
    assert np.isnan(got[L][0, 0, 5]).all()
    _close_levels([torch.tensor(np.nan_to_num(d)) for d in got], [np.nan_to_num(w) for w in want],
                  "float32")


def test_geo_lookup_backward_skips_parts_without_grad(monkeypatch):
    """With the corr levels not requiring grad (a frozen backbone), the
    backward computes no corr gradient (the dcorr wrapper is not called)
    and the geo gradient is unchanged; the plain backward returns None for
    the parts it is not asked for."""
    rng = np.random.default_rng(12)
    geo = [_t(rng.standard_normal((1, 2, 8, 6 >> i, 8)).astype(np.float32)) for i in range(2)]
    cor = [_t(rng.standard_normal((1, 2, 8, 8 >> i)).astype(np.float32)) for i in range(2)]
    disp = _t(rng.uniform(0, 6, (1, 2, 8, 1)).astype(np.float32))
    coords = _t(np.broadcast_to(np.arange(8, dtype=np.float32)[None, None, :, None],
                                (1, 2, 8, 1)).copy())
    g = _t(rng.standard_normal((1, 2, 8, 2 * 9 * 9)).astype(np.float32))
    meta_g, meta_c = [(v.shape, v.dtype) for v in geo], [(v.shape, v.dtype) for v in cor]
    want_geo, want_corr = geo_lookup_bwd_plain(meta_g, meta_c, disp, coords, g, 4)
    only_geo, none_corr = geo_lookup_bwd_plain(meta_g, meta_c, disp, coords, g, 4, need_corr=False)
    assert none_corr == [None, None]
    assert all(torch.equal(a, b) for a, b in zip(only_geo, want_geo))
    none_geo, only_corr = geo_lookup_bwd_plain(meta_g, meta_c, disp, coords, g, 4, need_geo=False)
    assert none_geo == [None, None]
    assert all(torch.equal(a, b) for a, b in zip(only_corr, want_corr))

    calls = []
    real = k4.geo_lookup_bwd_corr
    monkeypatch.setattr(k4, "geo_lookup_bwd_corr", lambda *a: calls.append(1) or real(*a))
    levels = [v.clone().requires_grad_(True) for v in geo]
    GeoLookup.apply(disp, coords, 4, 2, *levels, *cor).backward(g)
    assert calls == [] and all(v.grad is None for v in cor)
    assert all(torch.equal(v.grad, w) for v, w in zip(levels, want_geo))
    corr_levels = [v.clone().requires_grad_(True) for v in cor]
    GeoLookup.apply(disp, coords, 4, 2, *geo, *corr_levels).backward(g)
    assert calls == [1] and all(torch.equal(v.grad, w) for v, w in zip(corr_levels, want_corr))


# --- the model in train mode and the DKT step ---------------------------------------


def _randomize_norms(tree, rng):
    """Random batch-norm affines and statistics, so that frozen BN is not
    the identity."""
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


@pytest.fixture(scope="module")
def jax_setup():
    """Student variables (one train-mode init; random BN; disparity head x
    0.05), teacher variables (the student's parameters scaled by 1 + 0.02
    N(0, 1), so that the teachers agree at some pixels and the pseudo-label
    loss is not empty) and a batch with |GT| < max_disp."""
    rng = np.random.default_rng(0)
    model = JIGEVStereo(_jax_cfg(), iters=ITERS, test_mode=False)
    dummy = jnp.zeros((B, H, W, 3), jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), dummy, dummy)
    tree = jax.tree_util.tree_map(np.asarray, {k: dict(x) for k, x in v.items()})
    student = _randomize_norms(tree, rng)
    head = student["params"]["step"]["update_block"]["disp_head"]["conv2"]
    head["kernel"] = head["kernel"] * np.float32(0.05)
    teacher = {"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32),
        student["params"]), "batch_stats": student["batch_stats"]}
    batch = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = (-rng.uniform(0, 20, (B, H, W))).astype(np.float32)
    batch["valid"] = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    return [student, teacher], batch


_GRADS = {}


def _jax_grads(jax_setup, freeze):
    """JAX loss, outputs and student gradients of ``sequence_loss_igev``
    against the batch's GT, one compile per ``freeze_backbone``."""
    if freeze not in _GRADS:
        (student, _), batch = jax_setup
        cfg = _jax_cfg(freeze_backbone=freeze)
        model = JIGEVStereo(cfg, iters=ITERS, test_mode=False)
        loss_fn = _jax_loss(cfg)

        def f(params):
            out = model.apply({"params": params, "batch_stats": student["batch_stats"]},
                              batch["img1"], batch["img2"])
            return loss_fn(out, batch["flow"], batch["valid"])[0], out

        (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(student["params"])
        grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)},
                                     igev=True)
        _GRADS[freeze] = float(loss), {k: np.asarray(v) for k, v in out.items()}, grads
    return _GRADS[freeze]


def _port_model(variables, **kw):
    model = IGEVStereo(IGEVStereoConfig.from_dict(_config(**kw)), iters=ITERS, test_mode=False)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.train()


@pytest.mark.parametrize("remat", [True, False])
def test_train_forward_matches_jax(jax_setup, remat):
    """``{"init_disp": (B, H, W), "disp_preds": (iters, B, H, W)}`` of
    train.json's student (fp32, frozen batch norm with random statistics)
    with ``remat_iters`` on and off, against the JAX model with
    ``agg_packed`` (its packed aggregation; the port runs direct 3D convs):
    1e-3 px, the slice bound of tests/test_torch_igev.py."""
    (student, _), batch = jax_setup
    _, want, _ = _jax_grads(jax_setup, True)
    assert _jax_cfg().agg_packed
    model = _port_model(student, remat_iters=remat)
    out = model(_t(batch["img1"]), _t(batch["img2"]))
    assert set(out) == {"init_disp", "disp_preds"}
    assert out["init_disp"].shape == (B, H, W) and out["disp_preds"].shape == (ITERS, B, H, W)
    assert float(np.abs(want["disp_preds"]).max()) > 1.0  # the GRU moved the disparity
    for k in out:
        assert float((out[k].detach() - _t(want[k])).abs().max()) <= 1e-3, k


@pytest.mark.parametrize("freeze", [True, False])
def test_student_gradients_match_jax(jax_setup, freeze):
    """Gradients of sequence_loss_igev through the train-mode student (remat
    on, K4's backward as its plain version) vs ``jax.grad``, tensor by
    tensor, with the bound of tests/test_torch_train.py: L2 error <= 5e-3
    of the tensor's gradient norm plus 1e-7 of the global gradient norm
    (the rounding floor of gradients that are exactly 0, such as the biases
    of convs in front of instance norm). ``cost_agg`` and ``classifier``
    are reached only through the lookup's backward and the init term. With
    ``freeze_backbone`` the trunk has no gradient on either side; without,
    ``conv`` and ``desc`` are reached through the GWC volume and the
    correlation pyramid's backward, the feature net also through the
    attention maps."""
    (student, _), batch = jax_setup
    jloss, _, jgrads = _jax_grads(jax_setup, freeze)
    model = _port_model(student, remat_iters=True, freeze_backbone=freeze)
    out = model(_t(batch["img1"]), _t(batch["img2"]))
    loss = sequence_loss_igev(out["disp_preds"], out["init_disp"], _t(batch["flow"]),
                              _t(batch["valid"]), max_disp=SMALL["max_disp"])[0]
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    loss.backward()
    named = dict(model.named_parameters())
    assert set(named) <= set(jgrads) and len(named) > 300
    trunk = {k for k in named if k.startswith(TRUNK)}
    # the batch norm the reference creates and never runs; the bridge fills
    # its slot with BatchNorm's initial values, not a gradient
    unused = {k for k in named if k.startswith("cost_agg.conv1_up.bn.")}
    assert len(unused) == 2 and all(named[k].grad is None for k in unused)
    total = float(torch.stack([jgrads[k].norm() for k in named if k not in unused]).norm())
    for k, p in named.items():
        if k in unused:
            continue
        if freeze and k in trunk:
            assert p.grad is None and float(jgrads[k].abs().max()) == 0.0, k
            continue
        err = float((p.grad - jgrads[k]).norm())
        assert err <= 5e-3 * float(jgrads[k].norm()) + 1e-7 * total, (k, err)
    for prefix in ("cost_agg.", "classifier.") + (() if freeze else ("conv.", "desc.")):
        norm = torch.stack([p.grad.norm() for k, p in named.items()
                            if k.startswith(prefix) and k not in unused]).norm()
        assert float(norm) > 1e-4 * total, prefix


def test_cascade_upsample2x_matches_jax(rng):
    """The cascade's x2 nearest upsample with doubled values, of both
    disparity-valued fields of an IGEV output: exact."""
    out = {"init_disp": rng.standard_normal((B, 4, 6)).astype(np.float32),
           "disp_preds": rng.standard_normal((3, B, 4, 6)).astype(np.float32)}
    got = cascade_upsample2x({k: _t(v) for k, v in out.items()})
    want = _cascade_upsample2x({k: jnp.asarray(v) for k, v in out.items()})
    assert set(got) == set(want) == set(out)
    for k in out:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_dkt_step_matches_jax(jax_setup):
    """One whole DKT step of IGEV's train.json (fp32, plain lookup, remat,
    frozen backbone, frozen batch norm with random statistics; teacher
    weights near the student's) from the same weights, batch and F&E draws
    as the JAX step (``make_dkt_train_step`` with ``model_cls=IGEVStereo``
    and the registry's ``sequence_loss_igev`` adapter), under the bounds of
    tests/test_torch_train.py::test_dkt_step_matches_jax: losses and metrics
    (init_epe included) 1e-4 relative; every updated parameter within 2*lr,
    99.9 % within 1e-2*lr; BN statistics bit-identical; EMA to 1e-6. The
    trunk gets no gradient and moves by AdamW's weight decay alone, on both
    sides."""
    variables, batch = jax_setup
    hyper = dict(train_iters=ITERS, teacher_iters=ITERS, num_steps=100)
    cfg = _jax_cfg()
    _check_step_against_jax(variables, batch, hyper, jax.random.PRNGKey(3), config=_config(),
                            jcfg=cfg, model_cls=JIGEVStereo, loss_adapter=_jax_loss(cfg))
