"""The port's NeRF-Stereo loss and step vs the JAX package, on the CPU:
``ops/warp.py`` (``grid_sample_2d``, ``disp_warp`` and its gradient at and
past the borders, ``ssim``), ``losses/nerf.py`` (``photometric_loss``,
``trinocular_loss``, ``ns_loss``: values, metrics, masks and gradients) and
one whole ``train/ns_step.py`` step against
``dkt_stereo_tpu.train.ns_step.make_ns_train_step`` from the same weights,
in fp32, on a tiny RAFT (1 GRU layer of 16, 2 levels of radius 2, 2
iterations)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dkt_stereo_tpu.losses import nerf as jnerf
from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JConfig
from dkt_stereo_tpu.ops import warp as jwarp
from dkt_stereo_tpu.train import DKTHyperParams as JHyper
from dkt_stereo_tpu.train import create_dkt_state as jcreate_dkt_state
from dkt_stereo_tpu.train.ns_step import make_ns_train_step as jmake_ns_train_step
from dkt_stereo_tpu_torch.losses import nerf
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.ops import warp
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_batched_teachers import record_jax_mix_draws

ROOT = Path(__file__).resolve().parents[1]
NS = json.loads((ROOT / "configs/raft_stereo/ns.json").read_text())
TINY = {**NS, "mixed_precision": False, "corr_dtype": "float32", "corr_levels": 2,
        "corr_radius": 2, "n_gru_layers": 1, "hidden_dims": [16, 16, 16]}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _images(rng, *shape):
    return rng.uniform(0, 255, shape).astype(np.float32)


# --- ops/warp.py --------------------------------------------------------------------------------


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d_matches_jax(rng, padding_mode):
    """Normalized coordinates inside and up to 0.3 past [-1, 1], both
    ``align_corners``: within 1e-5 of 255 (measured: equal)."""
    img = _images(rng, 2, 24, 40, 3)
    coords = rng.uniform(-1.3, 1.3, (2, 20, 30, 2)).astype(np.float32)
    for align in (False, True):
        want = jwarp.grid_sample_2d(jnp.asarray(img), jnp.asarray(coords), align, padding_mode)
        got = warp.grid_sample_2d(_t(img), _t(coords), align, padding_mode)
        assert got.shape == (2, 20, 30, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=255e-5)


def _border_disp(rng, H, W, r2l):
    """A disparity whose sampling x (in pixels, after grid_sample's
    unnormalization) is, by column band: inside, exactly 0, exactly W - 1,
    in (-1, 0), in (W - 1, W), and 2-40 px past either border. For W = 64
    the sampling positions 0.4921875 and 62.5078125 give x = 0 and x = 63
    exactly in float32."""
    assert W == 64
    w = np.arange(W, dtype=np.float32)[None, None, :, None]
    gx = rng.uniform(1.0, W - 2.0, (2, H, W, 1)).astype(np.float32)
    bands = [0.4921875, 62.5078125, -0.3, 63.2, -2.0, -40.0, 66.0, 100.0]
    for i, v in enumerate(bands):
        gx[:, :, 4 + 6 * i: 8 + 6 * i] = v
    disp = gx - w if r2l else w - gx
    return disp.astype(np.float32), gx


@pytest.mark.parametrize("r2l", [False, True])
def test_disp_warp_and_its_gradient_match_jax(rng, r2l):
    """``disp_warp``'s warp and mask, and the gradient of a random
    cotangent's product with both with respect to ``disp``, against JAX,
    with sampling positions inside, at and past both borders. Values and
    gradients equal to JAX's within 1e-5 relative (measured: equal). At x =
    0 exactly the gradient is ``img[1] - img[0]`` as in JAX, where
    ``F.grid_sample(padding_mode="border")`` gives 0: the check has teeth."""
    H, W = 16, 64
    img = _images(rng, 2, H, W, 3)
    disp, gx = _border_disp(rng, H, W, r2l)
    x = (((2.0 * _t(gx) / (W - 1) - 1.0) + 1) * W - 1) * 0.5
    assert bool((x == 0).any()) and bool((x == W - 1).any())
    cot = rng.standard_normal((2, 2, H, W, 3)).astype(np.float32)

    def jloss(d):
        wv, m = jwarp.disp_warp(jnp.asarray(img), d, r2l=r2l)
        return (wv * cot[0]).sum() + (m * cot[1]).sum(), (wv, m)

    (_, (jw, jm)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(disp))
    d = _t(disp).requires_grad_(True)
    wv, m = warp.disp_warp(_t(img), d, r2l=r2l)
    ((wv * _t(cot[0])).sum() + (m * _t(cot[1])).sum()).backward()
    np.testing.assert_allclose(wv.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(d.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())
    assert np.abs(jgrad[(x == 0).numpy()]).min() > 0

    # F.grid_sample's border mode gives no gradient at x = 0 exactly
    d2 = _t(disp).requires_grad_(True)
    offset = 1.0 if r2l else -1.0
    xs = torch.arange(W, dtype=torch.float32)[None, None, :, None] + offset * d2
    ys = torch.arange(H, dtype=torch.float32)[None, :, None, None].expand(xs.shape)
    grid = torch.cat([2.0 * xs / (W - 1) - 1.0, 2.0 * ys / (H - 1) - 1.0], dim=-1)
    fw = F.grid_sample(_t(img).permute(0, 3, 1, 2), grid, padding_mode="border",
                       align_corners=False).permute(0, 2, 3, 1)
    (fw * _t(cot[0])).sum().backward()
    assert float(d2.grad[(x == 0)].abs().max()) == 0.0


def test_ssim_matches_jax(rng):
    """SSIM distance of random images and of an image against itself
    shifted (near 0, where the clip's bound matters) within 1e-5 (measured
    ~2e-6: average pooling sums in another order than JAX's convolution)."""
    a, b = _images(rng, 2, 20, 36, 3), _images(rng, 2, 20, 36, 3)
    shifted = np.roll(a, 1, axis=2)
    for x, y in ((a, b), (a, shifted), (a, a)):
        got = warp.ssim(_t(x), _t(y))
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(jwarp.ssim(jnp.asarray(x),
                                                                     jnp.asarray(y))),
                                   rtol=0, atol=1e-5)


# --- losses/nerf.py ------------------------------------------------------------------------------


def _ns_inputs(rng, N=3, B=2, H=32, W=48):
    """Predictions and a target in [-14, -2] px, a confidence in [0, 1]
    (about a third below the 0.5 threshold), a few targets past
    ``max_flow`` and a few positive (no confidence), the clean triplet."""
    target = -rng.uniform(2, 14, (B, H, W)).astype(np.float32)
    target[:, :3, :5] = -600.0  # |target| >= max_flow
    target[:, -2:, -4:] = 3.0  # positive: conf zeroed
    preds = (target[None] + rng.normal(0, 2, (N, B, H, W))).astype(np.float32)
    preds[:, :, :3, :5] = -rng.uniform(2, 14, (N, B, 3, 5))
    conf = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    ims = [_images(rng, B, H, W, 3) for _ in range(3)]
    return preds, target, conf, ims


def test_photometric_and_trinocular_loss_match_jax(rng):
    """``photometric_loss`` (B, H, W) and ``trinocular_loss`` with its
    gradient with respect to the disparity, within 1e-5 relative (measured
    ~1e-6)."""
    _, target, conf, (im0, im1, im2) = _ns_inputs(rng)
    disp = target[..., None]
    valid = (conf > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        nerf.photometric_loss(_t(im0), _t(im1)).numpy(),
        np.asarray(jnerf.photometric_loss(jnp.asarray(im0), jnp.asarray(im1))),
        rtol=1e-5, atol=1e-5)

    def jloss(d):
        return jnerf.trinocular_loss(d, jnp.asarray(im0), jnp.asarray(im1), jnp.asarray(im2),
                                     jnp.asarray(1 - conf), jnp.asarray(valid))

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(disp))
    d = _t(disp).requires_grad_(True)
    val = nerf.trinocular_loss(d, _t(im0), _t(im1), _t(im2), _t(1 - conf), _t(valid))
    val.backward()
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(d.grad.numpy(), jgrad, rtol=0, atol=1e-4 * np.abs(jgrad).max())


@pytest.mark.parametrize("alpha_photometric", [0.1, 0.0])
def test_ns_loss_matches_jax(rng, alpha_photometric):
    """``ns_loss`` at N = 3, B = 2, 32 x 48: the loss, the four metrics and
    the mask within 1e-5 relative (measured ~1e-7), the gradient with
    respect to the predictions within 1e-4 of its largest element (measured
    ~1e-6: reordered sums; an automask tie that flipped would move one
    pixel's term). An infinite target with a high confidence falls out of
    the mask (``|target| < max_flow``) and the loss stays JAX's; a NaN
    prediction makes ``ok`` false and the loss 0, as in JAX."""
    preds, target, conf, ims = _ns_inputs(rng)
    kw = dict(alpha_photometric=alpha_photometric, conf_threshold=0.5, max_flow=512.0)

    def jfn(p, t):
        loss, metrics, m, ok = jnerf.ns_loss(p, t, jnp.asarray(conf),
                                             *map(jnp.asarray, ims), **kw)
        return loss, (metrics, m, ok)

    (jl, (jm, jmask, jok)), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(preds), jnp.asarray(target))
    p = _t(preds).requires_grad_(True)
    loss, metrics, mask, ok = nerf.ns_loss(p, _t(target), _t(conf), *map(_t, ims), **kw)
    loss.backward()
    assert bool(ok) and bool(jok)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert set(metrics) == set(jm) == {"epe", "1px", "3px", "5px"}
    for k in metrics:
        assert float(metrics[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert np.array_equal(mask.numpy(), np.asarray(jmask)) and 0 < int(mask.sum()) < mask.numel()
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=0, atol=1e-4 * np.abs(jgrad).max())

    inf = target.copy()
    inf[0, 10, 10], conf_inf = -np.inf, conf.copy()
    conf_inf[0, 10, 10] = 0.9
    jl, _, jmask, jok = jnerf.ns_loss(jnp.asarray(preds), jnp.asarray(inf), jnp.asarray(conf_inf),
                                      *map(jnp.asarray, ims), **kw)
    loss, _, mask, ok = nerf.ns_loss(_t(preds), _t(inf), _t(conf_inf), *map(_t, ims), **kw)
    assert bool(ok) and bool(jok) and not bool(mask[0, 10, 10])
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    nan = preds.copy()
    nan[1, 0, 4, 4] = np.nan
    jl, _, _, jok = jnerf.ns_loss(jnp.asarray(nan), jnp.asarray(target), jnp.asarray(conf),
                                  *map(jnp.asarray, ims), **kw)
    loss, _, _, ok = nerf.ns_loss(_t(nan), _t(target), _t(conf), *map(_t, ims), **kw)
    assert not bool(ok) and not bool(jok) and float(loss) == float(jl) == 0.0


# --- train/ns_step.py ----------------------------------------------------------------------------

B_STEP, H, W, ITERS = 2, 32, 64, 2
HYPER = dict(train_iters=ITERS, teacher_iters=ITERS, num_steps=100, lr=2e-4)


def _port_weights(tree) -> dict:
    """The port's state dict of a flax tree. The port builds the modules of
    all three GRU layers as the reference does; the ones a 1-layer model
    never runs, absent from the flax tree, keep a seeded init."""
    return {**create_model(TINY, iters=ITERS, device="cpu", seed=0,
                           test_mode=False).state_dict(), **state_dict_from_flax(tree)}


@pytest.fixture(scope="module")
def ns_setup():
    """Variables of the tiny RAFT (random frozen-BN statistics, so that BN
    is not the identity) and a batch of 2 rows in the collate's form."""
    rng = np.random.default_rng(0)
    cfg = JConfig.from_dict({**TINY, "remat_iters": False})
    model = JRAFTStereo(cfg, iters=ITERS, test_mode=False)
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), dummy,
                                                               dummy))

    def stats(path, leaf):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, np.shape(leaf)).astype(np.float32)
        return (0.1 * rng.standard_normal(np.shape(leaf))).astype(np.float32)

    variables = {"params": v["params"],
                 "batch_stats": jax.tree_util.tree_map_with_path(stats, v["batch_stats"])}
    fwd = {k: _images(rng, B_STEP, H, W, 3) for k in ("im1_forward", "im2_forward")}
    bi = {"flow": -rng.uniform(0, 8, (B_STEP, H, W)).astype(np.float32),
          "valid": (rng.uniform(0, 1, (B_STEP, H, W)) > 0.2).astype(np.float32)}
    tri = {"flow": -rng.uniform(1, 8, (B_STEP, H, W)).astype(np.float32),
           "conf": rng.uniform(0.2, 1, (B_STEP, H, W)).astype(np.float32),
           **{k: _images(rng, B_STEP, H, W, 3) for k in ("im0", "im1", "im2")}}
    return cfg, variables, fwd, bi, tri


def _check_ns_step_against_jax(ns_setup, nb, nt, monkeypatch=None):
    """One NS step of the port against the JAX step (see
    :func:`test_ns_step_matches_jax`); with ``monkeypatch``, both models in
    ``mix_fmap_image``, the port's step passed the blend weight that the JAX
    model draws from the step's key."""
    cfg, variables, fwd, bi, tri = ns_setup
    config, step_kw = TINY, {}
    if monkeypatch is not None:
        config = {**TINY, "corr_implementation": "mix_fmap_image"}
        cfg = JConfig.from_dict({**config, "remat_iters": False})
        seen = record_jax_mix_draws(monkeypatch)
    batch = {k: v[:nb + nt] for k, v in fwd.items()}
    batch["bi"] = {k: v[:nb] for k, v in bi.items()} if nb else {}
    batch["tri"] = {k: v[:nt] for k, v in tri.items()}
    jhyper = JHyper(**HYPER)
    jstate = jcreate_dkt_state(cfg, jhyper, None, (nb + nt, H, W), params=variables,
                               teacher_params=variables)
    jstep = jmake_ns_train_step(cfg, jhyper, JRAFTStereo, nb=nb, nt=nt, num_hosts=1)
    jstate1, jmetrics = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                              jax.random.PRNGKey(1))
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    if monkeypatch is not None:
        assert len(seen) == 1 and 0 < seen[0] < 1
        step_kw = {"mix_weight": torch.tensor(seen[0])}
    jstate1 = jax.tree_util.tree_map(np.asarray, jstate1)

    sd = _port_weights(variables)
    state = create_dkt_state(config, DKTHyperParams(**HYPER), params=sd, device="cpu")
    bn = {k: v.clone() for k, v in state.student.state_dict().items() if "running" in k}
    parts = []
    state, metrics = make_ns_train_step(config, DKTHyperParams(**HYPER), nb=nb, nt=nt)(
        state, jax.tree_util.tree_map(_t, batch), mark=parts.append, **step_kw)

    assert parts == ["ema", "forward", "loss", "backward", "optimizer"]
    assert set(metrics) == set(jmetrics)
    assert metrics["ok"] == 1.0 and state.step == 1 and state.applied_steps == 1
    assert metrics["ns_loss"] > 0 and ("bi_epe" in metrics) == bool(nb)
    for k, v in metrics.items():
        assert v == pytest.approx(jmetrics[k], rel=1e-4), k
    lr = jmetrics["learning_rate"]
    want = state_dict_from_flax(jstate1.params)
    close = count = 0
    for k, p in state.student.named_parameters():
        if k not in want:  # a module a 1-layer model never runs
            continue
        d = (p.detach() - want[k]).abs()
        scale = 1e-6 * want[k].abs()
        assert bool((d <= 2 * lr + scale).all()), (k, float(d.max()))
        close += int((d <= 1e-2 * lr + scale).sum())
        count += d.numel()
    assert close >= 0.99 * count, close / count
    assert all(torch.equal(v, bn[k]) for k, v in state.student.state_dict().items()
               if "running" in k)
    ema_want = state_dict_from_flax(jstate1.ema_params)
    assert len(ema_want) > 100
    for k, v in ema_want.items():
        np.testing.assert_allclose(state.ema.state_dict()[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("nb,nt", [(1, 1), (0, 2)])
def test_ns_step_matches_jax(ns_setup, nb, nt):
    """One whole NS step (EMA, forward, ``sequence_loss_raft`` on the
    binocular row and ``ns_loss`` on the trinocular ones, backward, clip,
    AdamW at the OneCycle rate) against the JAX step from the same weights.
    Bounds: losses and metrics 1e-4 relative (the DKT step's,
    tests/test_torch_train.py); every updated parameter within 2 lr of
    JAX's plus 1e-6 relative, and 99 % of them within 1e-2 lr (measured
    99.59-99.62 %); BN statistics untouched; the EMA within 1e-6. The DKT
    step's test holds 99.9 % at full width. Here the student's gradients
    agree with JAX's to 1.4e-3 relative L2, with or without the
    photometric term (RAFT's fp32 chaos at random weights, not the loss),
    and 0.12 % of their elements differ in sign; Adam's first step moves
    each of those by about 2 lr, and this 16-wide model has a larger share
    of near-zero elements."""
    _check_ns_step_against_jax(ns_setup, nb, nt)


def test_ns_step_mix_fmap_image_matches_jax(ns_setup, monkeypatch):
    """``mix_fmap_image`` through the NS step. The JAX step gives the
    model its key as the ``mix`` rng, so the blend weight is a fresh U(0, 1)
    draw every step: passed that weight (read back from the JAX model's
    draw), the port's step matches the JAX step at
    :func:`test_ns_step_matches_jax`'s bounds. Without a weight the port's
    step draws one a step from its generator: a step from a generator's
    state equals the step passed that state's first U(0, 1) draw, and two
    steps take two draws."""
    _check_ns_step_against_jax(ns_setup, 1, 1, monkeypatch)
    _, variables, fwd, bi, tri = ns_setup
    config = {**TINY, "corr_implementation": "mix_fmap_image"}
    hyper = DKTHyperParams(**HYPER)
    batch = {**{k: _t(v[:1]) for k, v in fwd.items()},
             "bi": {}, "tri": {k: _t(v[:1]) for k, v in tri.items()}}

    def step(**kw):
        state = create_dkt_state(config, hyper, params=_port_weights(variables), device="cpu")
        step_fn = make_ns_train_step(config, hyper, nb=0, nt=1)
        return step_fn(state, batch, **kw)[1]["loss"]

    gen = torch.Generator().manual_seed(7)
    drawn = step(generator=gen)
    twin = torch.Generator().manual_seed(7)
    first, second = float(torch.rand((), generator=twin)), float(torch.rand((), generator=twin))
    assert drawn == step(mix_weight=first) != step(mix_weight=second)
    assert step(generator=gen) == step(mix_weight=second)


def test_ns_step_skips_update_when_not_ok(ns_setup):
    """A NaN in the forward images makes the predictions NaN: ok 0, loss 0, the
    student and the optimizer state as they were, the schedule not advanced,
    the step count and the EMA advanced (the JAX step's ``ok`` pick).
    ``num_hosts > 1`` raises naming its ROADMAP.md item."""
    _, variables, fwd, bi, tri = ns_setup
    hyper = DKTHyperParams(**HYPER)
    state = create_dkt_state(TINY, hyper, params=_port_weights(variables), device="cpu")
    step = make_ns_train_step(TINY, hyper, nb=0, nt=2)
    batch = {**{k: _t(v) for k, v in fwd.items()}, "bi": {},
             "tri": {k: _t(v) for k, v in tri.items()}}
    batch["im1_forward"][0, 5, 5, 1] = float("nan")
    before = {k: v.clone() for k, v in state.student.state_dict().items()}
    ema = {k: v.clone() for k, v in state.ema.state_dict().items()}
    state, m = step(state, batch)
    assert m["ok"] == 0.0 and m["loss"] == 0.0 and state.step == 1 and state.applied_steps == 0
    assert all(torch.equal(v, before[k]) for k, v in state.student.state_dict().items())
    assert not state.optimizer.state
    assert any(not torch.equal(v, ema[k]) for k, v in state.ema.state_dict().items()
               if v.is_floating_point())
    # num_hosts must be the process group's size (1 without a group)
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        make_ns_train_step(TINY, hyper, nb=2, nt=2, num_hosts=2)
