"""The port's PCVNet DKT slice vs the JAX package, on the CPU: K5's backward
(the plain version ``gaussian_row_sample_bwd_plain`` and the
``GaussianRowSample`` autograd function) against ``jax.vjp`` of the Pallas
``row_sample_pallas`` in interpret mode and of the XLA sampler;
``sequence_loss_pcvnet``; the motion encoder's gradients; PCVNet's
train-mode forward (base.json, remat on and off; fast.json; a cascade
second stage called with a flow tensor third), the student's gradients,
what the position gradient carries, ``cascade_upsample2x`` on an
``output_list``, and one whole DKT step from the same weights, batch and
draws.

The weights come from one JAX train-mode init of base.json at B=2, 32x128
(the 1/4 grid 8x32, pyramid widths 32/8/2); fast.json's tree differs only
in the mask head's last conv, which gets its own draw. Both sides run fp32; the JAX model runs
``corr_implementation="reg"`` (the XLA lookup) and no remat, 2 iterations
(teachers included).

Bounds, each relative to the largest magnitude of the compared quantity
unless stated: K5's backward 1e-4 in fp32 (the same two taps and
roundings, summed in another order) and one bf16 step (2^-8) for bf16
levels, which both sides sum in fp32 and round once; the loss and its
metrics 1e-6; the motion encoder 1e-5; the train-mode outputs 2e-2 px
(mixture weights 1e-3), the JAX package's bound between its XLA and
Pallas lookups after 2 iterations (tests/test_pallas_row_sample.py:61-80),
as in tests/test_torch_pcv.py; the student's gradients 0.1 relative L2 per
top-level module and 0.05 overall, the bound the card's step parity uses
(random-weight PCVNet's closed-form mixture updates amplify fp32
reordering); the DKT step the bounds of
tests/test_torch_train.py::test_dkt_step_matches_jax.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.losses.pcv import sequence_loss_pcvnet as jsequence_loss_pcvnet
from dkt_stereo_tpu.models import PCVNet as JPCVNet
from dkt_stereo_tpu.models import PCVNetConfig as JConfig
from dkt_stereo_tpu.models.registry import make_loss_adapter as jmake_loss_adapter
from dkt_stereo_tpu.nn.pcv import BasicMotionEncoderPCV as JMotionEncoder
from dkt_stereo_tpu.nn.pcv import gaussian_corr_pyramid as jgaussian_corr_pyramid
from dkt_stereo_tpu.ops.pallas.row_sample import row_sample_pallas
from dkt_stereo_tpu.ops.sampler import sample_row_1d as jsample_row_1d
from dkt_stereo_tpu.train.dkt_step import _cascade_upsample2x
from dkt_stereo_tpu_torch.losses.pcv import sequence_loss_pcvnet
from dkt_stereo_tpu_torch.models import pcvnet as pcv_model
from dkt_stereo_tpu_torch.models.pcvnet import PCVNet, PCVNetConfig
from dkt_stereo_tpu_torch.models.registry import make_loss_adapter
from dkt_stereo_tpu_torch.nn.pcv import BasicMotionEncoderPCV
from dkt_stereo_tpu_torch.ops.cuda import row_sample as k5
from dkt_stereo_tpu_torch.ops.cuda.row_sample import (
    GaussianRowSample, fold_lookup, gaussian_row_sample, gaussian_row_sample_bwd,
    gaussian_row_sample_bwd_plain, gaussian_row_sample_folded_plain, unfold_lookup)
from dkt_stereo_tpu_torch.train.dkt_step import cascade_upsample2x
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_pcv import _load, _mixture, _numpy_tree
from tests.test_torch_train import _check_step_against_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {n: json.loads((ROOT / f"configs/pcvnet/{n}.json").read_text()) for n in ("base", "fast")}
FP32 = {"mixed_precision": False}
B, H, W, ITERS = 2, 32, 128, 2
# the student's gradients run 4 iterations: the first update clips sigma's
# step at every pixel (init_sigma 32 at w = 1/4 gives d_sigma ~4 > 3), so
# the position gradient reaches the updater from the third lookup on
GRAD_ITERS = 4
G, S, L = 4, 9, 3
# the K5 backward cases sample 3 positions per Gaussian: the Pallas kernels
# unroll their loops over the K positions in interpret mode
K5_S = 3
K = G * K5_S
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODULES = ("cnet", "conv2", "context_zqr_convs", "FDM", "refineNet")


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _config(name="base", **kw):
    return {**CONFIGS[name], **FP32, **kw}


def _jax_cfg(name="base", **kw):
    return JConfig.from_dict(_config(name, corr_implementation="reg", remat_iters=False, **kw))


# --- K5 backward ---------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_vjps(pyr, pos, g, cf):
    """``jax.vjp`` of the level-major lookup at level-0 positions, through
    the Pallas kernel (interpret mode) and through the XLA sampler: each
    (dlevels..., dpos)."""
    def pallas(pyr, pos):
        return jnp.concatenate([row_sample_pallas(v, pos / cf**i, True)
                                for i, v in enumerate(pyr)], axis=-1)

    def xla(pyr, pos):
        return jnp.concatenate([jsample_row_1d(v, pos / cf**i) for i, v in enumerate(pyr)],
                               axis=-1)

    return tuple(jax.vjp(f, pyr, pos)[1](g) for f in (pallas, xla))


def _k5_case(rng, dtype, shape, cf, bf16_g=False):
    """A pyramid pooled from one (B, H, W1, W1) volume (its last level 2 wide
    at W1 37, cf 4), the level-0 positions mu + sigma*dx, dx = -1, 0, 1, of
    :func:`_mixture`'s mixture (negative, past the row, far out of range,
    exact integers on every level), and g."""
    Bk, Hk, W1 = shape
    vol = rng.standard_normal((Bk, Hk, W1, W1)).astype(np.float32)
    jpyr = [np.asarray(v) for v in jgaussian_corr_pyramid(jnp.asarray(vol), L, cf)]
    mu, sigma = _mixture(rng, Bk, Hk, W1, W1, cf)
    dx = np.arange(-(K5_S // 2), K5_S // 2 + 1, dtype=np.float32)
    pos = (mu[..., None] + sigma[..., None] * dx).reshape(Bk, Hk, W1, K).astype(np.float32)
    g = rng.standard_normal((Bk, Hk, W1, L * K)).astype(np.float32)
    if bf16_g:  # a bf16 cotangent, exact in fp32
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    jdt, tdt = DTYPES[dtype]
    want = [[np.asarray(jnp.asarray(d, jnp.float32)) for d in (*dl, dp)]
            for dl, dp in _jax_vjps(tuple(jnp.asarray(v).astype(jdt) for v in jpyr),
                                    jnp.asarray(pos), jnp.asarray(g), cf)]
    return [_t(v).to(tdt) for v in jpyr], _t(pos), _t(g), want


def _close_grads(got, want, dtype, label):
    """dvol per level: 1e-4 of its scale in fp32; in bf16 one bf16 step
    (2^-8) against the Pallas kernel, which sums in fp32 and rounds once,
    and 2^-5 against XLA's transpose, which rounds each of up to 2K
    scatter-adds to bf16; dpos (fp32 either way): 1e-4 of its scale."""
    errs = []
    for i, (d, w) in enumerate(zip(got, want)):
        scale = max(float(np.abs(w).max()), 1e-6)
        rel = 1e-4
        if dtype == "bfloat16" and i < len(got) - 1:
            rel = 2**-8 if label == "pallas" else 2**-5
        err = float(np.abs(d.float().numpy() - w).max())
        assert err <= rel * scale, (label, i, err, scale)
        errs.append(err / scale)
    return max(errs)


@pytest.mark.parametrize("dtype, shape, cf, g_dtype", [
    ("float32", (2, 1, 37), 4, "float32"),  # widths 37/9/2
    ("bfloat16", (2, 1, 37), 4, "float32"),
    ("float32", (1, 2, 40), 2, "float32"),  # fast.json's factor: 40/20/10
    ("bfloat16", (2, 1, 37), 4, "bfloat16"),  # the mixed-precision model's cotangent
])
def test_row_sample_bwd_plain_matches_jax(rng, dtype, shape, cf, g_dtype):
    """``gaussian_row_sample_bwd_plain`` (and the wrapper's CPU path, fed
    the cotangent folded as the motion encoder's input) vs ``jax.vjp`` of
    the Pallas kernel in interpret mode and of the XLA sampler: every
    level's dvol, shaped and typed as the level, and dpos through ``pos /
    cf^i``. Autograd of the folded lookup on the CPU, and
    ``GaussianRowSample``'s CPU backward with a folded cotangent in
    ``g_dtype`` (JAX fed the same values), give the same gradients."""
    levels, pos, g, (want_pallas, want_xla) = _k5_case(rng, dtype, shape, cf,
                                                       g_dtype == "bfloat16")
    gf = fold_lookup(g, L, G).to(DTYPES[g_dtype][1])
    n = gaussian_row_sample_bwd.launches
    dlevels, dpos = gaussian_row_sample_bwd(levels, pos, gf, cf, G)
    assert gaussian_row_sample_bwd.launches == n  # the CPU path launches nothing
    plain = gaussian_row_sample_bwd_plain(levels, pos, g, cf)
    assert all(torch.equal(a, b) for a, b in zip([*dlevels, dpos], [*plain[0], plain[1]]))
    assert [d.dtype for d in dlevels] == [levels[0].dtype] * L and dpos.dtype == torch.float32
    assert [d.shape for d in dlevels] == [v.shape for v in levels] and dpos.shape == pos.shape
    got = [*dlevels, dpos]
    errs = [_close_grads(got, w, dtype, name) for w, name in ((want_pallas, "pallas"),
                                                               (want_xla, "xla"))]
    print(f"K5 bwd plain twin {dtype} {shape} cf {cf} g {g_dtype}: max relative error vs "
          f"Pallas {errs[0]:.2e}, vs XLA {errs[1]:.2e}")
    if dtype == "bfloat16" and g_dtype == "float32":
        return  # autograd of the plain forward sums bf16 levels' gradients in bf16
    lv = [v.clone().requires_grad_(True) for v in levels]
    p = pos.clone().requires_grad_(True)
    if g_dtype == "float32":
        gaussian_row_sample(lv, p, cf, G).backward(gf)
    else:
        GaussianRowSample.apply(p, cf, G, torch.bfloat16, *lv).backward(gf)
    _close_grads([*(v.grad for v in lv), p.grad], [x.float().numpy() for x in got], dtype,
                 "autograd")


def test_row_sample_bwd_plain_nan_positions_match_jax(rng):
    """NaN positions among finite ones: the plain backward's NaN mask equals
    ``jax.vjp`` of the Pallas kernel's (interpret mode) in every level's
    dvol, where a NaN position makes its pixel's whole row NaN, and in dpos,
    where it gives 0; the other values within the bounds above."""
    levels, pos, g, _ = _k5_case(rng, "float32", (2, 1, 37), 4)
    pos = pos.clone()
    pos.view(-1)[[5, 40, 41, 300]] = float("nan")
    want = [np.asarray(jnp.asarray(d, jnp.float32)) for d in (
        lambda dl, dp: (*dl, dp))(*_jax_vjps(tuple(jnp.asarray(v.numpy()) for v in levels),
                                             jnp.asarray(pos.numpy()), jnp.asarray(g.numpy()),
                                             4)[0])]
    dlevels, dpos = gaussian_row_sample_bwd_plain(levels, pos, g, 4)
    got = [d.numpy() for d in (*dlevels, dpos)]
    nan_pix = torch.isnan(pos).any(-1).numpy()
    assert nan_pix.sum() == 3
    for i, (d, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.isnan(d), np.isnan(w))
        if i < L:
            assert np.isnan(d[nan_pix]).all() and not np.isnan(d[~nan_pix]).any()
    assert (got[-1][torch.isnan(pos).numpy()] == 0).all()
    _close_grads([torch.tensor(np.nan_to_num(d)) for d in got], [np.nan_to_num(w) for w in want],
                 "float32", "pallas")
    # the wrapper's CPU path and the autograd Function give the same NaN rows
    lv = [v.clone().requires_grad_(True) for v in levels]
    GaussianRowSample.apply(pos, 4, G, torch.float32, *lv).backward(fold_lookup(g, L, G))
    for v, w in zip(lv, want):
        np.testing.assert_array_equal(np.isnan(v.grad.numpy()), np.isnan(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_sample_bwd_plain_at_five_levels_matches_jax(dtype):
    """Five levels (cf 2, widths 37/18/9/4/2), which the backward kernel's
    former 4-level parameter block refused: the plain backward and the
    autograd Function's CPU path against ``jax.vjp`` of the Pallas kernel in
    interpret mode, every level's dvol and dpos, bounds as above."""
    r5 = np.random.default_rng(55)
    # one row and one sample a Gaussian: interpret mode unrolls over both
    Bk, Hk, W1, L5, cf, K1 = 1, 1, 37, 5, 2, G
    vol = r5.standard_normal((Bk, Hk, W1, W1)).astype(np.float32)
    jpyr = [np.asarray(v) for v in jgaussian_corr_pyramid(jnp.asarray(vol), L5, cf)]
    assert [v.shape[-1] for v in jpyr] == [37, 18, 9, 4, 2]
    pos = r5.uniform(-3, W1 + 3, (Bk, Hk, W1, K1)).astype(np.float32)
    pos.reshape(-1)[:4] = [0.0, 8.0, 36.0, -1.0]
    g = r5.standard_normal((Bk, Hk, W1, L5 * K1)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]

    def pallas(pyr, p):
        return jnp.concatenate([row_sample_pallas(v, p / cf**i, True)
                                for i, v in enumerate(pyr)], axis=-1)

    dl, dp = jax.vjp(pallas, tuple(jnp.asarray(v).astype(jdt) for v in jpyr),
                     jnp.asarray(pos))[1](jnp.asarray(g))
    want = [np.asarray(jnp.asarray(d, jnp.float32)) for d in (*dl, dp)]
    levels = [_t(v).to(tdt) for v in jpyr]
    dlevels, dpos = gaussian_row_sample_bwd_plain(levels, _t(pos), _t(g), cf)
    assert [d.dtype for d in dlevels] == [tdt] * L5
    _close_grads([*dlevels, dpos], want, dtype, "pallas")
    lv = [v.clone().requires_grad_(True) for v in levels]
    p = _t(pos).requires_grad_(True)
    GaussianRowSample.apply(p, cf, G, torch.float32, *lv).backward(fold_lookup(_t(g), L5, G))
    _close_grads([*(v.grad for v in lv), p.grad], want, dtype, "pallas")


def test_autograd_function_cpu_path_and_needs_input_grad(rng, monkeypatch):
    """``GaussianRowSample`` on CPU tensors: its plain forward and backward
    equal the plain versions bit for bit, with the incoming gradient in the
    folded layout and in NCHW (the CPU path reads either; only the card
    copies to the folded layout, and counts it); it asks the backward only
    for what ``needs_input_grad`` names (levels only, positions only, one
    level of three), and returns None for the rest."""
    levels, pos, g, _ = _k5_case(rng, "float32", (2, 1, 37), 4)
    want_levels, want_pos = gaussian_row_sample_bwd_plain(levels, pos, g, 4)
    calls = []
    real = k5.gaussian_row_sample_bwd

    def spy(*args, **kw):
        calls.append((kw["need_vol"], kw["need_pos"]))
        return real(*args, **kw)

    monkeypatch.setattr(k5, "gaussian_row_sample_bwd", spy)
    folded = fold_lookup(g, L, G)
    nchw = folded.contiguous()
    assert not nchw.is_contiguous(memory_format=torch.channels_last)
    copies = real.g_copies
    for (lv_grad, pos_grad), gin in zip((([True] * L, True), ([True] * L, False),
                                         ([False] * L, True), ([False, True, False], False)),
                                        (folded, nchw, folded, nchw)):
        lv = [v.clone().requires_grad_(r) for v, r in zip(levels, lv_grad)]
        p = pos.clone().requires_grad_(pos_grad)
        out = GaussianRowSample.apply(p, 4, G, torch.float32, *lv)
        assert torch.equal(out.detach(), gaussian_row_sample_folded_plain(levels, pos, 4, G))
        out.backward(gin)
        assert calls.pop() == (any(lv_grad), pos_grad)
        for v, r, w in zip(lv, lv_grad, want_levels):
            assert (v.grad is None) if not r else torch.equal(v.grad, w)
        assert (p.grad is None) if not pos_grad else torch.equal(p.grad, want_pos)
    assert real.g_copies == copies
    with pytest.raises(ValueError, match="gaussian_row_sample_bwd: g must be"):
        gaussian_row_sample_bwd(levels, pos, g, 4, G)  # unfolded
    assert torch.equal(unfold_lookup(folded, L, G), g)
    assert gaussian_row_sample_bwd(levels, pos, folded, 4, G, need_vol=False,
                                   need_pos=False) == (None, None)


# --- the loss ------------------------------------------------------------------------


def _outputs(rng, n, Bl=2, Hl=6, Wl=10):
    gt = (-rng.uniform(0, 30, (Bl, Hl, Wl))).astype(np.float32)
    near = -gt + rng.uniform(-2, 2, gt.shape)  # straddles the smooth-L1 knee
    refined = near.astype(np.float32)
    disp_seq = (-gt + rng.uniform(-8, 8, (n, *gt.shape))).astype(np.float32)
    mu_seq = (-gt[..., None] + rng.uniform(-20, 20, (n, *gt.shape, G))).astype(np.float32)
    w = rng.uniform(0.05, 1, (n, *gt.shape, G))
    w_seq = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    sigma_seq = rng.uniform(0.1, 16, (n, *gt.shape, G)).astype(np.float32)
    # beyond max_disp, a negative disparity (positive flow), NaN and inf:
    # all masked out
    gt[0, 0, :4] = [-600.0, 5.0, np.nan, -np.inf]
    valid = (rng.uniform(0, 1, gt.shape) > 0.3).astype(np.float32)
    return [refined, disp_seq, mu_seq, w_seq, sigma_seq], gt, valid


@pytest.mark.parametrize("n", [3, 8])
def test_sequence_loss_pcvnet_matches_jax(rng, n):
    """Loss, all fourteen metrics, mask and ok against JAX, with fewer and
    more than six iterations (the weights clamp at 1.4); then a NaN in the
    disparities, the means or the refined disparity (ok false, loss
    zeroed), and a NaN in w or sigma, which ok does not read. The registry's
    adapter reads ``output_list``. fp32 sums in another order: 1e-6
    relative."""
    outs, gt, valid = _outputs(rng, n)
    cases = [(outs, True)]
    for i in range(5):
        bad = [o.copy() for o in outs]
        bad[i].reshape(-1)[7] = np.nan
        cases.append((bad, i >= 3))
    adapter = make_loss_adapter("PCVNet", CONFIGS["base"])
    for out, want_ok in cases:
        loss, metrics, mask, ok = sequence_loss_pcvnet([_t(o) for o in out], _t(gt), _t(valid))
        jloss, jmetrics, jmask, jok = jsequence_loss_pcvnet([jnp.asarray(o) for o in out],
                                                            jnp.asarray(gt), jnp.asarray(valid))
        assert ok.dim() == 0 and bool(ok) == bool(jok) == want_ok
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        assert list(metrics) == list(jmetrics) and len(metrics) == 14
        if want_ok:
            assert float(loss) > 0
            for k in metrics:
                np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6,
                                           atol=1e-7, err_msg=k)
        else:
            assert float(loss) == 0.0
        via = adapter({"output_list": [_t(o) for o in out]}, _t(gt), _t(valid))
        assert float(via[0]) == float(loss) and bool(via[3]) == bool(ok)


# --- the motion encoder and the cascade transform ------------------------------------------


def test_motion_encoder_gradients_match_jax(rng):
    """The parameter branch passes no gradient to w and sigma (JAX's
    stop_gradient, nn/pcv.py:154-156), while mu, the lookup and the
    weights get theirs: ``jax.grad`` of a random projection of the output,
    1e-5 of each gradient's scale."""
    Bm, Hm, Wm = 1, 6, 10
    mu = rng.uniform(0, 40, (Bm, Hm, Wm, G)).astype(np.float32)
    sigma = rng.uniform(0.1, 16, (Bm, Hm, Wm, G)).astype(np.float32)
    w = rng.uniform(0.05, 1, (Bm, Hm, Wm, G)).astype(np.float32)
    corr = rng.standard_normal((Bm, Hm, Wm, L * G * S)).astype(np.float32)
    proj = rng.standard_normal((Bm, Hm, Wm, 48 * G + 64)).astype(np.float32)
    args = (mu, corr, w, sigma)
    jm = JMotionEncoder(G, S, L, jnp.float32)
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in args)))

    def f(params, *xs):
        return jnp.sum(jm.apply({"params": params}, *xs) * proj)

    jgrads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(v["params"], *(jnp.asarray(a) for a in args))
    port = _load(BasicMotionEncoderPCV(G, S, L), v, "step.FDM.encoder")
    targs = [_nchw(mu), _t(corr), _nchw(w), _nchw(sigma)]
    for t in targs:
        t.requires_grad_(True)
    # the encoder reads the lookup folded; its gradient flows back unfolded
    (port(targs[0], fold_lookup(targs[1], L, G), *targs[2:]) * _nchw(proj)).sum().backward()
    assert float(np.abs(np.asarray(jgrads[3])).max()) == 0.0  # w
    assert float(np.abs(np.asarray(jgrads[4])).max()) == 0.0  # sigma
    for t, want in zip(targs, jgrads[1:]):
        got = np.zeros(want.shape, np.float32) if t.grad is None else t.grad.numpy()
        if got.ndim == 4 and got.shape != want.shape:
            got = got.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=1e-5 * max(float(np.abs(want).max()), 1e-6))
    named = dict(port.named_parameters())
    sd = state_dict_from_flax({"params": {"step": {"FDM": {"encoder": jax.tree_util.tree_map(
        np.asarray, jgrads[0])}}}})
    for k, want in sd.items():
        p = named[k.removeprefix("FDM.encoder.")]
        np.testing.assert_allclose(p.grad.numpy(), want.numpy(),
                                   atol=1e-5 * max(float(want.abs().max()), 1e-6), err_msg=k)


def test_cascade_upsample2x_output_list_matches_jax(rng):
    """The cascade's x2 nearest upsample of a PCVNet train output: the
    refined and per-iteration disparities, mu and sigma doubled, w not, and
    ``disp_preds`` doubled: exact."""
    outs, _, _ = _outputs(rng, 3)
    out = {"disp_preds": -outs[0][None], "output_list": outs}
    got = cascade_upsample2x({"disp_preds": _t(out["disp_preds"]),
                              "output_list": tuple(_t(o) for o in outs)})
    want = _cascade_upsample2x({"disp_preds": jnp.asarray(out["disp_preds"]),
                                "output_list": tuple(jnp.asarray(o) for o in outs)})
    assert set(got) == set(want) == {"disp_preds", "output_list"}
    np.testing.assert_array_equal(got["disp_preds"].numpy(), np.asarray(want["disp_preds"]))
    assert len(got["output_list"]) == 5
    for g, w in zip(got["output_list"], want["output_list"]):
        assert g.shape[-3:-1] == (12, 20) or g.shape[-2:] == (12, 20)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the model in train mode and the DKT step ---------------------------------------------


@pytest.fixture(scope="module")
def jax_setup():
    """Student variables of base.json and fast.json (one train-mode JAX
    init; fast.json's mask head its own draw), teacher variables (the
    student's parameters scaled by 1 + 0.02 N(0, 1)) and a batch with GT in
    [0, 40) px. The batch norms keep their init, as in
    tests/test_torch_pcv.py: with random statistics, a 1e-7 relative nudge
    of the weights moves the port's own disparity by 0.2 px after 2
    iterations, ten times the bound."""
    rng = np.random.default_rng(0)
    model = JPCVNet(_jax_cfg(), ITERS, test_mode=False)
    dummy = jnp.zeros((B, H, W, 3), jnp.float32)
    base = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), dummy, dummy))
    fast = jax.tree_util.tree_map(lambda a: a, base)
    head = dict(base["params"]["step"]["FDM"]["mask_conv2"])
    k = head["kernel"]
    head["kernel"] = (float(k.std()) * rng.standard_normal((*k.shape[:3], 64 * 9))
                      ).astype(np.float32)
    head["bias"] = np.zeros(64 * 9, np.float32)
    fast["params"]["step"]["FDM"] = {**fast["params"]["step"]["FDM"], "mask_conv2": head}
    teacher = {"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32),
        base["params"]), "batch_stats": base["batch_stats"]}
    batch = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = (-rng.uniform(0, 40, (B, H, W))).astype(np.float32)
    batch["valid"] = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    return {"base": base, "fast": fast, "teacher": teacher}, batch


def _jax_out(variables, batch, name="base", **kw):
    """The JAX model's train-mode outputs at ITERS iterations."""
    model = JPCVNet(_jax_cfg(name), ITERS, test_mode=False, **kw)
    return jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(
        variables[name], *(jnp.asarray(batch[k]) for k in ("img1", "img2"))))


def _port_model(variables, name="base", cascade=False, iters=ITERS, **kw):
    model = PCVNet(PCVNetConfig.from_dict(_config(name, **kw)), iters=iters, test_mode=False,
                   cascade=cascade)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.train()


def _close_outputs(got, want):
    """The five outputs (and a cascade's init_params): 2e-2 px, w 1e-3."""
    refined, disp_seq, mu_seq, w_seq, sigma_seq = got["output_list"]
    assert refined.shape == (B, H, W) and disp_seq.shape == (ITERS, B, H, W)
    assert mu_seq.shape == w_seq.shape == sigma_seq.shape == (ITERS, B, H, W, G)
    assert float(np.abs(want["output_list"][1]).max()) > 5.0  # the iterations moved the mixture
    errs = {}
    for name, g, w in zip(("refined", "disp", "mu", "w", "sigma"), got["output_list"],
                          want["output_list"]):
        errs[name] = float((g.detach() - _t(w)).abs().max())
        assert errs[name] <= (1e-3 if name == "w" else 2e-2), (name, errs[name])
    np.testing.assert_array_equal(got["disp_preds"].detach().numpy(),
                                  -got["output_list"][0].detach().numpy()[None])
    return errs


@pytest.mark.parametrize("remat", [True, False])
def test_train_forward_matches_jax(jax_setup, remat):
    """base.json's train-mode outputs (fp32, frozen batch norm with random
    statistics) with ``remat_iters`` on and off against the JAX model: the
    refined disparity and the per-iteration mixture disparity, mu, w and
    sigma."""
    variables, batch = jax_setup
    want = _jax_out(variables, batch)
    out = _port_model(variables["base"], remat_iters=remat)(_t(batch["img1"]), _t(batch["img2"]))
    assert set(out) == {"disp_preds", "output_list"}
    errs = _close_outputs(out, want)
    print(f"PCVNet train forward (remat {remat}) vs JAX: " + " ".join(
        f"{k} {e:.2e}" for k, e in errs.items()))


def test_fast_and_cascade_second_stage_match_jax(jax_setup):
    """fast.json's train-mode outputs (forward only); then base.json's
    cascade second stage in train mode, called as the DKT step calls a
    student, with a flow tensor third (ignored on both sides) and a
    coarser stage's mixture dict fourth: the five outputs and
    ``init_params``."""
    variables, batch = jax_setup
    img1, img2 = (jnp.asarray(batch[k]) for k in ("img1", "img2"))
    want = _jax_out(variables, batch, "fast")
    with torch.no_grad():
        got = _port_model(variables["fast"], "fast")(_t(img1), _t(img2))
    _close_outputs(got, want)

    rng = np.random.default_rng(3)
    w = rng.uniform(0.05, 1, (B, H // 2, W // 2, G))
    init = {"mu": rng.uniform(0, 40, (B, H // 2, W // 2, G)).astype(np.float32),
            "sigma": rng.uniform(1, 8, (B, H // 2, W // 2, G)).astype(np.float32),
            "w": (w / w.sum(-1, keepdims=True)).astype(np.float32)}
    init["disp"] = (init["mu"] * init["w"]).sum(-1, keepdims=True)
    flow = (-rng.uniform(0, 10, (B, H // 4, W // 4, 1))).astype(np.float32)
    model = JPCVNet(_jax_cfg(), ITERS, test_mode=False, cascade=True)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(model.apply)(
        variables["base"], img1, img2, jnp.asarray(flow),
        {k: jnp.asarray(v) for k, v in init.items()}))
    with torch.no_grad():
        got = _port_model(variables["base"], cascade=True)(
            _t(img1), _t(img2), _t(flow), {k: _t(v) for k, v in init.items()})
    assert set(got) == set(want) == {"disp_preds", "output_list", "init_params"}
    _close_outputs(got, want)
    for k, v in got["init_params"].items():
        assert v.shape == want["init_params"][k].shape, k
        assert float((v - _t(want["init_params"][k])).abs().max()) <= (1e-3 if k == "w" else 2e-2)


def _rel_by_module(named, want):
    err2, norm2 = {}, {}
    for k, p in named.items():
        group = k.split(".")[0]
        err2[group] = err2.get(group, 0.0) + float((p.grad - want[k]).square().sum())
        norm2[group] = norm2.get(group, 0.0) + float(want[k].square().sum())
    rel = {g: (err2[g] / norm2[g]) ** 0.5 for g in err2}
    rel["all"] = (sum(err2.values()) / sum(norm2.values())) ** 0.5
    return rel


def _jax_grads(variables, batch):
    """JAX loss and student gradients of ``sequence_loss_pcvnet`` against
    the batch's GT, base.json at GRAD_ITERS iterations."""
    cfg = _jax_cfg()
    model = JPCVNet(cfg, GRAD_ITERS, test_mode=False)
    loss_fn = jmake_loss_adapter("PCVNet", cfg)
    v = variables["base"]

    def f(params):
        out = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                          batch["img1"], batch["img2"])
        return loss_fn(out, batch["flow"], batch["valid"])[0]

    loss, grads = jax.jit(jax.value_and_grad(f))(v["params"])
    return float(loss), state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})


def _student_grads(variables, batch, **kw):
    model = _port_model(variables["base"], iters=GRAD_ITERS, **kw)
    out = model(_t(batch["img1"]), _t(batch["img2"]))
    loss = sequence_loss_pcvnet(out["output_list"], _t(batch["flow"]), _t(batch["valid"]))[0]
    loss.backward()
    return float(loss.detach()), {k: p for k, p in model.named_parameters()}


def test_student_gradients_match_jax(jax_setup):
    """Gradients of sequence_loss_pcvnet through the train-mode student at 4
    iterations (K5's backward as autograd of its plain version) vs
    ``jax.grad``, by top-level module: 0.1 relative L2 each, 0.05 overall
    (measured <= 2.6e-3); every parameter gets a gradient. With
    ``remat_iters`` the gradients are identical."""
    variables, batch = jax_setup
    jloss, jgrads = _jax_grads(variables, batch)
    loss, named = _student_grads(variables, batch)
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert set(named) <= set(jgrads) and all(p.grad is not None for p in named.values())
    rel = _rel_by_module(named, jgrads)
    print("PCVNet student gradients vs jax.grad, relative L2 by module: "
          + " ".join(f"{g} {e:.2e}" for g, e in rel.items()))
    assert set(rel) == {*MODULES, "all"}
    for g, e in rel.items():
        assert e <= (0.05 if g == "all" else 0.1), (g, e)
    _, remat = _student_grads(variables, batch, remat_iters=True)
    for k, p in named.items():
        assert torch.equal(p.grad, remat[k].grad), k


def test_position_gradient_reaches_the_updater(jax_setup, monkeypatch):
    """What K5's position gradient carries: the same student's gradients at
    4 iterations with the positions cut from the graph (a ``pos.detach()``
    in front of the lookup) move by more than the step-parity bound (0.1
    relative L2) in the update block, which sets sigma (measured 0.34, and
    0.30 overall), while the loss is unchanged and RefineNet, which reads
    the mixture detached, gets the same gradient."""
    variables, batch = jax_setup
    loss, named = _student_grads(variables, batch)
    want = {k: p.grad for k, p in named.items()}
    real = pcv_model.gaussian_row_sample
    monkeypatch.setattr(pcv_model, "gaussian_row_sample",
                        lambda levels, pos, *args: real(levels, pos.detach(), *args))
    cut_loss, cut = _student_grads(variables, batch)
    assert cut_loss == loss
    rel = _rel_by_module(cut, want)
    print("gradient change with the position gradient cut, relative L2 by module: "
          + " ".join(f"{g} {e:.2e}" for g, e in rel.items()))
    assert rel["FDM"] > 0.1
    assert rel["refineNet"] == 0.0  # it reads the mixture detached


def test_dkt_step_matches_jax(jax_setup):
    """One whole DKT step of base.json in train mode (fp32, frozen batch norm
    with random statistics; teacher weights near the student's) from the
    same weights, batch and F&E draws as the JAX step
    (``make_dkt_train_step`` with ``model_cls=PCVNet`` and the registry's
    ``sequence_loss_pcvnet`` adapter), under the bounds of
    tests/test_torch_train.py::test_dkt_step_matches_jax: losses and all the
    metrics 1e-4 relative; every updated parameter within 2*lr, 99.9 %
    within 1e-2*lr; BN statistics bit-identical; EMA to 1e-6."""
    variables, batch = jax_setup
    cfg = _jax_cfg()
    _check_step_against_jax([variables["base"], variables["teacher"]], batch,
                            dict(train_iters=ITERS, teacher_iters=ITERS, num_steps=100),
                            jax.random.PRNGKey(3), config=_config(), jcfg=cfg,
                            model_cls=JPCVNet, loss_adapter=jmake_loss_adapter("PCVNet", cfg))
