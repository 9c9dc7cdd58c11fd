"""The port's DKT fine-tune slice vs the JAX package, on the CPU: the loss,
F&E, EMA, schedule and optimizer, K1's backward (plain version and the
``CorrLookup`` autograd function), RAFT-Stereo's train-mode forward and
gradients, and one whole DKT step from the same weights, batch and draws.

The JAX side runs ``corr_implementation="reg"`` (the plain lookup), except
for the K1-backward tests, which take ``jax.vjp`` of ``corr_lookup_pallas``
in interpret mode. The port's CPU path is the plain version of every
kernel. Both sides run fp32. With random weights RAFT is chaotic after a
few GRU iterations, so the model runs 2 iterations (teachers included).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dkt_stereo_tpu.dkt.ema import ema_update as jema_update
from dkt_stereo_tpu.dkt.fande import fande_ensemble as jfande_ensemble
from dkt_stereo_tpu.dkt.fande import fande_filter as jfande_filter
from dkt_stereo_tpu.losses.sequence import sequence_loss_raft as jsequence_loss_raft
from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JConfig
from dkt_stereo_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from dkt_stereo_tpu.train import DKTHyperParams as JHyper
from dkt_stereo_tpu.train import create_dkt_state as jcreate_dkt_state
from dkt_stereo_tpu.train import make_dkt_train_step as jmake_dkt_train_step
from dkt_stereo_tpu.train.state import make_optimizer as jmake_optimizer
from dkt_stereo_tpu.train.state import onecycle_linear as jonecycle_linear
from dkt_stereo_tpu_torch.dkt.ema import ema_update
from dkt_stereo_tpu_torch.dkt.fande import fande_ensemble, fande_filter
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.models.registry import make_loss_adapter
from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import CorrLookup, corr_lookup_bwd_plain
from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import EncoderStage, encoder_stage
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
from dkt_stereo_tpu_torch.train.state import (
    DKTHyperParams,
    clip_by_global_norm_,
    make_optimizer,
    onecycle_linear,
)
from dkt_stereo_tpu_torch.weights import dkt_state_from_flax, state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
TRAIN = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
FP32 = {"mixed_precision": False, "corr_dtype": "float32"}
B, H, W, ITERS = 2, 32, 64, 2


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


# --- loss, F&E, EMA, schedule, optimizer -------------------------------------


def test_sequence_loss_raft_matches_jax(rng):
    """Loss, metrics, mask and ok on 3 iterations with invalid, out-of-range
    and NaN GT pixels (masked out, so ok stays true), then a NaN prediction
    (ok false, loss zeroed). fp32 sums in another order: 1e-6 relative."""
    preds = (-rng.uniform(0, 30, (3, B, 8, 12))).astype(np.float32)
    gt = (-rng.uniform(0, 30, (B, 8, 12))).astype(np.float32)
    gt[0, 0, :3] = [-800.0, np.nan, np.inf]
    valid = (rng.uniform(0, 1, (B, 8, 12)) > 0.3).astype(np.float32)
    for p in (preds, np.where(np.arange(12) == 5, np.nan, preds).astype(np.float32)):
        loss, metrics, mask, ok = sequence_loss_raft(_t(p), _t(gt), _t(valid))
        jloss, jmetrics, jmask, jok = jsequence_loss_raft(jnp.asarray(p), jnp.asarray(gt),
                                                          jnp.asarray(valid))
        assert ok.dim() == 0 and ok.dtype == torch.bool and bool(ok) == bool(jok)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        assert set(metrics) == set(jmetrics) == {"epe", "1px", "3px", "5px"}
        for k in metrics:
            if bool(ok):
                np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-6)
    assert float(loss) == 0.0


def test_fande_matches_jax_with_its_draws(rng):
    """Both F&E functions, fed the uniforms the JAX step draws from its key
    split (train/dkt_step.py:138); GT path with withprob and clamp, PL path
    plain. Image 0 is 97% consistent and image 1 3%, so with these draws
    image 0's inconsistent pixels are re-admitted and image 1's are not.
    Exact up to fp32 rounding: 1e-6."""
    k_fgt, k_egt, _, k_epl, _, _ = jax.random.split(jax.random.PRNGKey(7), 6)
    u = np.asarray(jax.random.uniform(k_fgt, (B,)))
    assert u[0] < 0.95 and u[1] > 0.05
    prob_gt = float(jax.random.uniform(k_egt, ()))
    prob_pl = float(jax.random.uniform(k_epl, ()))
    shape = (B, 16, 24)
    ema = (-rng.uniform(0, 40, shape)).astype(np.float32)
    frac = np.array([0.97, 0.03])[:, None, None]
    step = np.where(rng.uniform(0, 1, shape) < frac, rng.uniform(0, 2.9, shape), 10.0)
    gt = (ema + np.sign(rng.uniform(-1, 1, shape)) * step).astype(np.float32)
    pl = (ema + rng.uniform(-4, 4, shape)).astype(np.float32)
    valid = (rng.uniform(0, 1, shape) > 0.2).astype(np.float32)

    src, v = fande_filter(_t(gt), _t(ema), _t(valid), u=_t(u), withprob=True, threshold=3.0)
    jsrc, jv = jfande_filter(jnp.asarray(gt), jnp.asarray(ema), jnp.asarray(valid), k_fgt,
                             withprob=True, threshold=3.0)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), rtol=1e-6)
    out = fande_ensemble(src, _t(ema), v, prob=prob_gt, clamp=1.0)
    jout = jfande_ensemble(jsrc, jnp.asarray(ema), jv, k_egt, clamp=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    consistent = valid * (np.abs(gt - ema) < 3)
    assert (v[0].numpy() == valid[0]).all() and (v[1].numpy() == consistent[1]).all()
    assert (consistent[0] != valid[0]).any()

    psrc, pv = fande_filter(_t(pl), _t(ema), torch.ones_like(_t(pl)))
    jpsrc, jpv = jfande_filter(jnp.asarray(pl), jnp.asarray(ema), jnp.ones(pl.shape), k_fgt)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    pout = fande_ensemble(psrc, _t(ema), pv, prob=prob_pl)
    jpout = jfande_ensemble(jpsrc, jnp.asarray(ema), jpv, k_epl)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jpout), rtol=1e-6, atol=1e-6)


def test_ema_update_matches_jax(rng):
    """Lerp of every float parameter and buffer; ``num_batches_tracked``
    untouched. One fp32 rounding apart at most: 1e-6 relative."""
    teacher, student = (torch.nn.BatchNorm2d(4) for _ in range(2))
    with torch.no_grad():
        for m in (teacher, student):
            for t in [*m.parameters(), m.running_mean, m.running_var]:
                t.copy_(_t(rng.standard_normal(4).astype(np.float32)))
    student.num_batches_tracked.fill_(5)
    def floats(m):
        return {k: v.numpy() for k, v in m.state_dict().items() if v.is_floating_point()}

    want = jema_update(floats(teacher), floats(student), 0.9)
    ema_update(teacher, student, 0.9)
    for k, v in want.items():
        np.testing.assert_allclose(teacher.state_dict()[k].numpy(), np.asarray(v), rtol=1e-6)
    assert int(teacher.num_batches_tracked) == 0


def test_onecycle_linear_matches_jax_at_every_step():
    """Every count of a 1,100-step schedule and past its end; the same fp32
    arithmetic, so at most one rounding apart: 1e-6 relative."""
    total = 1_100
    counts = np.arange(total + 10)
    got = onecycle_linear(2e-4, total)(counts)
    want = np.asarray(jonecycle_linear(2e-4, total)(jnp.asarray(counts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert onecycle_linear(2e-4, total)(0) == pytest.approx(8e-6)


@pytest.mark.parametrize("grad_scale", [10.0, 0.01])
def test_clipped_adamw_matches_optax(rng, grad_scale):
    """Two steps of global-norm clipping + AdamW against optax's chain on a
    small tree, with the gradients' global norm above 1 (clipped) or below
    it (kept). Same formulas on the same fp32 values, summed in another
    order: parameters within 1e-6 of the learning rate plus two fp32 ulps
    (3e-7 relative)."""
    hyper = DKTHyperParams(lr=1e-3, wdecay=1e-2, num_steps=50)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    tx, _ = jmake_optimizer(JHyper(lr=1e-3, wdecay=1e-2, num_steps=50))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(_t(v)) for k, v in params.items()})
    opt, schedule = make_optimizer(module, hyper)
    for step, g in enumerate(grads):
        jgrads = {k: jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(jgrads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = _t(g[k])
        norm = clip_by_global_norm_([p.grad for p in module.values()], 1.0)
        assert (float(norm) > 1.0) == (grad_scale > 1.0)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=3e-7, atol=1e-6 * hyper.lr)


# --- K1 backward --------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def k1_case(request):
    """Inputs at 1x4x16, r=4, 4 levels (coordinates far out of range
    included) and ``jax.vjp`` of the Pallas lookup (interpret mode), per
    pyramid dtype."""
    return request.param, _k1_inputs(np.random.default_rng(0), request.param)


def _k1_inputs(rng, dtype):
    Wl = 16
    pyr = [rng.standard_normal((1, 4, Wl, Wl >> i)).astype(np.float32) for i in range(4)]
    coords = rng.uniform(-6, Wl + 6, (1, 4, Wl, 1)).astype(np.float32)
    flat = coords.reshape(-1)
    flat[:10] = [-1e9, 1e9, -1.0, -0.75, 0.0, 5.0, Wl - 1.0, Wl - 0.5, Wl, 3e7]
    g = rng.standard_normal((1, 4, Wl, 36)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jpyr = tuple(jnp.asarray(v, jdt) for v in pyr)
    _, vjp = jax.vjp(lambda *p: corr_lookup_pallas(p, jnp.asarray(coords), 4, True), *jpyr)
    want = [np.asarray(d.astype(jnp.float32)) for d in vjp(jnp.asarray(g))]
    assert [d.dtype for d in vjp(jnp.asarray(g))] == [jdt] * 4
    tdt = getattr(torch, dtype)
    return [_t(v).to(tdt) for v in pyr], _t(coords), _t(g), want


def _close_per_level(got, want, dtype):
    """fp32: the same weights and sums, 1e-6; bf16: one rounding of fp32
    values that may differ in the last fp32 bit, so one bf16 step (2^-8)
    relative to the level's scale."""
    for d, w in zip(got, want):
        tol = 1e-6 if dtype == "float32" else 2**-8 * max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(d.float().numpy(), w, atol=tol, rtol=0)


def test_corr_lookup_bwd_plain_matches_pallas_vjp(k1_case):
    """``corr_lookup_bwd_plain`` vs ``jax.vjp`` of the Pallas lookup; each
    level comes back in the pyramid's dtype."""
    dtype, (pyr, coords, g, want) = k1_case
    got = corr_lookup_bwd_plain([(v.shape, v.dtype) for v in pyr], coords, g, 4)
    assert [d.dtype for d in got] == [pyr[0].dtype] * 4
    assert [tuple(d.shape) for d in got] == [tuple(v.shape) for v in pyr]
    _close_per_level(got, want, dtype)
    assert float(got[0][0, 0, 0].abs().max()) == 0.0  # coords -1e9: an all-zero row


def test_corr_lookup_autograd_function_matches_pallas_vjp(k1_case):
    """Autograd through ``CorrLookup`` on CPU tensors (its plain forward and
    backward) against the same VJP, with an NCHW-contiguous incoming
    gradient, strided in the (B, H, W, C) layout the kernel reads; the
    coordinates get no gradient."""
    dtype, (pyr, coords, g, want) = k1_case
    levels = [v.clone().requires_grad_(True) for v in pyr]
    coords = coords.clone().requires_grad_(True)
    out = CorrLookup.apply(coords, 4, torch.float32, *levels)
    assert out.dtype == torch.float32 and out.shape == (1, 36, 4, 16)
    strided = g.permute(0, 3, 1, 2).contiguous()
    assert not strided.permute(0, 2, 3, 1).is_contiguous()
    out.backward(strided)
    assert coords.grad is None
    assert [v.grad.dtype for v in levels] == [pyr[0].dtype] * 4
    _close_per_level([v.grad for v in levels], want, dtype)


def test_refuse_grad_guards_kernels_without_backward():
    """No kernel cuts the graph: every one now has a backward, so nothing
    refuses grad inputs. encoder_stage, the last to get one, records
    EncoderStage's backward under grad mode when an input requires grad
    (on CPU tensors through its plain forward and encoder_stage_bwd_plain,
    not PyTorch's autograd of the plain conv), and gradients reach every
    input; under no_grad it records nothing."""
    torch.manual_seed(0)
    u = torch.randn(1, 4, 6, 64, requires_grad=True)
    a, b = torch.ones(1, 64, requires_grad=True), torch.zeros(1, 64, requires_grad=True)
    w = (torch.randn(64, 64, 3, 3) * 0.05).requires_grad_(True)
    y, s, ss = encoder_stage(u, a, b, w)
    assert type(y.grad_fn)._forward_cls is EncoderStage
    (y.float().sum() + s.sum() + ss.sum()).backward()
    assert all(t.grad is not None and float(t.grad.abs().sum()) > 0 for t in (u, a, b, w))
    with torch.no_grad():
        assert encoder_stage(u, a, b, w)[0].grad_fn is None
    assert not hasattr(_build, "refuse_grad")


# --- the model in train mode and the DKT step ---------------------------------


def _jax_cfg(**kw):
    return JConfig.from_dict({**TRAIN, **FP32, "corr_implementation": "reg",
                              "remat_iters": False, **kw})


def _random_batch_stats(stats, rng):
    """Random BN running statistics, so that frozen BN is not the identity."""

    def draw(path, leaf):
        shape = np.shape(leaf)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, stats)


@pytest.fixture(scope="module")
def jax_setup():
    """Student variables, teacher variables (the student's parameters
    scaled by 1 + 0.02 N(0, 1), so that the teachers agree at some pixels
    and the pseudo-label loss is not empty), a batch, and the JAX
    train-mode forward's predictions and gradients of ``sequence_loss_raft``
    against the batch's GT."""
    rng = np.random.default_rng(0)
    model = JRAFTStereo(_jax_cfg(), iters=ITERS, test_mode=False)
    dummy = jnp.zeros((B, H, W, 3), jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), dummy, dummy))
    student = {"params": v["params"], "batch_stats": _random_batch_stats(v["batch_stats"], rng)}
    teacher = {"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32), v["params"]),
        "batch_stats": student["batch_stats"]}
    variables = [student, teacher]
    batch = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = (-rng.uniform(0, 20, (B, H, W))).astype(np.float32)
    batch["valid"] = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)

    def loss_fn(params):
        out = model.apply({"params": params, "batch_stats": variables[0]["batch_stats"]},
                          batch["img1"], batch["img2"])
        loss = jsequence_loss_raft(out["disp_preds"], batch["flow"], batch["valid"])[0]
        return loss, out["disp_preds"]

    (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables[0]["params"])
    grads = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    return variables, batch, float(loss), np.asarray(preds), grads


def _port_model(variables, **kw):
    model = RAFTStereo(RAFTStereoConfig.from_dict({**TRAIN, **FP32, **kw}), iters=ITERS,
                       test_mode=False)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.train()


@pytest.mark.parametrize("remat", [True, False])
def test_train_forward_matches_jax(jax_setup, remat):
    """``{"disp_preds": (iters, B, H, W)}`` of train.json's student (fp32,
    frozen batch norm with random statistics) with ``remat_iters`` on and
    off. Bound 2.5e-3 px, the test-mode bound of tests/test_torch_raft.py:
    fp32 sums in another order through 2 GRU iterations."""
    variables, batch, _, preds, _ = jax_setup
    model = _port_model(variables[0], remat_iters=remat)
    out = model(_t(batch["img1"]), _t(batch["img2"]))
    assert set(out) == {"disp_preds"} and out["disp_preds"].shape == (ITERS, B, H, W)
    assert float((out["disp_preds"].detach() - _t(preds)).abs().max()) <= 2.5e-3


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def test_student_gradients_match_jax(jax_setup):
    """Gradients of sequence_loss_raft through the train-mode student (remat
    on, K1's backward as its plain version) vs ``jax.grad``, tensor by
    tensor, the fnet's included: it is reached only through the pyramid
    lookup's backward. Bound per tensor: L2 error <= 5e-3 of the tensor's
    gradient norm (measured up to 3.3e-3: fp32 reordering through frozen
    BN, 2 GRU iterations and the L1 loss's sign at a few pixels) plus 1e-7
    of the global gradient norm, the rounding floor of the conv biases in
    front of instance norm, whose exact gradient is 0."""
    variables, batch, jloss, _, jgrads = jax_setup
    model = _port_model(variables[0], remat_iters=True)
    out = model(_t(batch["img1"]), _t(batch["img2"]))
    loss = sequence_loss_raft(out["disp_preds"], _t(batch["flow"]), _t(batch["valid"]))[0]
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    loss.backward()
    named = dict(model.named_parameters())
    assert set(named) <= set(jgrads) and len(named) > 100
    total = float(torch.stack([jgrads[k].norm() for k in named]).norm())
    for k, p in named.items():
        err = float((p.grad - jgrads[k]).norm())
        assert err <= 5e-3 * float(jgrads[k].norm()) + 1e-7 * total, (k, err)
    fnet = [k for k in named if k.startswith("fnet.") and k.endswith("weight")]
    assert len(fnet) > 10
    assert all(float(named[k].grad.norm()) > 1e-3 * total / len(named) for k in fnet)


def _jax_state_and_step(variables, hyper_kw, batch, key, jcfg=None, jstep=None, **model):
    """The JAX DKT state from ``variables`` (student, teacher) and one step
    of ``jstep`` (default: the RAFT step of ``jcfg``); ``model``:
    ``model_cls`` and ``loss_adapter`` for another model."""
    cfg = jcfg or _jax_cfg()
    jhyper = JHyper(**hyper_kw)
    shape = batch["flow"].shape
    state = jcreate_dkt_state(cfg, jhyper, None, shape, params=variables[0],
                              teacher_params=variables[1],
                              **{k: v for k, v in model.items() if k == "model_cls"})
    jstep = jstep or jmake_dkt_train_step(cfg, jhyper, **model)
    state1, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    metrics = {k: float(v) for k, v in metrics.items()}
    return state, jax.tree_util.tree_map(np.asarray, state1), metrics


def _draws(key, batch_size=B):
    k_fgt, k_egt, _, k_epl, _, _ = jax.random.split(key, 6)
    return {"filter_gt": _t(np.asarray(jax.random.uniform(k_fgt, (batch_size,)))),
            "ensemble_gt": _t(np.asarray(jax.random.uniform(k_egt, ()))),
            "ensemble_pl": _t(np.asarray(jax.random.uniform(k_epl, ())))}


def _port_state(jstate, hyper_kw, config=None):
    sds = dkt_state_from_flax(jax.tree_util.tree_map(np.asarray, jstate))
    hyper = DKTHyperParams(**hyper_kw)
    state = create_dkt_state(config or {**TRAIN, **FP32}, hyper, params=sds["student"],
                             teacher_params=sds["teacher"], device="cpu")
    return state, hyper


HYPER = dict(train_iters=ITERS, teacher_iters=ITERS, num_steps=100)


def _check_step_against_jax(variables, batch, hyper_kw, key, config=None, more_draws=dict,
                            share=0.999, **jax_side):
    """One port step (of ``config``, default RAFT's train.json in fp32) and
    one JAX step (``jax_side``: see :func:`_jax_state_and_step`) from the
    same weights, batch and F&E draws (and ``more_draws()``, read after the
    JAX step), held to the bounds :func:`test_dkt_step_matches_jax`
    states, with ``share`` of the updated elements within 1e-2*lr."""
    config = config or {**TRAIN, **FP32}
    jstate, jstate1, jmetrics = _jax_state_and_step(variables, hyper_kw, batch, key, **jax_side)
    state, hyper = _port_state(jstate, hyper_kw, config)
    bn_before = {name: {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
                 for name, m in (("student", state.student), ("teacher", state.teacher))}
    draws = {**_draws(key, batch["flow"].shape[0]), **more_draws()}
    state, metrics = make_dkt_train_step(config, hyper)(
        state, {k: _t(v) for k, v in batch.items()}, draws=draws)

    assert set(metrics) == set(jmetrics)
    assert metrics["ok"] == jmetrics["ok"] == 1.0 and state.step == 1 and state.applied_steps == 1
    assert metrics["loss_PL"] > 0 and metrics["loss_GT"] > 0
    for k, v in metrics.items():
        assert v == pytest.approx(jmetrics[k], rel=1e-4), k

    lr = jmetrics["learning_rate"]
    want = state_dict_from_flax(jstate1.params)
    close = count = 0
    for k, p in state.student.named_parameters():
        d = (p.detach() - want[k]).abs()
        scale = 1e-6 * want[k].abs()
        assert bool((d <= 2 * lr + scale).all()), (k, float(d.max()))
        close += int((d <= 1e-2 * lr + scale).sum())
        count += d.numel()
    assert close >= share * count, close / count
    for name, m in (("student", state.student), ("teacher", state.teacher)):
        for k, v in m.state_dict().items():
            if "running" in k:
                assert torch.equal(v, bn_before[name][k]), (name, k)
    ema_want = state_dict_from_flax(jstate1.ema_params)
    for k, v in state.ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ema_want[k].numpy(), rtol=1e-6, atol=1e-9)


def test_dkt_step_matches_jax(jax_setup):
    """One whole DKT step (train.json, fp32, context_norm batch with random
    running statistics; teacher weights near the student's) from the same
    weights, batch and F&E draws as the JAX step.

    Bounds: losses and metrics 1e-4 relative (measured <= 2.2e-6). Updated
    parameters: every element within 2*lr of the JAX step's plus 1e-6
    relative, since Adam's first step moves each weight by about +-lr and a
    gradient element near 0 whose sign differs may land 2*lr away; and
    99.9% of all elements within 1e-2*lr plus 1e-6 relative (measured
    99.97%). BN running statistics stay bit-identical in the student and
    the teacher, and the EMA matches JAX's lerp to 1e-6."""
    variables, batch, *_ = jax_setup
    _check_step_against_jax(variables, batch, HYPER, jax.random.PRNGKey(3))


def _snapshot(state):
    opt = {id(p): {k: v.clone() for k, v in st.items()} for p, st in state.optimizer.state.items()}
    return ({k: v.clone() for k, v in state.student.state_dict().items()}, opt,
            {k: v.clone() for k, v in state.ema.state_dict().items()})


def test_dkt_step_skips_update_when_not_ok(jax_setup):
    """A NaN in the augmented image makes the predictions non-finite: ok is
    0, the loss is zeroed, the student and the optimizer state stay as they
    were and the schedule does not advance, while the EMA update stands (as
    in the JAX step, train/dkt_step.py:240-244)."""
    variables, batch, *_ = jax_setup
    jstate = jcreate_dkt_state(_jax_cfg(), JHyper(**HYPER), None, (B, H, W),
                               params=variables[0], teacher_params=variables[1])
    state, hyper = _port_state(jstate, HYPER)
    step = make_dkt_train_step({**TRAIN, **FP32}, hyper)
    good = {k: _t(v) for k, v in batch.items()}
    state, m0 = step(state, good, draws=_draws(jax.random.PRNGKey(1)))
    assert m0["ok"] == 1.0
    params, opt, ema = _snapshot(state)
    bad = dict(good, img1=good["img1"].clone())
    bad["img1"][0, 3, 5, 1] = float("nan")
    state, m1 = step(state, bad, draws=_draws(jax.random.PRNGKey(2)))
    assert m1["ok"] == 0.0 and m1["loss"] == 0.0 and state.step == 2 and state.applied_steps == 1
    assert m1["learning_rate"] == onecycle_linear(hyper.lr, hyper.num_steps + 100)(1)
    assert all(torch.equal(v, params[k]) for k, v in state.student.state_dict().items())
    for p, st in state.optimizer.state.items():
        assert all(torch.equal(v, opt[id(p)][k]) for k, v in st.items())
    assert any(not torch.equal(v, ema[k]) for k, v in state.ema.state_dict().items()
               if v.is_floating_point())
    state, m2 = step(state, good, draws=_draws(jax.random.PRNGKey(1)))
    assert m2["ok"] == 1.0 and state.applied_steps == 2 and m2["learning_rate"] == m1["learning_rate"]


def test_dkt_step_cascade_train(jax_setup):
    """``cascade_train``: a half-resolution pass whose last prediction
    (spatial ::2, values /2) starts the full-resolution pass and whose
    x2-upsampled predictions add 0.5-weighted losses, gated by their own
    ok flags. One step against the JAX step with ``cascade_train=True``,
    from the same weights, batch and draws, under the bounds of
    :func:`test_dkt_step_matches_jax`, with the same key. The share of
    elements within 1e-2*lr depends on the draws, because Adam's sign-like
    first step turns every gradient element whose sign fp32 rounding flips
    into a 2*lr difference: 99.965% with this key, 99.90% with
    PRNGKey(4). A departure from the JAX cascade (the init's scaling, the
    x2 upsample, the 0.5 weight) moves the losses far past 1e-4."""
    variables, batch, *_ = jax_setup
    _check_step_against_jax(variables, batch, dict(HYPER, cascade_train=True),
                            jax.random.PRNGKey(3))


def test_loss_adapter_and_unported_training_options():
    """The registry's loss adapters for RAFT and (by name) IGEV's, GWCNet's
    and the NS loss; ``batched_teachers`` builds a step (its runs:
    tests/test_torch_batched_teachers.py), and the hyperparameters keep the
    JAX package's fields and defaults."""
    loss_fn = make_loss_adapter("RAFTStereo", None)
    preds = torch.zeros(1, 1, 4, 4)
    loss, metrics, mask, ok = loss_fn({"disp_preds": preds}, -torch.ones(1, 4, 4), torch.ones(1, 4, 4))
    assert float(loss) == pytest.approx(1.0) and bool(ok) and bool(mask.all())
    assert make_loss_adapter("RAFTStereo", None, "sequence_loss_raft") is not None
    # sequence_loss_igev by name, max_disp from the config: |gt| 3 is masked
    # out at max_disp 2; with the default 192 the init term adds 2.5
    igev = {"disp_preds": preds, "init_disp": torch.zeros(1, 4, 4)}
    for cfg, want in (({"max_disp": 2}, 0.0), (None, 3.0 + 2.5)):
        loss, metrics, _, ok = make_loss_adapter("RAFTStereo", cfg, "sequence_loss_igev")(
            igev, -3 * torch.ones(1, 4, 4), torch.ones(1, 4, 4))
        assert float(loss) == pytest.approx(want) and bool(ok) and "init_epe" in metrics
    # loss_gwcnet by name serves the port's loss; ns_loss raises the JAX
    # registry's ValueError, which points at the NS route
    gwc = {"disp_preds": preds[-1:].expand(4, -1, -1, -1)}
    loss, _, _, ok = make_loss_adapter("RAFTStereo", None, "loss_gwcnet")(
        gwc, -3 * torch.ones(1, 4, 4), torch.ones(1, 4, 4))
    assert bool(ok) and float(loss) == pytest.approx((0.5 + 0.5 + 0.7 + 1.0) * 2.5)
    with pytest.raises(ValueError, match="trinocular batch contract"):
        make_loss_adapter("RAFTStereo", None, "ns_loss")
    with pytest.raises(KeyError, match="unknown loss_func"):
        make_loss_adapter("RAFTStereo", None, "no_such_loss")
    hyper = DKTHyperParams(batched_teachers=True)
    assert hyper.batched_teachers and callable(make_dkt_train_step({**TRAIN, **FP32}, hyper))
    assert dataclasses.asdict(DKTHyperParams()) == dataclasses.asdict(JHyper())
