"""The fused full-resolution encoder in training, port vs the JAX package,
on the CPU: K2's VJP (``ops/cuda/encoder_conv.py::EncoderStage`` through
``encoder_stage_bwd_plain``) against ``jax.vjp`` of
``encoder_stage_ad`` (Pallas interpret mode, as tests/test_pallas_encoder.py
runs it), the fused encoders' gradients, RAFT's train-mode gradients with
``pallas_encoder`` and one whole DKT step of train.json with
``pallas_encoder`` merged in.

The JAX stage works in its w2d frame; the comparison differentiates it
through ``w2d_pack``/``w2d_pad``/``w2d_conv3x3_weights`` and the output
slices, so that its cotangents come out on the same logical tensors as
the port's.
"""

import dataclasses
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
from dkt_stereo_tpu.nn.blocks import BasicEncoder as JBasicEncoder
from dkt_stereo_tpu.nn.blocks import MultiBasicEncoder as JMultiBasicEncoder
from dkt_stereo_tpu.nn.blocks import fused_fullres_layer1 as jfused
from dkt_stereo_tpu.ops.pallas import encoder_conv as jenc
from dkt_stereo_tpu_torch.losses.sequence import sequence_loss_raft
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.nn.blocks import BasicEncoder, MultiBasicEncoder, _res_pair
from dkt_stereo_tpu_torch.nn.blocks import fused_fullres_layer1
from dkt_stereo_tpu_torch.nn.norms import Norm
from dkt_stereo_tpu_torch.ops.cuda import encoder_conv
from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import EncoderStage, encoder_stage
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_train import HYPER, _check_step_against_jax, _random_batch_stats

ROOT = Path(__file__).resolve().parents[1]
TRAIN = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
FP32 = {"mixed_precision": False, "corr_dtype": "float32"}
C = 64
NAMES = ("u", "a1", "b1", "w", "v", "a2", "b2")


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _numpy_tree(v):
    return jax.tree_util.tree_map(np.asarray, {k: dict(x) for k, x in v.items()})


# --- one stage ----------------------------------------------------------------


def _jax_stage_fn(H, residual, dtype, rb=4):
    """The JAX stage (``encoder_stage_ad``) as a function of logical
    (u, a1, b1, w_hwio[, v, a2, b2]) in fp32, returning logical
    (y, sum, sumsq[, h]) in fp32: the w2d frame, the dense taps and the
    casts to ``dtype`` sit inside, so jax.vjp sees through them."""

    def frame(t):
        return jenc.w2d_pad(jenc.w2d_pack(t.astype(dtype)), rb)

    def dup(t):
        return jnp.concatenate([t, t], -1)

    def logical(t, shift):
        return jenc.w2d_unpack(jenc.w2d_slice(t, shift, H)).astype(jnp.float32)

    def fn(u, a1, b1, w, *res):
        kw = {}
        if residual:
            v, a2, b2 = res
            kw = dict(v=frame(v), a2=dup(a2), b2=dup(b2), emit_h=True)
        outs = jenc.encoder_stage_ad(frame(u), dup(a1), dup(b1),
                                     jenc.w2d_conv3x3_weights(w.astype(dtype)), H=H,
                                     shift_in=0, interpret=True, rb=rb, **kw)
        y = logical(outs[0], 1)
        s = outs[1][:, :C] + outs[1][:, C:]
        ss = outs[2][:, :C] + outs[2][:, C:]
        return (y, s, ss, logical(outs[3], 0)) if residual else (y, s, ss)

    return fn


def _stage_inputs(rng, B, H, W, residual):
    act = [rng.standard_normal((B, H, W, C)).astype(np.float32)]
    aff = [(0.5 + rng.uniform(0, 1, (B, C))).astype(np.float32),
           (0.3 * rng.standard_normal((B, C))).astype(np.float32)]
    w = (rng.standard_normal((3, 3, C, C)) * (2.0 / (9 * C)) ** 0.5).astype(np.float32)
    args = [act[0], *aff, w]
    if residual:
        args += [rng.standard_normal((B, H, W, C)).astype(np.float32),
                 (0.5 + rng.uniform(0, 1, (B, C))).astype(np.float32),
                 (0.3 * rng.standard_normal((B, C))).astype(np.float32)]
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_encoder_stage_vjp_matches_jax(rng, dtype, residual):
    """All seven cotangents of one stage (plain, and residual with v and
    emit_h) through ``EncoderStage`` on the CPU vs ``jax.vjp`` of
    ``encoder_stage_ad``, from the same inputs and output cotangents
    (gy, gs, gss[, gh]). fp32: max-abs <= 1e-5 x max(|g|, 1), the bound of
    JAX's own VJP against autodiff (tests/test_pallas_encoder.py:154-217).
    bf16: <= 2^-7 x max|g|: both round g_y, g_h and the weight gradient to
    bf16 once, from fp32 sums taken in another order (JAX's dense w2d taps
    also add two bf16 roundings per logical tap), so one bf16 step (2^-8)
    can flip."""
    B, H, W = 2, 8, 16
    args = _stage_inputs(rng, B, H, W, residual)
    jdt = jnp.dtype(dtype)
    fn = _jax_stage_fn(H, residual, jdt)
    outs, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(a) for a in args))
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs]
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]

    tdt = getattr(torch, dtype)
    tin = [_t(a) for a in args]
    tin[0] = tin[0].to(tdt)
    tin[3] = tin[3].permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
    if residual:
        tin[4] = tin[4].to(tdt)
    for t in tin:
        t.requires_grad_(True)
    kw = dict(zip(("v", "a2", "b2"), tin[4:]), emit_h=True) if residual else {}
    got = encoder_stage(*tin[:4], **kw)
    assert len(got) == len(outs) and got[0].grad_fn is not None
    torch.autograd.backward([o.float() for o in got], [_t(c) for c in cts])
    for name, t, w in zip(NAMES, tin, want):
        g = t.grad
        assert g.dtype == t.dtype and g.shape == t.shape, name
        g = g.float()
        if name == "w":
            g = g.permute(2, 3, 1, 0)
        scale = float(np.abs(w).max())
        tol = 1e-5 * max(scale, 1.0) if dtype == "float32" else 2**-7 * scale
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, (name, err, tol)


def test_encoder_stage_vjp_rounding_points_match_jax():
    """bf16 inputs chosen so that each of the JAX VJP's rounding points
    shows in the result, against ``jax.vjp`` of ``encoder_stage_ad``:
    u = v = 1 with identity affines, so h = 2 and y = 2 at every pixel, and
    the centre-tap identity weight, whose adjoint gives g_h = g_y rounded.
    The only cotangents are gs = c = 1 + 2^-8 - 2^-16, just below a bf16
    rounding midpoint, and gh = 2^-9: g_y = c in fp32, rounded to 1 before
    the adjoint conv, and gh is added in fp32 after g_h is rounded, so
    every affine sum is 24 * (1 + 2^-9); rounding g_h after the add would
    give 24 * (1 + 2^-7). The weight's centre taps sum the unrounded g_y,
    2 * 24 * c = 48.19, which rounds to 48.25 in bf16; from the rounded g_y
    they would be 48. Every cotangent but the weight's equals JAX's; JAX
    rounds each of the weight's dense w2d taps before it adds them, so only
    the centre taps (one product a tap in each of its two halves) match it
    bit for bit."""
    B, H, W = 1, 4, 6
    c = np.float32(1 + 2**-8 - 2**-16)
    ones = np.ones((B, H, W, C), np.float32)
    a, b = np.ones((B, C), np.float32), np.zeros((B, C), np.float32)
    w = np.zeros((3, 3, C, C), np.float32)
    w[1, 1] = np.eye(C)
    args = [ones, a, b, w, ones, a, b]
    outs, vjp = jax.vjp(jax.jit(_jax_stage_fn(H, True, jnp.bfloat16)),
                        *(jnp.asarray(x) for x in args))
    cts = [np.zeros((B, H, W, C), np.float32), np.full((B, C), c, np.float32),
           np.zeros((B, C), np.float32), np.full((B, H, W, C), 2**-9, np.float32)]
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(x) for x in cts))]

    tin = [_t(x) for x in args]
    tin[0], tin[4] = tin[0].to(torch.bfloat16), tin[4].to(torch.bfloat16)
    tin[3] = tin[3].permute(3, 2, 0, 1).contiguous()
    for t in tin:
        t.requires_grad_(True)
    got = encoder_stage(*tin[:4], v=tin[4], a2=tin[5], b2=tin[6], emit_h=True)
    assert bool((got[0].detach() == 2).all())
    torch.autograd.backward([o.float() for o in got], [_t(x) for x in cts])
    for name, t, x in zip(NAMES, tin, want):
        g = t.grad.float()
        if name == "w":
            centre = g[:, :, 1, 1].numpy()
            assert (centre == 48.25).all() and (x[1, 1] == 48.25).all()
            continue
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    for g in (tin[1].grad, tin[2].grad, tin[5].grad, tin[6].grad):
        assert (g == 24 * (1 + 2**-9)).all()


def test_encoder_stage_function_honours_needs_input_grad(rng, monkeypatch):
    """The backward computes only what autograd asks for: with only u
    requiring grad the plain backward is told so, no other tensor gets a
    gradient, and u's equals the one computed with everything asked."""
    args = _stage_inputs(rng, 1, 4, 6, residual=True)
    tin = [_t(a) for a in args]
    tin[3] = tin[3].permute(3, 2, 0, 1).contiguous()
    seen = []
    plain = encoder_conv.encoder_stage_bwd_plain

    def spy(*a):
        seen.append(tuple(a[-1]))
        return plain(*a)

    monkeypatch.setattr(encoder_conv, "encoder_stage_bwd_plain", spy)
    grads = []
    for ask in ((0,), range(7)):
        ins = [t.detach().clone().requires_grad_(i in ask) for i, t in enumerate(tin)]
        y, s, ss, h = encoder_stage(*ins[:4], v=ins[4], a2=ins[5], b2=ins[6], emit_h=True)
        (y.sum() + s.sum() + 1e-3 * ss.sum() + h.sum()).backward()
        grads.append(ins[0].grad)
        if ask == (0,):
            assert all(t.grad is None for t in ins[1:])
    assert seen == [(True,) + (False,) * 6, (True,) * 7]
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_encoder_stage_without_grad_emits_no_h(rng):
    """Under no_grad, or with no input that requires grad, encoder_stage
    bypasses EncoderStage (whose forward always makes h) and returns only
    what was asked for; with an input that requires grad it records
    EncoderStage's backward."""
    args = _stage_inputs(rng, 1, 4, 6, residual=False)
    u, a1, b1 = (_t(a) for a in args[:3])
    w = _t(args[3]).permute(3, 2, 0, 1).contiguous()
    out = encoder_stage(u, a1, b1, w)
    assert len(out) == 3 and out[0].grad_fn is None
    w.requires_grad_(True)
    with torch.no_grad():
        out = encoder_stage(u, a1, b1, w)
    assert len(out) == 3 and out[0].grad_fn is None
    out = encoder_stage(u, a1, b1, w)
    assert len(out) == 3 and type(out[0].grad_fn).__name__ == "EncoderStageBackward"
    assert type(out[0].grad_fn)._forward_cls is EncoderStage


# --- the fused encoders -----------------------------------------------------


def _sum_sq(out):
    """BasicEncoder's tensor or MultiBasicEncoder's scales of heads."""
    leaves = [out] if isinstance(out, torch.Tensor) else [t for scale in out for t in scale]
    return sum(t.float().square().sum() for t in leaves)


def _encoder_grads_close(jmodel, port, x, tol):
    """Parameter and input gradients of the sum of squared outputs, fused
    port vs fused JAX, from one JAX init (jitted: traced once, not run op
    by op through the Pallas stage in interpret mode): max-abs over
    max(|g|, 1) per leaf (tests/test_pallas_encoder.py::_grad_compare's
    measure)."""
    xj = jnp.asarray(x)
    variables = _numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), xj))

    def loss(params, xx):
        leaves = jax.tree_util.tree_leaves(jmodel.apply({**variables, "params": params}, xx))
        return sum(jnp.sum(leaf.astype(jnp.float32) ** 2) for leaf in leaves)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], xj)
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, gp)})
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    _sum_sq(port(xt)).backward()
    worst = {}
    for k, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(want[k].abs().max()), 1.0)
        worst[k] = float((g - want[k]).abs().max()) / scale
    gx = np.asarray(gx)
    worst["x"] = float(np.abs(xt.grad.permute(0, 2, 3, 1).numpy() - gx).max()) / max(
        float(np.abs(gx).max()), 1.0)
    assert max(worst.values()) <= tol, max(worst.items(), key=lambda kv: kv[1])
    return port


def test_basic_encoder_fused_grads_match_jax(rng):
    """BasicEncoder(instance, downsample 2) with the fused path, as the
    fnet: <= 4e-3 per leaf, JAX's own bound between its fused and unfused
    gradients (tests/test_pallas_encoder.py:220-233). The stem bias and the
    layer1 conv biases never enter the instance arm: no gradient reaches
    them, JAX's exact zero."""
    x = rng.standard_normal((2, 24, 32, 3)).astype(np.float32)
    port = _encoder_grads_close(JBasicEncoder(256, "instance", 2, dtype=jnp.float32,
                                              fused_fullres=True),
                                BasicEncoder(256, "instance", 2, fused_fullres=True), x, 4e-3)
    unused = ["conv1.bias"] + [f"layer1.{i}.conv{j}.bias" for i in (0, 1) for j in (1, 2)]
    named = dict(port.named_parameters())
    assert all(named[k].grad is None for k in unused)
    assert all(float(named[f"layer1.{i}.conv{j}.weight"].grad.abs().max()) > 0
               for i in (0, 1) for j in (1, 2))


def test_multi_encoder_fused_grads_match_jax(rng):
    """MultiBasicEncoder with an instance-norm context (the cnet's fused
    path) at 1x32x48 (JAX's own geometry: fewer pixels make the IN
    statistics ill-conditioned): <= 4e-3 per leaf, as above."""
    x = rng.standard_normal((1, 32, 48, 3)).astype(np.float32)
    dims = ((128, 128, 128),)
    _encoder_grads_close(JMultiBasicEncoder(dims, "instance", 2, 3, dtype=jnp.float32,
                                            fused_fullres=True),
                         MultiBasicEncoder(dims, "instance", 2, 3, fused_fullres=True), x, 4e-3)


def test_fused_layer1_batch_arm_grads_match_jax(rng):
    """The batch arm (eval-mode BN folded into static affines,
    ``bn_eval_affine``): gradients into the stem weight and bias, the layer1
    conv weights and biases and every BN weight and bias, against
    ``jax.grad`` of the JAX fused chain (``_bn_fold``), random running
    statistics and biases, 2x12x20, fp32: max-abs <= 1e-4 x max(|g|, 1)."""
    B, H, W = 2, 12, 20
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    stem = (rng.standard_normal((7, 7, 3, C)) * 0.1).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, C, C)) * 0.06).astype(np.float32) for _ in range(4)]

    def bn():
        return [rng.uniform(0.5, 1.5, C).astype(np.float32),
                rng.standard_normal(C).astype(np.float32),
                (0.3 * rng.standard_normal(C)).astype(np.float32),
                rng.uniform(0.5, 2.0, C).astype(np.float32)]

    bns = [bn() for _ in range(5)]  # the stem's norm1, then layer1's four
    biases = [(0.1 * rng.standard_normal(C)).astype(np.float32) for _ in range(5)]

    def jloss(stem_k, stem_b, stem_bn, ks_, cbs, bns_):
        triples = [(k, cb, tuple(n)) for k, cb, n in zip(ks_, cbs, bns_)]
        out = jfused(jnp.asarray(x), stem_k, triples, "batch", jnp.float32,
                     stem_bn=tuple(stem_bn), stem_bias=stem_b)
        return jnp.sum(out**2)

    # gradients of the weights, biases and BN scale/bias; the running
    # statistics are buffers in the port
    jargs = (stem, biases[0], bns[0], ks, biases[1:], bns[1:])
    g = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4, 5)))(
        *jax.tree_util.tree_map(jnp.asarray, jargs))
    g = jax.tree_util.tree_map(np.asarray, g)

    conv = torch.nn.Conv2d(3, C, 7, padding=3)
    norm1 = Norm("batch", C)
    layer1 = _res_pair(C, C, "batch", 1)
    convs = [c for blk in layer1 for c in (blk.conv1, blk.conv2)]
    norms = [norm1] + [n for blk in layer1 for n in (blk.norm1, blk.norm2)]
    with torch.no_grad():
        conv.weight.copy_(_t(stem.transpose(3, 2, 0, 1)))
        conv.bias.copy_(_t(biases[0]))
        for c, k, b in zip(convs, ks, biases[1:]):
            c.weight.copy_(_t(k.transpose(3, 2, 0, 1)))
            c.bias.copy_(_t(b))
        for n, (scale, bias, mean, var) in zip(norms, bns):
            n.weight.copy_(_t(scale))
            n.bias.copy_(_t(bias))
            n.running_mean.copy_(_t(mean))
            n.running_var.copy_(_t(var))
    out = fused_fullres_layer1(_t(x).permute(0, 3, 1, 2), conv.weight, layer1, "batch",
                               stem_bn=norm1, stem_bias=conv.bias)
    out.square().sum().backward()

    pairs = [(conv.weight.grad, g[0].transpose(3, 2, 0, 1)), (conv.bias.grad, g[1]),
             (norm1.weight.grad, g[2][0]), (norm1.bias.grad, g[2][1])]
    for i, (c, n) in enumerate(zip(convs, norms[1:])):
        pairs += [(c.weight.grad, g[3][i].transpose(3, 2, 0, 1)), (c.bias.grad, g[4][i]),
                  (n.weight.grad, g[5][i][0]), (n.bias.grad, g[5][i][1])]
    assert len(pairs) == 20
    for got, want in pairs:
        scale = max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale
        assert float(np.abs(want).max()) > 0


# --- RAFT in train mode and the DKT step ------------------------------------

B, H, W, ITERS = 2, 32, 64, 2
FUSED = {**TRAIN, **FP32, "pallas_encoder": True}
# parameters that the fused fnet never reads: instance norm cancels them
UNUSED = ["fnet.conv1.bias"] + [f"fnet.layer1.{i}.conv{j}.bias" for i in (0, 1) for j in (1, 2)]


@pytest.fixture(scope="module")
def jax_fused_setup():
    """The JAX config of train.json's model (fp32, ``reg``) with
    ``pallas_encoder``, one JAX init of it with student and teacher
    variables as tests/test_torch_train.py::jax_setup makes them, except
    that the fnet's stem and layer1 conv biases are nonzero, so that the
    step's weight decay moves the parameters the fused fnet never reads,
    and a batch."""
    rng = np.random.default_rng(0)
    jcfg = JConfig.from_dict({**FUSED, "corr_implementation": "reg", "remat_iters": False})
    model = JRAFTStereo(jcfg, iters=ITERS, test_mode=False)
    dummy = jnp.zeros((B, H, W, 3), jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), dummy, dummy))
    params = jax.tree_util.tree_map(lambda a: a.copy(), v["params"])
    fnet = params["fnet"]
    for conv in [fnet["conv1"]] + [fnet["layer1"][i][c] for i in ("0", "1")
                                   for c in ("conv1", "conv2")]:
        conv["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    stats = _random_batch_stats(v["batch_stats"], rng)
    student = {"params": params, "batch_stats": stats}
    teacher = {"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32), params),
        "batch_stats": stats}
    batch = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = (-rng.uniform(0, 20, (B, H, W))).astype(np.float32)
    batch["valid"] = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    return jcfg, [student, teacher], batch


def test_raft_fused_encoder_train_gradients_match_jax(jax_fused_setup):
    """train.json with ``pallas_encoder`` (remat on), 2 iterations, fp32:
    the loss <= 1e-4 relative, and the gradients of sequence_loss_raft vs
    ``jax.grad`` of the JAX model with its fused encoder (Pallas interpret
    mode), tensor by tensor, with test_torch_alt.py's train-mode bound: L2
    error <= 5e-3 of the tensor's gradient norm plus 1e-7 of the global
    norm, or twice the floor where that is larger. The floor is the same
    comparison with the unfused encoder on both sides: fp32 reordering
    through random frozen BN, 2 GRU iterations and the L1 loss's sign at a
    few pixels, which this batch takes to 5.2e-3 on
    fnet.layer3.0.conv2.weight with either encoder. The fnet's layer1 gets a
    nonzero gradient (through the stage VJPs and the in-kernel statistics);
    its conv biases and the stem's get none, as JAX's zero."""
    jcfg, variables, batch = jax_fused_setup
    x1, x2, flow, valid = (_t(batch[k]) for k in ("img1", "img2", "flow", "valid"))
    jgrads, grads, losses = {}, {}, {}
    for fused in (True, False):
        jmodel = JRAFTStereo(dataclasses.replace(jcfg, pallas_encoder=fused), iters=ITERS,
                             test_mode=False)

        def loss_fn(p, jmodel=jmodel):
            out = jmodel.apply({"params": p, "batch_stats": variables[0]["batch_stats"]},
                               batch["img1"], batch["img2"])
            return jsequence_loss_raft(out["disp_preds"], batch["flow"], batch["valid"])[0]

        jloss, g = jax.jit(jax.value_and_grad(loss_fn))(variables[0]["params"])
        jgrads[fused] = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, g)})
        model = RAFTStereo(RAFTStereoConfig.from_dict({**FUSED, "pallas_encoder": fused}),
                           iters=ITERS, test_mode=False)
        model.load_state_dict(state_dict_from_flax(variables[0]), strict=True)
        loss = sequence_loss_raft(model.train()(x1, x2)["disp_preds"], flow, valid)[0]
        loss.backward()
        losses[fused] = (float(loss.detach()), float(jloss))
        grads[fused] = dict(model.named_parameters())
    assert losses[True][0] == pytest.approx(losses[True][1], rel=1e-4)
    named, want = grads[True], jgrads[True]
    total = float(torch.stack([want[k].norm() for k in named]).norm())
    for k, p in named.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - want[k]).norm())
        floor = float((grads[False][k].grad - jgrads[False][k]).norm())
        assert err <= max(5e-3 * float(want[k].norm()) + 1e-7 * total, 2 * floor), (k, err, floor)
    assert [k for k, p in named.items() if p.grad is None] == UNUSED
    assert all(float(want[k].abs().max()) == 0.0 for k in UNUSED)
    layer1 = [k for k in named if k.startswith("fnet.layer1.") and k.endswith("weight")]
    assert len(layer1) == 4 and all(float(named[k].grad.norm()) > 0 for k in layer1)


def test_dkt_step_fused_encoder_matches_jax(jax_fused_setup):
    """One whole DKT step of train.json with ``pallas_encoder`` against the
    JAX step with its fused encoder, from the same weights, batch and
    draws, under tests/test_torch_train.py's step bounds. The parameters
    the fused fnet never reads are nonzero here and get no gradient: the
    step fills in JAX's zero for None, so AdamW's weight decay moves them as
    optax's does, and the comparison of the updated parameters holds them
    too."""
    jcfg, variables, batch = jax_fused_setup
    _check_step_against_jax(variables, batch, HYPER, jax.random.PRNGKey(3),
                            config=FUSED, jcfg=jcfg)
