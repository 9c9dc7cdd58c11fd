"""The port's GWCNet slice against the JAX package: the concat volume, the
half-pixel resizes, the PSM trunk, the 3-D hourglass, the whole model of
configs/gwcnet/base_g.json and base_gc.json in test mode (fp32 and bf16),
the ``train_bn`` forward and its running statistics, ``loss_gwcnet``, the
train-mode gradients, one DKT step, the weight bridge and the registry.

Weights are seeded numpy draws in the shapes of the JAX tree
(``jax.eval_shape`` of its init, which costs no compile), carried to the
port by ``weights.state_dict_from_flax``. With unit running statistics
the 22 residual blocks of the trunk grow the features until the softmax
over disparity is one-hot everywhere; the model-level tests therefore
first calibrate the running statistics to the batch's own, running the
JAX model with ``train_bn`` until they settle (:func:`calibrated`). Their
batch-norm shifts are 1, so that most ReLUs are on: with shifts near 0
the JAX model's own gradient moves by 1-4 % under a 1e-6 relative weight
nudge (ReLU kinks amplified by the calibrated gains), far above any
bound a comparison could hold; with shifts of 1 that floor is ~1e-5.

fp32 unless stated; maxdisp 32 at 1x32x64, so the 1/4 volume is 8x8x16.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.losses.gwc import loss_gwcnet as jloss_gwcnet
from dkt_stereo_tpu.models import GWCNet as JGWCNet
from dkt_stereo_tpu.models import GWCNetConfig as JConfig
from dkt_stereo_tpu.nn.conv3d import Hourglass3D as JHourglass3D
from dkt_stereo_tpu.nn.psm import FeatureExtractionPSM as JFeature
from dkt_stereo_tpu.ops.resize import interp_bilinear_halfpix as jbilinear
from dkt_stereo_tpu.ops.resize import interp_trilinear_halfpix as jtrilinear
from dkt_stereo_tpu.ops.volumes import build_concat_volume as jconcat_volume
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.losses.gwc import loss_gwcnet
from dkt_stereo_tpu_torch.models.gwcnet import GWCNet, GWCNetConfig
from dkt_stereo_tpu_torch.models.registry import create_model, get_model, make_loss_adapter
from dkt_stereo_tpu_torch.nn.conv3d import Hourglass3D
from dkt_stereo_tpu_torch.nn.psm import FeatureExtractionPSM
from dkt_stereo_tpu_torch.ops.resize import interp_bilinear_halfpix, interp_trilinear_halfpix
from dkt_stereo_tpu_torch.ops.volumes import build_concat_volume
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from dkt_stereo_tpu_torch.weights import state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
BASE_G = load_model_config(str(ROOT / "configs/gwcnet/base_g.json"))
BASE_GC = load_model_config(str(ROOT / "configs/gwcnet/base_gc.json"))
SMALL = {"maxdisp": 32, "mixed_precision": False}
B, H, W = 1, 32, 64


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def draw_variables(module, rng, *inputs):
    """Seeded variables in the shapes of ``module.init(key, *inputs)``:
    kernels He-normal over their fan-out, biases N(0, 0.05), norm scales
    U(0.8, 1.2), running means N(0, 0.1) and variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_out = int(np.prod(shape[:-2])) * shape[-1] if len(shape) > 2 else shape[-1]
            return (np.sqrt(2.0 / fan_out) * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8 if name == "scale" else 0.5, 1.2 if name == "scale" else 1.5,
                               shape).astype(np.float32)
        scale = 0.1 if name == "mean" else 0.05
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return {k: dict(v) for k, v in tree.items()}


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)
    return err


def _jcfg(config, **kw):
    return JConfig.from_dict({**config, **SMALL, **kw})


def _port_cfg(config, **kw):
    return {**config, **SMALL, **kw}


def calibrated(jcfg, variables, img1, img2, rounds=40):
    """``variables`` with running statistics near the batch's own: the JAX
    model in train mode with ``train_bn``, ``rounds`` times, each update
    moving them 10 % of the way (flax's momentum 0.9)."""
    model = JGWCNet(dataclasses.replace(jcfg, train_bn=True), test_mode=False)
    apply = jax.jit(lambda v: model.apply(v, img1, img2, mutable=["batch_stats"]))
    v = dict(variables)
    for _ in range(rounds):
        v["batch_stats"] = jax.tree_util.tree_map(np.asarray, apply(v)[1]["batch_stats"])
    return v, apply


def _jax_disp(config, v, img1, img2, **kw):
    model = JGWCNet(_jcfg(config, **kw), test_mode=True)
    return np.asarray(jax.jit(model.apply)(v, jnp.asarray(img1), jnp.asarray(img2))[1])


@pytest.fixture(scope="module")
def gwc():
    """base_gc's train-mode tree (all four classifiers) with calibrated
    statistics, the images, the JAX model's fp32 test-mode disparity and
    its jitted train-mode forward with ``train_bn``."""
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    jcfg = _jcfg(BASE_GC)
    v = draw_variables(JGWCNet(jcfg, test_mode=False), rng, jnp.asarray(img1), jnp.asarray(img2))
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if "BatchNorm_0" in jax.tree_util.keystr(path)
        and path[-1].key == "bias" else a, v["params"])
    v, train_bn = calibrated(jcfg, v, jnp.asarray(img1), jnp.asarray(img2))
    return v, (img1, img2), _jax_disp(BASE_GC, v, img1, img2), train_bn


def _base_g_variables(v):
    """base_g's tree from base_gc's: no ``lastconv`` and a 40-channel
    ``dres0_0`` (the GWC volume's groups only)."""
    params = {k: x for k, x in v["params"].items()}
    stats = {k: x for k, x in v["batch_stats"].items()}
    params["feature_extraction"] = {k: x for k, x in params["feature_extraction"].items()
                                    if not k.startswith("lastconv")}
    stats["feature_extraction"] = {k: x for k, x in stats["feature_extraction"].items()
                                   if not k.startswith("lastconv")}
    d0 = dict(params["dres0_0"])
    d0["conv"] = {"kernel": d0["conv"]["kernel"][..., :40, :]}
    params["dres0_0"] = d0
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("mask_ref", [True, False])
def test_concat_volume_matches_jax(mask_ref):
    """Both reference-feature rules, with more disparities than columns at
    the right: 1e-5 absolute."""
    rng = np.random.default_rng(1)
    f1, f2 = (rng.standard_normal((2, 5, 7, 6)).astype(np.float32) for _ in range(2))
    want = jconcat_volume(jnp.asarray(f1), jnp.asarray(f2), 9, mask_ref)
    got = build_concat_volume(_nchw(f1), _nchw(f2), 9, mask_ref)
    assert got.shape == (2, 12, 9, 5, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", ["trilinear", "bilinear"])
def test_halfpix_resizes_match_jax(mode):
    """torch's align_corners=False resizes against the JAX matmul forms, up
    (GWCNet's x4) and down: 1e-5 absolute."""
    rng = np.random.default_rng(2)
    if mode == "trilinear":
        x = rng.standard_normal((2, 3, 4, 5, 2)).astype(np.float32)
        for size in ((12, 16, 20), (2, 3, 4)):
            want = jtrilinear(jnp.asarray(x), size)
            got = interp_trilinear_halfpix(_t(x).permute(0, 4, 1, 2, 3), size)
            np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                                       atol=1e-5)
    else:
        x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
        for size in ((24, 20), (3, 4)):
            want = jbilinear(jnp.asarray(x), size)
            got = interp_bilinear_halfpix(_nchw(x), size)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                       atol=1e-5)


def _load_nested(module, variables, prefix):
    nested = {coll: {prefix: tree} for coll, tree in variables.items()}
    sd = state_dict_from_flax(nested)
    module.load_state_dict({k.removeprefix(prefix + "."): v for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("concat", [False, True])
def test_feature_extraction_psm_matches_jax(concat):
    """The PSM trunk (dilated layer4, l2 | l3 | l4, ``lastconv`` with the
    concat feature): 1e-4 relative to each output's scale."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    jm = JFeature(concat, 12, True, jnp.float32)
    v = draw_variables(jm, rng, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load_nested(FeatureExtractionPSM(concat, 12), v, "feature_extraction")
    with torch.no_grad():
        got = port(_nchw(x))
    assert set(got) == set(want) == ({"gwc_feature", "concat_feature"} if concat
                                     else {"gwc_feature"})
    assert got["gwc_feature"].shape == (2, 320, 8, 12)
    for k in want:
        _close(got[k].permute(0, 2, 3, 1).numpy(), want[k], 1e-4)


def test_hourglass3d_matches_jax():
    """Two stride-2 encoders, the transposed-conv decoders and the redir
    skips over a (1, 32, 8, 8, 12) volume: 1e-4 relative."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 12, 32)).astype(np.float32)
    jm = JHourglass3D(32, True, jnp.float32)
    v = draw_variables(jm, rng, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = _load_nested(Hourglass3D(32), v, "dres2")
    with torch.no_grad():
        got = port(_t(x).permute(0, 4, 1, 2, 3))
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want, 1e-4)


@pytest.mark.parametrize("name", ["base_g", "base_gc"])
def test_test_mode_matches_jax(gwc, name):
    """The whole model in test mode (fp32): 1e-3 px. The softmax is soft
    (the disparity is no bin's index), so the regression is compared, not
    only its argmax."""
    v, (img1, img2), want, _ = gwc
    config = BASE_G if name == "base_g" else BASE_GC
    if name == "base_g":
        v = _base_g_variables(v)
        want = _jax_disp(BASE_G, v, img1, img2)
    model = GWCNet(GWCNetConfig.from_dict(_port_cfg(config)))
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        _, got = model.eval()(_t(img1), _t(img2))
    assert got.shape == (B, H, W) and bool((got <= 0).all())
    assert float(np.abs(want - np.round(want)).max()) > 0.1
    assert float(np.abs(got.numpy() - want).max()) <= 1e-3


def test_bf16_runs_and_its_gap(gwc):
    """base_gc as shipped (bf16 autocast, maxdisp 32 here) from the same
    weights: finite, of the image's size, and no further from the fp32
    JAX model than twice the JAX model's own bf16 forward is, in max and
    mean. Measured: the port 0.91 px max / 0.076 px mean, JAX's own bf16
    0.59 / 0.062 px (torch's autocast rounds in other places than the JAX
    model's casts)."""
    v, (img1, img2), want, _ = gwc
    jbf16 = _jax_disp(BASE_GC, v, img1, img2, mixed_precision=True)
    model = GWCNet(GWCNetConfig.from_dict({**BASE_GC, "maxdisp": 32}))
    assert model.cfg.mixed_precision
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        _, got = model.eval()(_t(img1), _t(img2))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    gap, own = np.abs(got.numpy() - want), np.abs(jbf16 - want)
    assert gap.max() <= 2 * own.max() and gap.mean() <= 2 * own.mean(), (gap.max(), own.max())


def test_train_bn_forward_and_statistics_match_jax(gwc):
    """``train_bn`` in train mode: the four heads and the updated running
    statistics against JAX's mutated ``batch_stats``, 1e-5 relative to
    each tensor's scale (measured 6.0e-6 and 3.6e-6). The variance is the
    biased one: torch's unbiased update would be off by n/(n-1), 7 % at
    the hourglasses' 1/16 levels (n = 16)."""
    v, (img1, img2), _, train_bn = gwc
    out_j, upd = train_bn(v)
    model = GWCNet(GWCNetConfig.from_dict(_port_cfg(BASE_GC, train_bn=True)), test_mode=False)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    model.train()
    with torch.no_grad():
        out = model(_t(img1), _t(img2))
    assert out["disp_preds"].shape == (4, B, H, W)
    _close(out["disp_preds"].numpy(), out_j["disp_preds"], 1e-5)
    want = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, upd[
        "batch_stats"])})
    got = model.state_dict()
    stats = [k for k in want if "running" in k]
    assert len(stats) == 2 * len([m for m in model.modules() if hasattr(m, "running_var")])
    moved = 0
    for k in stats:
        _close(got[k].numpy(), want[k].numpy(), 1e-5)
        before = state_dict_from_flax({"batch_stats": v["batch_stats"]})[k]
        moved += not torch.equal(got[k], before)
    assert moved == len(stats)
    # eval mode reads the running statistics and leaves them
    model.eval()
    snap = {k: got[k].clone() for k in stats}
    with torch.no_grad():
        model(_t(img1), _t(img2))
    assert all(torch.equal(model.state_dict()[k], snap[k]) for k in stats)


def test_loss_gwcnet_matches_jax():
    """The four-head smooth-L1 and its metrics, with invalid pixels and
    |gt| >= maxdisp masked; a NaN prediction gives ok false and a zero
    loss on both sides."""
    rng = np.random.default_rng(5)
    preds = -rng.uniform(0, 40, (4, 2, 6, 8)).astype(np.float32)
    gt = -rng.uniform(0, 40, (2, 6, 8)).astype(np.float32)
    valid = (rng.uniform(0, 1, (2, 6, 8)) > 0.3).astype(np.float32)
    for bad in (False, True):
        p = preds.copy()
        if bad:
            p[1, 0, 2, 3] = np.nan
        want = jloss_gwcnet(jnp.asarray(p), jnp.asarray(gt), jnp.asarray(valid), 32.0)
        got = loss_gwcnet(_t(p), _t(gt), _t(valid), 32.0)
        assert bool(got[3]) == bool(want[3]) == (not bad)
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6, abs=1e-7)
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            assert float(got[1][k]) == pytest.approx(float(want[1][k]), rel=1e-6), k
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(got[0]) == 0.0


def _grad_rel(model, grads_want):
    err2 = norm2 = 0.0
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err2 += float((g - grads_want[k]).square().sum())
        norm2 += float(grads_want[k].square().sum())
    return (err2 / norm2) ** 0.5


def test_gradients_match_jax(gwc):
    """Train mode with frozen batch norm (the DKT step's): the gradient of
    ``loss_gwcnet`` on every parameter against ``jax.grad``, 1e-3 relative
    L2 over all."""
    v, (img1, img2), _, _ = gwc
    rng = np.random.default_rng(6)
    gt = -rng.uniform(0, 30, (B, H, W)).astype(np.float32)
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    jm = JGWCNet(_jcfg(BASE_GC), test_mode=False)

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(img1),
                       jnp.asarray(img2))
        return jloss_gwcnet(out["disp_preds"], gt, valid, 32.0)[0]

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    model = GWCNet(GWCNetConfig.from_dict(_port_cfg(BASE_GC)), test_mode=False)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    model.train()
    loss = loss_gwcnet(model(_t(img1), _t(img2))["disp_preds"], _t(gt), _t(valid), 32.0)[0]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert sum(float(g.abs().sum()) for g in want.values()) > 0
    assert _grad_rel(model, want) <= 1e-3


# the metrics of the JAX step (dkt_stereo_tpu/train/dkt_step.py) for these
# models, whose losses report epe and the 1/3/5 px rates
STEP_METRICS = {"loss", "loss_GT", "loss_PL", "epe", "1px", "3px", "5px", "ema_divergence",
                "teacher_divergence", "ok", "learning_rate"}


def check_step_parts(config, variables, shape, seed):
    """One port DKT step of ``config`` from ``variables`` (student; the
    teacher nudged by 1 + 0.02 N(0, 1)): the JAX step's metrics, ok, the
    loss the sum of its parts, every graded student tensor moved, the
    frozen teacher and every batch-norm statistic untouched.

    The whole step is not held against the JAX step here: that step's XLA
    compile takes 40-55 s on the CPU for either model, past these files'
    budget. Its parts are: the test-mode forward (the teachers'), the
    train-mode outputs, the loss and its gradients against JAX in this
    file and in tests/test_torch_cgi.py, and F&E, the EMA, the clip and
    AdamW, which do not depend on the model, against JAX in
    tests/test_torch_train.py."""
    rng = np.random.default_rng(seed)
    B_, H_, W_ = shape
    teacher = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32),
        variables["params"]), "batch_stats": variables["batch_stats"]})
    hyper = DKTHyperParams(num_steps=100)
    state = create_dkt_state(config, hyper, params=state_dict_from_flax(variables),
                             teacher_params=teacher, device="cpu")
    before = {w: {k: x.clone() for k, x in getattr(state, w).state_dict().items()}
              for w in ("student", "teacher")}
    batch = {k: _t(rng.uniform(0, 255, (B_, H_, W_, 3)).astype(np.float32))
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = _t(-rng.uniform(0, 30, (B_, H_, W_)).astype(np.float32))
    batch["valid"] = _t((rng.uniform(0, 1, (B_, H_, W_)) > 0.3).astype(np.float32))
    state, metrics = make_dkt_train_step(config, hyper)(
        state, batch, generator=torch.Generator().manual_seed(seed))
    assert set(metrics) == STEP_METRICS and metrics["ok"] == 1.0 and state.applied_steps == 1
    assert metrics["loss_GT"] > 0 and metrics["loss_PL"] > 0
    assert metrics["loss"] == pytest.approx(metrics["loss_GT"] + hyper.pl_weight
                                            * metrics["loss_PL"], rel=1e-6)
    student = dict(state.student.named_parameters())
    graded = [k for k, p in student.items()
              if state.optimizer.state[p]["exp_avg"].abs().max() > 0]
    assert len(graded) > 0.9 * len(student)
    assert all(not torch.equal(student[k], before["student"][k]) for k in graded)
    for w in ("student", "teacher"):
        for k, x in getattr(state, w).state_dict().items():
            if w == "teacher" or "running" in k:
                assert torch.equal(x, before[w][k]), (w, k)
    return state, metrics


def test_dkt_step_parts(gwc):
    """One DKT step of base_gc (fp32, frozen calibrated batch norm) on the
    CPU, by :func:`check_step_parts`."""
    check_step_parts(_port_cfg(BASE_GC), gwc[0], (B, H, W), 7)


def test_state_dict_from_flax_matches_export_reference_pth(gwc):
    """Key for key and value for value, the JAX package's exporter given
    the port's state dict as its template; the port loads it strictly."""
    v = gwc[0]
    port = GWCNet(GWCNetConfig.from_dict(BASE_GC))
    ours = state_dict_from_flax(v)
    theirs = export_reference_pth(v, port.state_dict())
    assert set(ours) == set(theirs) == set(port.state_dict())
    for k in ("feature_extraction.firstconv.4.1.running_var",
              "feature_extraction.layer2.0.downsample.1.weight",
              "feature_extraction.layer4.2.conv2.0.weight",
              "feature_extraction.lastconv.2.weight", "dres0.2.0.weight",
              "dres3.conv5.0.weight", "dres4.redir1.1.running_mean", "classif0.2.weight"):
        assert k in ours, k
    for k, t in ours.items():
        assert t.dtype == theirs[k].dtype and torch.equal(t, theirs[k]), k
    port.load_state_dict(ours, strict=True)
    g = GWCNet(GWCNetConfig.from_dict(BASE_G))
    g.load_state_dict(state_dict_from_flax(_base_g_variables(v)), strict=True)


def test_registry_and_refused_options():
    """Both shipped configs build from the registry at full width, on the
    CPU when asked; all four classifiers exist in test mode; the loss
    adapter serves loss_gwcnet with the config's maxdisp; ``ptrans`` builds
    the projection head under the reference's names (its parity with JAX:
    tests/test_torch_ptrans.py); train_bn in the DKT step raises with its
    reason."""
    assert get_model("GWCNet")[0] is GWCNet
    for config, concat in ((BASE_G, False), (BASE_GC, True)):
        model = create_model(config, device="cpu", seed=0)
        assert model.test_mode and model.cfg.maxdisp == 192 and model.cfg.num_groups == 40
        assert hasattr(model.feature_extraction, "lastconv") == concat
        assert model.dres0[0][0].in_channels == 40 + 24 * concat
        assert all(hasattr(model, f"classif{i}") for i in range(4))
    fn = make_loss_adapter("GWCNet", {**BASE_GC, "maxdisp": 2})
    preds = {"disp_preds": torch.zeros(4, 1, 2, 2)}
    loss, metrics, mask, ok = fn(preds, -torch.tensor([[[1.0, 3.0], [1.0, 1.0]]]),
                                 torch.ones(1, 2, 2))
    assert bool(ok) and int(mask.sum()) == 3 and float(loss) == pytest.approx(2.7 * 0.5)
    head = GWCNet(GWCNetConfig(ptrans=True)).projection
    assert [type(m).__name__ for m in head] == ["Linear", "FrozenBatchNorm2d", "ReLU", "Linear"]
    assert (head[0].in_features, head[0].out_features, head[3].out_features) == (320, 320, 256)
    with pytest.raises(NotImplementedError, match="train_bn"):
        make_dkt_train_step({**BASE_GC, "train_bn": True}, DKTHyperParams())
