"""The port's CGI-Stereo slice against the JAX package: the
norm-correlation volume, the top-2 regression, Context-Geometry-Fusion and
the fusion hourglass, the whole model of configs/cgi/base.json in test mode
(fp32 and bf16), ``loss_cgi``, the train-mode gradients, one DKT step,
the weight bridge, the timm trunk import and the registry. Also the
norm factory's ``group``, ``none`` and ``instance_fast`` against JAX's
``Norm``, and RAFT-Stereo with ``context_norm: "group"``.

Weights are seeded numpy draws in the shapes of the JAX tree
(``tests/test_torch_gwcnet.py::draw_variables``), carried to the port by
``weights.state_dict_from_flax``; batch norm is frozen with random
statistics, as CGI always runs it. fp32 unless stated; maxdisp 32 at
1x64x128, so the 1/4 volume is 8x16x32 and the 1/32 maps are 2x4.

At random weights the hourglass's cost is nearly flat over disparity, so
the two largest entries of a pixel can lie within rounding of each other
and ``torch.topk`` and ``lax.top_k`` may keep different ones
(tests/test_cgi_parity.py:84-97). The pre-regression cost is therefore
held tightly, and the disparity by that test's rule: 90 % of pixels within
1e-4 px, all within one 4 px bin.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.losses.cgi import loss_cgi as jloss_cgi
from dkt_stereo_tpu.models import CGIStereo as JCGIStereo
from dkt_stereo_tpu.models import CGIStereoConfig as JConfig
from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JRAFTConfig
from dkt_stereo_tpu.models.cgi_stereo import ContextGeometryFusion as JCGF
from dkt_stereo_tpu.models.cgi_stereo import HourglassFusion as JHourglassFusion
from dkt_stereo_tpu.nn.mobilenetv2 import MobileNetV2Trunk as JTrunk
from dkt_stereo_tpu.nn.norms import Norm as JNorm
from dkt_stereo_tpu.ops.volumes import build_norm_correlation_volume as jnormcorr
from dkt_stereo_tpu.ops.volumes import regression_topk as jregression_topk
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu.train.checkpoint import import_timm_mobilenetv2 as jimport_timm
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.losses.cgi import loss_cgi
from dkt_stereo_tpu_torch.models.cgi_stereo import (
    CGIStereo, CGIStereoConfig, ContextGeometryFusion, HourglassFusion)
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.models.registry import create_model, get_model, make_loss_adapter
from dkt_stereo_tpu_torch.nn.norms import Norm
from dkt_stereo_tpu_torch.ops.volumes import build_norm_correlation_volume, regression_topk
from dkt_stereo_tpu_torch.train.checkpoint import import_timm_mobilenetv2
from dkt_stereo_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_gwcnet import _close, _grad_rel, _nchw, _t, check_step_parts, draw_variables

ROOT = Path(__file__).resolve().parents[1]
BASE = load_model_config(str(ROOT / "configs/cgi/base.json"))
SMALL = {"maxdisp": 32, "mixed_precision": False}
B, H, W = 1, 64, 128


def _jcfg(**kw):
    return JConfig.from_dict({**BASE, **SMALL, **kw})


def _port_model(variables, test_mode=True, **kw):
    model = CGIStereo(CGIStereoConfig.from_dict({**BASE, **SMALL, **kw}), test_mode=test_mode)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.train(not test_mode)


def _tie_flip_rule(got, want):
    diff = np.abs(got - want)
    assert diff.max() < 4.0 + 1e-3, diff.max()
    assert np.percentile(diff, 90) < 1e-4, np.percentile(diff, 90)
    return diff


@pytest.fixture(scope="module")
def cgi():
    """The tree, the images, and the JAX model's test-mode disparity and
    sown pre-regression cost (B, H/4, W/4, D/4)."""
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    model = JCGIStereo(_jcfg(), test_mode=True)
    v = draw_variables(model, rng, jnp.asarray(img1), jnp.asarray(img2))
    (_, disp), inter = jax.jit(lambda v: model.apply(
        v, jnp.asarray(img1), jnp.asarray(img2), mutable=["intermediates"]))(v)
    cost = np.asarray(inter["intermediates"]["cost_volume"][0])
    return v, (img1, img2), np.asarray(disp), cost


def test_norm_correlation_volume_matches_jax():
    """Features normalised with ``||f|| + 1e-5``, the channel mean of the
    products, zero where w < d, more disparities than columns: 1e-5."""
    rng = np.random.default_rng(1)
    f1, f2 = (rng.standard_normal((2, 5, 7, 12)).astype(np.float32) for _ in range(2))
    f1[0, 1, 2] = 0.0  # a zero feature: the 1e-5 keeps it finite
    want = jnormcorr(jnp.asarray(f1), jnp.asarray(f2), 9)
    got = build_norm_correlation_volume(_nchw(f1), _nchw(f2), 9)
    assert got.shape == (2, 1, 9, 5, 7)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want), atol=1e-5)


def test_regression_topk_matches_jax():
    """Top-2 and top-3 soft-argmin over tie-free costs (each pixel's
    entries a permutation of distinct levels 0.05 apart), with CGI's
    sample grid and with arbitrary samples: 1e-5."""
    rng = np.random.default_rng(2)
    D = 12
    cost = (0.05 * np.argsort(rng.uniform(size=(2, 5, 6, D)), axis=-1)).astype(np.float32)
    grid = np.broadcast_to(np.arange(D, dtype=np.float32), cost.shape)
    samples = rng.uniform(-3, 40, cost.shape).astype(np.float32)
    for k in (2, 3):
        for s in (grid, samples):
            want = jregression_topk(jnp.asarray(cost), jnp.asarray(s), k)
            got = regression_topk(_t(cost).permute(0, 3, 1, 2), _t(s).permute(0, 3, 1, 2), k)
            assert got.shape == (2, 1, 5, 6)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                       atol=1e-5)


@pytest.mark.parametrize("module", ["cgf", "hourglass_fusion"])
def test_fusion_modules_match_jax(module):
    """Context-Geometry-Fusion at 1/8 (the image features' projection
    broadcast over D, the (1, 5, 5) attention and aggregation) and the
    whole fusion hourglass with its three CGFs and the 8 -> 1 deconv:
    1e-4 relative."""
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((1, 8, 16, 32, 8)).astype(np.float32)
    imgs = [rng.standard_normal((1, 16 // s, 32 // s, c)).astype(np.float32)
            for s, c in ((1, 96), (2, 64), (4, 192), (8, 160))]
    if module == "cgf":
        cv = rng.standard_normal((1, 4, 8, 16, 16)).astype(np.float32)
        jm, args = JCGF(16, True, jnp.float32), (jnp.asarray(cv), jnp.asarray(imgs[1]))
        port, prefix = ContextGeometryFusion(16, 64), "hourglass_fusion.CGF_8"
        targs = (_t(cv).permute(0, 4, 1, 2, 3), _nchw(imgs[1]))
    else:
        jm = JHourglassFusion(8, True, jnp.float32)
        args = (jnp.asarray(vol), [jnp.asarray(x) for x in imgs])
        port, prefix = HourglassFusion(8), "hourglass_fusion"
        targs = (_t(vol).permute(0, 4, 1, 2, 3), [_nchw(x) for x in imgs])
    v = draw_variables(jm, rng, *args)
    want = jax.jit(jm.apply)(v, *args)
    nested = {}
    for coll, tree in v.items():
        for p in reversed(prefix.split(".")):
            tree = {p: tree}
        nested[coll] = tree
    sd = state_dict_from_flax(nested)
    port.load_state_dict({k.removeprefix(prefix + "."): x for k, x in sd.items()}, strict=True)
    with torch.no_grad():
        got = port.eval()(*targs)
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want, 1e-4)


def test_test_mode_matches_jax(cgi):
    """The whole model in test mode (fp32): the pre-regression cost (read
    by a hook on ``hourglass_fusion``) within 1e-4 of JAX's sown
    ``cost_volume``, the disparity by the tie-flip rule."""
    v, (img1, img2), want, want_cost = cgi
    model = _port_model(v)
    seen = {}
    model.hourglass_fusion.register_forward_hook(lambda m, i, o: seen.__setitem__("cost", o))
    with torch.no_grad():
        _, got = model(_t(img1), _t(img2))
    cost = seen["cost"][:, 0].permute(0, 2, 3, 1).numpy()
    assert cost.shape == want_cost.shape == (B, H // 4, W // 4, 8)
    assert float(np.abs(cost - want_cost).max()) <= 1e-4
    assert got.shape == (B, H, W) and bool((got <= 0).all())
    _tie_flip_rule(got.numpy(), want)


def test_bf16_runs_and_its_gap(cgi):
    """base.json as shipped (bf16 autocast, maxdisp 32 here): finite, of the
    image's size; its cost within 5 % of the fp32 cost's scale of JAX's
    fp32 cost (measured 0.4 %)."""
    v, (img1, img2), _, want_cost = cgi
    model = _port_model(v, mixed_precision=True)
    seen = {}
    model.hourglass_fusion.register_forward_hook(lambda m, i, o: seen.__setitem__("cost", o))
    with torch.no_grad():
        _, got = model(_t(img1), _t(img2))
    assert got.dtype == torch.float32 and got.shape == (B, H, W)
    assert bool(torch.isfinite(got).all())
    cost = seen["cost"][:, 0].float().permute(0, 2, 3, 1).numpy()
    _close(cost, want_cost, 5e-2)


def test_loss_cgi_matches_jax():
    """The quarter-resolution head against every 4th GT pixel (0.3) plus the
    full one (1.0), masks and metrics; a NaN in either head gives ok false
    and a zero loss on both sides."""
    rng = np.random.default_rng(5)
    q = -rng.uniform(0, 40, (2, 3, 4)).astype(np.float32)
    f = -rng.uniform(0, 40, (2, 12, 16)).astype(np.float32)
    gt = -rng.uniform(0, 40, (2, 12, 16)).astype(np.float32)
    valid = (rng.uniform(0, 1, (2, 12, 16)) > 0.3).astype(np.float32)
    for bad in (None, 0, 1):
        pq, pf = q.copy(), f.copy()
        if bad is not None:
            (pq, pf)[bad][1, 2, 3] = np.nan
        want = jloss_cgi([jnp.asarray(pq), jnp.asarray(pf)], jnp.asarray(gt),
                         jnp.asarray(valid), 32.0)
        got = loss_cgi([_t(pq), _t(pf)], _t(gt), _t(valid), 32.0)
        assert bool(got[3]) == bool(want[3]) == (bad is None)
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6, abs=1e-7)
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            assert float(got[1][k]) == pytest.approx(float(want[1][k]), rel=1e-6), k
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert float(got[0]) == 0.0


def test_gradients_match_jax(cgi):
    """Train mode: ``{"disp_preds": [quarter, full]}`` within the tie-flip
    rule of JAX's, and the gradient of ``loss_cgi`` on every parameter
    against ``jax.grad``, 1e-3 relative L2 over all. The reference's
    never-run modules (``feature.deconv32_16``, ``conv1_up``'s batch
    norm) get none."""
    v, (img1, img2), _, _ = cgi
    rng = np.random.default_rng(6)
    gt = -rng.uniform(0, 30, (B, H, W)).astype(np.float32)
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.3).astype(np.float32)
    jm = JCGIStereo(_jcfg(), test_mode=False)

    def loss_fn(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(img1),
                       jnp.asarray(img2))
        return jloss_cgi(out["disp_preds"], gt, valid, 32.0)[0], out["disp_preds"]

    (loss_j, preds_j), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    model = _port_model(v, test_mode=False)
    out = model(_t(img1), _t(img2))
    for g, w in zip(out["disp_preds"], preds_j):
        _tie_flip_rule(g.detach().numpy(), np.asarray(w))
    loss = loss_cgi(out["disp_preds"], _t(gt), _t(valid), 32.0)[0]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-4)
    unused = [k for k, p in model.named_parameters() if p.grad is None]
    assert unused and all(k.startswith(("feature.deconv32_16.", "hourglass_fusion.conv1_up.bn."))
                          for k in unused), unused
    assert _grad_rel(model, {**want, **{k: torch.zeros_like(dict(model.named_parameters())[k])
                                         for k in unused}}) <= 1e-3


def test_dkt_step_parts(cgi):
    """One DKT step of base.json (fp32) on the CPU, by
    ``tests/test_torch_gwcnet.py::check_step_parts``: the reference's
    never-run modules get no gradient and stay as they were loaded."""
    state, _ = check_step_parts({**BASE, **SMALL}, cgi[0], (B, H, W), 7)
    student = dict(state.student.named_parameters())
    unused = [k for k, p in student.items() if not state.optimizer.state[p]["exp_avg"].any()]
    assert unused and all(k.startswith(("feature.deconv32_16.", "hourglass_fusion.conv1_up.bn."))
                          for k in unused), unused
    assert not student["feature.deconv32_16.conv1.conv.weight"].any()


def test_state_dict_from_flax_matches_export_reference_pth(cgi):
    """Key for key and value for value, the JAX package's exporter given
    the port's state dict as its template (the modules the reference builds
    and never runs pass through it: ``feature.deconv32_16``, zero kernels
    and initial batch norms here, and ``conv1_up.bn``); the port loads it
    strictly."""
    v = cgi[0]
    port = CGIStereo(CGIStereoConfig.from_dict(BASE))
    ours = state_dict_from_flax(v)
    port.load_state_dict(ours, strict=True)
    theirs = export_reference_pth(v, port.state_dict())
    assert set(ours) == set(theirs) == set(port.state_dict())
    for k in ("feature.block3.1.2.conv_pwl.weight", "feature_up.deconv32_16.conv1.conv.weight",
              "stem_4.2.running_var", "spx_4.1.weight", "spx.0.bias", "semantic.1.weight",
              "hourglass_fusion.CGF_16.att.1.weight", "hourglass_fusion.agg_1.2.bn.weight",
              "hourglass_fusion.conv1_up.bn.running_var"):
        assert k in ours, k
    assert not ours["feature.deconv32_16.conv2.conv.weight"].any()
    assert ours["feature.deconv32_16.conv2.conv.weight"].shape == (192, 192, 3, 3)
    for k, t in ours.items():
        assert t.dtype == theirs[k].dtype and torch.equal(t, theirs[k]), k


def test_pretrained_backbone_into_cgi(tmp_path):
    """A raw timm ``mobilenetv2_100`` state (``tests/fake_timm.py``) placed by
    ``import_timm_mobilenetv2`` in CGI's trunk equals the JAX importer's
    CGI trunk (``feature_trunk``) through ``state_dict_from_flax``; the rest
    of the model, ``feature.deconv32_16`` included, is untouched."""
    from tests import fake_timm

    torch.manual_seed(0)
    timm = fake_timm.create_model("mobilenetv2_100", features_only=True).state_dict()
    for k, x in timm.items():
        if k.endswith("running_mean") or k.endswith("weight") and x.dim() == 1:
            timm[k] = torch.randn_like(x)
    shapes = jax.eval_shape(JTrunk().init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    template = {c: {"feature_trunk": jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes[c])} for c in ("params", "batch_stats")}
    want = state_dict_from_flax(jimport_timm(timm, template))
    model = create_model(BASE, device="cpu", seed=0)
    before = model.state_dict()
    got = import_timm_mobilenetv2(timm, model)
    placed = [k for k in want if not k.endswith("num_batches_tracked")]
    assert len(placed) > 200 and all(k.startswith("feature.") for k in placed)
    for k, x in before.items():
        if k in placed:
            assert torch.equal(got[k], want[k]), k
        else:
            assert torch.equal(got[k], x), k
    model.load_state_dict(got, strict=True)


def test_registry_builds_the_shipped_config():
    """cgi/base.json builds from the registry at full width, on the CPU
    when asked; ``make_loss_adapter`` serves loss_cgi with the config's
    maxdisp; ns_loss raises the JAX registry's ValueError."""
    assert get_model("CGI_Stereo")[0] is CGIStereo
    model = create_model(BASE, device="cpu", seed=0)
    assert model.test_mode and model.cfg.maxdisp == 192 and model.cfg.mixed_precision
    with torch.no_grad():
        _, disp = model(*torch.rand(2, 1, 32, 64, 3).mul(255))
    assert disp.shape == (1, 32, 64) and bool(torch.isfinite(disp).all())
    fn = make_loss_adapter("CGI_Stereo", {**BASE, "maxdisp": 2})
    preds = {"disp_preds": [torch.zeros(1, 1, 1), torch.zeros(1, 4, 4)]}
    gt = -torch.ones(1, 4, 4)
    gt[0, 1, 1] = -3.0
    loss, metrics, mask, ok = fn(preds, gt, torch.ones(1, 4, 4))
    assert bool(ok) and int(mask.sum()) == 15 and float(loss) == pytest.approx(0.3 * 0.5 + 0.5)
    with pytest.raises(ValueError, match="trinocular batch contract"):
        make_loss_adapter("CGI_Stereo", BASE, "ns_loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_fn", ["group", "none", "instance_fast"])
def test_norms_match_jax(norm_fn, dtype):
    """The norm factory's other three norms against JAX's ``Norm`` (group:
    8 groups of 8 with a random affine; instance_fast: statistics from every
    4th row and column) on an odd-sized map: fp32 within 1e-5 of the
    output's scale, bf16 within two bf16 steps of it (2^-7)."""
    rng = np.random.default_rng(8)
    x = (3 + 2 * rng.standard_normal((2, 19, 23, 64))).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JNorm(norm_fn, 8, True, jdt)
    xj = jnp.asarray(x).astype(jdt)
    v = draw_variables(jm, rng, xj)
    want = np.asarray(jax.jit(jm.apply)(v, xj).astype(jnp.float32))
    port = Norm(norm_fn, 64)
    if norm_fn == "group":
        sd = state_dict_from_flax({c: {"norm1": t} for c, t in v.items()})
        port.load_state_dict({k.removeprefix("norm1."): x for k, x in sd.items()}, strict=True)
    else:
        assert not list(port.parameters())
    got = port(_nchw(x).to(tdt)).detach()
    assert got.dtype == tdt
    _close(got.float().permute(0, 2, 3, 1).numpy(), want, 1e-5 if dtype == "float32" else 2**-6)


def test_raft_group_context_norm_matches_jax():
    """RAFT-Stereo's pallas.json fields with ``context_norm: "group"`` (the
    context encoder's GroupNorms: 8 groups for the stem, planes / 8 in the
    residual blocks), fp32, 2 iterations, against the JAX model with the
    plain lookup: 2.5e-3 px, the unfused RAFT slice's bound
    (tests/test_torch_raft.py)."""
    rng = np.random.default_rng(9)
    config = {**load_model_config(str(ROOT / "configs/raft_stereo/pallas.json")),
              "mixed_precision": False, "corr_dtype": "float32", "pallas_encoder": False,
              "context_norm": "group"}
    img1, img2 = (rng.uniform(0, 255, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    jm = JRAFTStereo(JRAFTConfig.from_dict({**config, "corr_implementation": "reg"}), iters=2,
                     test_mode=True)
    v = draw_variables(jm, rng, jnp.asarray(img1), jnp.asarray(img2))
    assert "GroupNorm_0" in v["params"]["cnet"]["norm1"]
    _, want = jax.jit(jm.apply)(v, jnp.asarray(img1), jnp.asarray(img2))
    model = RAFTStereo(RAFTStereoConfig.from_dict(config), iters=2)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        _, got = model.eval()(_t(img1), _t(img2))
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 2.5e-3
