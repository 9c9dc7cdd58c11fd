"""The port's IGEV-Stereo inference slice against the JAX package: each
module that the forward runs, with weights carried across by
``weights.state_dict_from_flax``; the whole model with the pallas.json
fields through ``make_forward_fn`` / ``_run_one`` on the CPU (K4's plain
version) against the JAX model with ``reg_cuda`` (the Pallas lookup in
interpret mode), with ``agg_packed`` on and off and at the shipped
``max_disp``; the weight bridge; the pyramid storage rule; the registry.

fp32 on both sides. Module bounds are relative to the output's scale: 1e-4
for the feature net and the hourglass (instance-norm statistics and stacks
of 3x3(x3) convs summed in another order), 1e-5 for the update block. The
slice's bound is 1e-3 px, the JAX package's own bound between its reg and
Pallas lookups (tests/test_pallas_geo.py) and between its packed and
direct aggregation (tests/test_igev_packed.py). Random IGEV weights are
chaotic under fp32 reordering over GRU iterations, as RAFT's are, so the
slice runs 2 iterations, with the disparity head scaled down (see
``jax_params``).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.models import IGEVStereo as JIGEVStereo
from dkt_stereo_tpu.models import IGEVStereoConfig as JConfig
from dkt_stereo_tpu.nn.igev_blocks import HourglassIGEV as JHourglass
from dkt_stereo_tpu.nn.igev_blocks import IGEVFeature as JFeature
from dkt_stereo_tpu.nn.igev_update import BasicMultiUpdateBlockIGEV as JUpdateBlock
from dkt_stereo_tpu.nn.mobilenetv2 import MobileNetV2Trunk as JTrunk
from dkt_stereo_tpu.ops.pad import pad_input as jpad_input
from dkt_stereo_tpu.ops.pad import unpad_input as junpad
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
from dkt_stereo_tpu_torch.models.igev_stereo import IGEVStereo, IGEVStereoConfig
from dkt_stereo_tpu_torch.models.registry import create_model, get_model
from dkt_stereo_tpu_torch.nn.igev_blocks import HourglassIGEV, IGEVFeature
from dkt_stereo_tpu_torch.nn.igev_update import BasicMultiUpdateBlockIGEV
from dkt_stereo_tpu_torch.nn.mobilenetv2 import MobileNetV2Trunk
from dkt_stereo_tpu_torch.weights import state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
PALLAS = load_model_config(str(ROOT / "configs/igev_stereo/pallas.json"))
BASE = load_model_config(str(ROOT / "configs/igev_stereo/base.json"))
FP32 = {"mixed_precision": False}
ITERS = 2


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


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


def _load(module, variables, prefix=""):
    """Load a JAX sub-module's variables into the port's module; ``prefix``
    nests them where the IGEV name rules expect them."""
    nested = {}
    for coll, tree in variables.items():
        for p in reversed(prefix.split(".") if prefix else []):
            tree = {p: tree}
        nested[coll] = tree
    sd = state_dict_from_flax(nested, igev=True)
    head = {"feature.trunk": "feature."}.get(prefix, prefix + "." if prefix else "")
    module.load_state_dict({k.removeprefix(head): v for k, v in sd.items()}, strict=True)
    return module.eval()


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("module", ["trunk", "feature"])
def test_feature_net_matches_jax(module):
    """MobileNetV2 trunk taps and IGEV's fused feature maps, at a size whose
    1/16 and 1/32 maps are odd (the Conv2x nearest resize runs)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 48, 80, 3)).astype(np.float32)
    jm = JTrunk(True, jnp.float32) if module == "trunk" else JFeature(True, jnp.float32)
    v = _randomize_norms(_numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))),
                         rng)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    if module == "trunk":
        port = _load(MobileNetV2Trunk(), v, "feature.trunk")
    else:
        port = _load(IGEVFeature(), v, "feature")
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(want) == (5 if module == "trunk" else 4)
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)


def test_hourglass_matches_jax():
    """The 3D hourglass with feature attention at every scale, direct 3D
    convs on both sides; the volume (B, D, H, W, C) in JAX, (B, C, D, H, W)
    in the port."""
    rng = np.random.default_rng(2)
    B, D, H, W = 1, 16, 8, 16
    x = rng.standard_normal((B, D, H, W, 8)).astype(np.float32)
    feats = [rng.standard_normal((B, H >> i, W >> i, c)).astype(np.float32)
             for i, c in enumerate((48, 64, 192, 160))]
    jm = JHourglass(8, True, jnp.float32, False)
    jx, jf = jnp.asarray(x), [jnp.asarray(f) for f in feats]
    v = _randomize_norms(_numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), jx, jf)), rng)
    want = np.asarray(jax.jit(jm.apply)(v, jx, jf))
    port = _load(HourglassIGEV(8), v)
    with torch.no_grad():
        got = port(_t(x).permute(0, 4, 1, 2, 3), [_nchw(f) for f in feats])
    assert got.shape == (B, 8, D, H, W)
    _close(got.permute(0, 2, 3, 4, 1).numpy(), want, 1e-4)


def test_update_block_matches_jax():
    """One GRU update with the mask feature on: new hidden states, the
    32-channel mask feature and the disparity delta."""
    rng = np.random.default_rng(3)
    B, H, W = 1, 8, 12
    net = [np.tanh(rng.standard_normal((B, H >> i, W >> i, 128))).astype(np.float32)
           for i in range(3)]
    inp = [[(0.5 * rng.standard_normal((B, H >> i, W >> i, 128))).astype(np.float32)
            for _ in range(3)] for i in range(3)]
    corr = rng.standard_normal((B, H, W, 162)).astype(np.float32)
    disp = rng.uniform(0, 20, (B, H, W, 1)).astype(np.float32)
    jm = JUpdateBlock(3, (128, 128, 128), jnp.float32)
    jargs = ([jnp.asarray(n) for n in net], [[jnp.asarray(c) for c in i] for i in inp],
             jnp.asarray(corr), jnp.asarray(disp))
    v = _numpy_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), *jargs))
    want_net, want_mask, want_delta = jax.jit(jm.apply)(v, *jargs)
    port = _load(BasicMultiUpdateBlockIGEV(3, (128, 128, 128), 2, 4), v)
    with torch.no_grad():
        got_net, got_mask, got_delta = port([_nchw(n) for n in net],
                                            [[_nchw(c) for c in i] for i in inp],
                                            _nchw(corr), _nchw(disp))
    for g, w in zip([*got_net, got_mask, got_delta], [*want_net, want_mask, want_delta]):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5)


@pytest.fixture(scope="module")
def jax_params():
    """One JAX init, in train mode: its tree also holds the heads the
    test-mode tree lacks (spx_4_*, spx_2, spx_0), which the reference
    module and the port have. No parameter depends on max_disp or on the
    lookup, so the init runs the XLA lookup (``reg``): the same tree, value
    for value, as with ``reg_cuda``, without tracing the Pallas lookup in
    interpret mode.

    The disparity head's last conv is scaled by 0.05, so that an iteration
    moves the disparity by a few px, as a trained model's does. At the
    random init's scale an iteration moves it by tens to hundreds of px,
    and fp32 reordering alone, even between the JAX package's own packed
    and direct aggregations, then grows with every iteration toward the
    1e-3 px bound."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.uniform(0, 255, (1, 32, 64, 3)).astype(np.float32))
    model = JIGEVStereo(JConfig.from_dict({**PALLAS, **FP32, "max_disp": 32,
                                           "corr_implementation": "reg"}), ITERS, test_mode=False)
    variables = _randomize_norms(_numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), x, x)),
                                 rng)
    head = variables["params"]["step"]["update_block"]["disp_head"]["conv2"]
    head["kernel"] = head["kernel"] * np.float32(0.05)
    return variables


def _jax_disp(variables, img1, img2, **cfg):
    model = JIGEVStereo(JConfig.from_dict({**PALLAS, **FP32, **cfg}), ITERS, test_mode=True)
    x1, spec = jpad_input(jnp.asarray(img1[None]), 32, "sintel")
    x2, _ = jpad_input(jnp.asarray(img2[None]), 32, "sintel")
    _, disp = jax.jit(model.apply)(variables, x1, x2)
    return np.asarray(junpad(disp[..., None], spec))[0, ..., 0]


@pytest.mark.parametrize("hw, max_disp, agg_packed", [
    ((30, 60), 32, False),
    ((30, 60), 32, True),
    ((64, 192), 192, True),
])
def test_slice_matches_jax(jax_params, hw, max_disp, agg_packed):
    """pallas.json (max_disp cut where stated) in fp32 through
    make_forward_fn/_run_one on the CPU vs the JAX model with reg_cuda (its
    Pallas lookup in interpret mode): 1e-3 px."""
    rng = np.random.default_rng(5)
    img1, img2 = (rng.uniform(0, 255, (*hw, 3)).astype(np.float32) for _ in range(2))
    want = _jax_disp(jax_params, img1, img2, max_disp=max_disp, agg_packed=agg_packed)
    cfg = IGEVStereoConfig.from_dict({**PALLAS, **FP32, "max_disp": max_disp,
                                      "agg_packed": agg_packed})
    model = IGEVStereo(cfg, iters=ITERS)
    model.load_state_dict(state_dict_from_flax(jax_params), strict=True)
    disp, seconds = _run_one(make_forward_fn(model, device="cpu"), img1, img2)
    assert disp.shape == want.shape == hw and seconds > 0
    assert float(np.abs(want).max()) > 5.0  # the GRU moved the disparity
    assert float(np.abs(disp - want).max()) <= 1e-3


def test_state_dict_from_flax_matches_export_reference_pth(jax_params):
    """Key for key and value for value, the JAX package's own exporter given
    the port's state dict as its template (its unused batch-norm slots,
    ``conv1_up.bn``, pass through with their initial values); the port then
    loads it strictly."""
    port = IGEVStereo(IGEVStereoConfig.from_dict(PALLAS), iters=1)
    ours = state_dict_from_flax(jax_params)
    theirs = export_reference_pth(jax_params, port.state_dict())
    assert set(ours) == set(theirs) == set(port.state_dict())
    assert "cost_agg.conv1_up.bn.running_var" in ours and "feature.block3.1.2.conv_pwl.weight" in ours
    for k, t in ours.items():
        assert t.dtype == theirs[k].dtype and torch.equal(t, theirs[k]), k
    port.load_state_dict(ours, strict=True)


def test_mixed_precision_and_base_configs_run_on_cpu():
    """pallas.json as shipped (bf16 autocast) and base.json from a seed:
    finite output of the input's size; the same seed gives the same
    weights."""
    x = torch.tensor(np.random.default_rng(6).uniform(0, 255, (2, 1, 32, 64, 3)),
                     dtype=torch.float32)
    for config in (PALLAS, BASE):
        model = create_model({**config, "max_disp": 32}, iters=2, device="cpu", seed=0)
        with torch.inference_mode():
            none, disp = model(x[0], x[1])
        assert none is None and disp.shape == (1, 32, 64) and disp.dtype == torch.float32
        assert torch.isfinite(disp).all()
    again = create_model({**BASE, "max_disp": 32}, iters=2, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    # 3-D and transposed convs are drawn too (not left at torch's default init)
    w = model.cost_agg.conv3_up.conv.weight
    assert abs(float(w.detach().std()) - (2.0 / (w.shape[0] * 64)) ** 0.5) < 0.01


def test_pyramid_storage_follows_the_jax_rule():
    """bf16 pyramids only on an accelerator with a kernel implementation and
    corr_dtype bfloat16, whatever mixed_precision says."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    pallas = IGEVStereoConfig.from_dict(PALLAS)
    assert pallas.pyramid_dtype(cuda) == torch.bfloat16
    assert IGEVStereoConfig.from_dict({**PALLAS, **FP32}).pyramid_dtype(cuda) == torch.bfloat16
    assert pallas.pyramid_dtype(cpu) == torch.float32
    assert IGEVStereoConfig.from_dict(BASE).pyramid_dtype(cuda) == torch.float32
    fp32 = IGEVStereoConfig.from_dict({**PALLAS, "corr_dtype": "float32"})
    assert fp32.pyramid_dtype(cuda) == torch.float32


def test_registry_and_unported_modes():
    """The registry entry; train mode (pallas.json) and train.json (with
    remat_iters) build and return the train contract, and train.json's
    test-mode model (the teachers) keeps the test contract; without a card
    the default device raises."""
    assert get_model("IGEVStereo") == (IGEVStereo, IGEVStereoConfig)
    train = json.loads((ROOT / "configs/igev_stereo/train.json").read_text())
    x = torch.tensor(np.random.default_rng(7).uniform(0, 255, (2, 1, 32, 64, 3)),
                     dtype=torch.float32)
    for config in (PALLAS, train):
        model = create_model({**config, "max_disp": 32}, iters=2, device="cpu", seed=0,
                             test_mode=False)
        assert model.training and model.cfg.remat_iters == (config is train)
        out = model(x[0], x[1])
        assert set(out) == {"init_disp", "disp_preds"}
        assert out["init_disp"].shape == (1, 32, 64) and out["disp_preds"].shape == (2, 1, 32, 64)
        assert all(bool(torch.isfinite(v).all()) and v.requires_grad for v in out.values())
    with torch.inference_mode():
        none, disp = create_model({**train, "max_disp": 32}, iters=2, device="cpu", seed=0)(*x)
    assert none is None and disp.shape == (1, 32, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(PALLAS)
