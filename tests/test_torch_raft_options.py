"""RAFT-Stereo's options that no shipped config sets, against the JAX model
on the CPU: the cosine pyramid, ``mix_fmap_image`` (test mode, and train
mode at a fixed blend weight), ``backbone_type="interpolate"`` (looked up by
K1's and K3's plain twins), ``shared_backbone`` and ``fast_in_stats``
(with and without ``pallas_encoder``); the correlation ops they build on;
and the weight bridge's strict round trips for the modules they add.

Weights are seeded numpy draws in the shapes of ``jax.eval_shape(init)``,
carried over by ``state_dict_from_flax``, so no JAX init is compiled. The
model is pallas.json's in fp32 at narrow widths, one GRU of 32 channels,
1x32x64, 2 iterations, the flow head's last conv scaled by 0.1: random
RAFT is chaotic (fp32 reordering of features equal to 2e-6 moved the
undamped shared-backbone disparity by 2.6e-3 px), and one GRU halves the
JAX compiles. The port builds all three GRU levels' modules, as
the reference does; the two a 1-GRU model never runs keep their seeded
init (:func:`_load`). The round trips hold the 3-GRU trees.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JConfig
from dkt_stereo_tpu.ops import corr as jcorr
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.ops import corr
from dkt_stereo_tpu_torch.weights import load_reference_pth, state_dict_from_flax
from tests.test_torch_gwcnet import draw_variables

ROOT = Path(__file__).resolve().parents[1]
BASE = {**load_model_config(str(ROOT / "configs/raft_stereo/pallas.json")),
        "mixed_precision": False, "corr_dtype": "float32", "pallas_encoder": False,
        "hidden_dims": [32, 32, 32], "n_gru_layers": 1}
# the modules of the GRU levels a 1-GRU model does not run
UNUSED = ("cnet.layer4.", "cnet.layer5.", "cnet.outputs16.", "cnet.outputs32.",
          "update_block.gru16.", "update_block.gru32.")
ITERS = 2
OPTIONS = {
    "cosine": {"corr_implementation": "cosine"},
    "mix_fmap_image": {"corr_implementation": "mix_fmap_image"},
    "interpolate_reg_cuda": {"backbone_type": "interpolate", "corr_implementation": "reg_cuda"},
    "interpolate_alt_cuda": {"backbone_type": "interpolate", "corr_implementation": "alt_cuda"},
    "shared_backbone": {"shared_backbone": True},
    "fast_in_stats": {"fast_in_stats": True},
    "fast_in_stats_pallas_encoder": {"fast_in_stats": True, "pallas_encoder": True},
}
# the JAX run each option is held against: JAX's test-mode mix takes the
# cosine branch, and its alt_cuda equals reg (models/raft_stereo.py:57-60),
# so the interpolate backbone's two lookups share one XLA run
JAX_RUN = {"mix_fmap_image": "cosine", "interpolate_alt_cuda": "interpolate_reg_cuda"}


def _jcfg(option: dict) -> JConfig:
    """The JAX model's config: its XLA lookup (``reg``) where the port's
    config names a Pallas one, which JAX holds equal to it and whose
    interpret-mode trace takes ~5 s a model."""
    cfg = {**BASE, **option}
    if cfg["corr_implementation"] in ("reg_cuda", "alt_cuda"):
        cfg["corr_implementation"] = "reg"
    return JConfig.from_dict(cfg)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return tuple(rng.uniform(0, 255, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def variables(images):
    """Seeded variables for each parameter tree: the default backbone's
    (cosine, mix, fast_in_stats share it), the interpolate backbone's (no
    fnet) and the shared backbone's (conv2_res, conv2_out, no fnet)."""
    rng = np.random.default_rng(1)
    trees = {}
    for name, option in (("default", {}), ("interpolate", OPTIONS["interpolate_reg_cuda"]),
                         ("shared", OPTIONS["shared_backbone"])):
        model = JRAFTStereo(_jcfg(option), iters=ITERS, test_mode=True)
        tree = draw_variables(model, rng, *images)
        head = tree["params"]["step"]["update_block"]["flow_head"]["conv2"]
        head["kernel"] = head["kernel"] * np.float32(0.1)
        trees[name] = tree
    return trees


def _load(model, tree):
    """The JAX tree's weights into ``model``: every key it has, and only the
    unused GRU levels' missing."""
    missing, unexpected = model.load_state_dict(state_dict_from_flax(tree), strict=False)
    assert not unexpected and missing and all(k.startswith(UNUSED) for k in missing), missing
    return model


def _tree(option):
    return ("interpolate" if "interpolate" in option
            else "shared" if option == "shared_backbone" else "default")


@pytest.fixture(scope="module")
def jax_disps(images, variables):
    """The JAX test-mode disparity of every option that has a run of its own."""
    out = {}
    for option, override in OPTIONS.items():
        if option in JAX_RUN:
            continue
        model = JRAFTStereo(_jcfg(override), iters=ITERS, test_mode=True)
        out[option] = np.asarray(jax.jit(model.apply)(variables[_tree(option)], *images)[1])
    return out


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_test_mode_matches_jax(option, images, variables, jax_disps):
    """Each option's test-mode disparity against the JAX model's from the
    same weights. Bounds: tests/test_torch_raft.py's, 2.5e-3 px unfused and
    5e-3 px with the fused encoder (the JAX package's own bound between
    its fused and unfused paths). Measured 1.4e-4 to 9.3e-4 px on disparities
    of 38-84 px. The port looks ``cosine`` up through K1's plain twin where
    JAX takes its XLA lookup."""
    cfg = RAFTStereoConfig.from_dict({**BASE, **OPTIONS[option]})
    model = _load(RAFTStereo(cfg, iters=ITERS).eval(), variables[_tree(option)])
    assert not hasattr(model, "fnet") or option.startswith(("cosine", "mix", "fast"))
    with torch.no_grad():
        coarse, disp = model(*map(_t, images))
    want = jax_disps[JAX_RUN.get(option, option)]
    tol = 5e-3 if cfg.pallas_encoder else 2.5e-3
    assert coarse.shape == (1, 8, 16, 1) and disp.shape == want.shape == (1, 32, 64)
    assert float((disp - _t(want)).abs().max()) <= tol


def test_mix_fmap_image_train_mode_matches_jax(images, variables, monkeypatch):
    """Train-mode ``mix_fmap_image``: the feature and the image cosine
    volumes blended by the weight JAX draws from its ``mix`` key, pooled
    and looked up; the port takes that weight as ``mix_weight``. Bound: the
    train-mode bound of tests/test_torch_train.py, 2.5e-3 px. Without a
    weight or a generator both sides blend at 0.5; with a generator the
    port draws one weight a forward."""
    cfg = {**BASE, **OPTIONS["mix_fmap_image"]}
    jmodel = JRAFTStereo(JConfig.from_dict(cfg), iters=ITERS, test_mode=False)
    v = variables["default"]
    seen, uniform = [], jax.random.uniform

    def recorded(*args, **kw):  # the weight the model draws from its mix key
        u = uniform(*args, **kw)
        jax.debug.callback(lambda x: seen.append(float(x)), u)
        return u

    monkeypatch.setattr(jax.random, "uniform", recorded)
    want = jax.jit(lambda v, a, b, k: jmodel.apply(v, a, b, rngs={"mix": k}))(
        v, *images, jax.random.PRNGKey(5))
    jax.block_until_ready(want)
    monkeypatch.undo()
    half = jax.jit(jmodel.apply)(v, *images)
    assert len(seen) == 1 and 0 < seen[0] < 1
    p = seen[0]
    model = _load(RAFTStereo(RAFTStereoConfig.from_dict(cfg), iters=ITERS, test_mode=False), v)
    x1, x2 = map(_t, images)
    for got, ref in ((model(x1, x2, mix_weight=p), want), (model(x1, x2), half)):
        got, ref = got["disp_preds"].detach(), _t(np.asarray(ref["disp_preds"]))
        assert got.shape == ref.shape == (ITERS, 1, 32, 64)
        assert float((got - ref).abs().max()) <= 2.5e-3
    a = model(x1, x2, generator=torch.Generator().manual_seed(0))["disp_preds"]
    b = model(x1, x2, mix_weight=torch.rand((), generator=torch.Generator().manual_seed(0)))
    assert torch.equal(a, b["disp_preds"])
    assert not torch.equal(a, model(x1, x2)["disp_preds"])
    # the blend reaches the features through K1's lookup and the pyramid
    a.abs().mean().backward()
    assert float(model.fnet.conv2.weight.grad.norm()) > 0


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlation_ops_match_jax(normalize, dtype):
    """``corr_volume``, ``corr_pyramid`` of it and ``corr_pyramid_fused``
    (``normalize``: the cosine forms) against JAX at odd widths: fp32 within
    1e-5 of the values' scale; with bf16 features and bf16 storage within
    one bf16 step. The pooled pyramid of a bf16 volume rounds the volume
    before pooling; the fused one rounds each level's own fp32 product."""
    rng = np.random.default_rng(2)
    f1, f2 = (rng.standard_normal((2, 3, 37, 16)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j1, j2 = jnp.asarray(f1, jdt), jnp.asarray(f2, jdt)
    t1, t2 = _t(f1).to(tdt), _t(f2).to(tdt)
    tol = 1e-5 if dtype == "float32" else 2.0**-7

    def close(got, want):
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        assert float((got.float() - _t(want)).abs().max()) <= tol * max(np.abs(want).max(), 1)

    vol = corr.corr_volume(t1, t2, normalize=normalize, out_dtype=tdt)
    jvol = jcorr.corr_volume(j1, j2, normalize=normalize, out_dtype=jdt)
    close(vol, jvol)
    for got, want in zip(corr.corr_pyramid(vol, 4), jcorr.corr_pyramid(jvol, 4)):
        close(got, want)
    for got, want in zip(corr.corr_pyramid_fused(t1, t2, 4, out_dtype=tdt, normalize=normalize),
                         jcorr.corr_pyramid_fused(j1, j2, 4, normalize=normalize,
                                                  out_dtype=jdt)):
        close(got, want)
    if normalize:
        assert float(vol.float().abs().max()) <= 1.0 + tol


@pytest.mark.parametrize("tree", ["interpolate", "shared"])
def test_new_modules_round_trip_strictly(tree, images, tmp_path):
    """The interpolate backbone's tree (no fnet) and the shared backbone's
    (its conv2 head: ``conv2_res``/``conv2_out`` to ``conv2.0``/``conv2.1``),
    3 GRU levels, load strictly, key for key and value for value what the
    JAX package's exporter writes, and through a reference-format
    ``.pth``."""
    option = "interpolate_reg_cuda" if tree == "interpolate" else "shared_backbone"
    cfg = {**BASE, **OPTIONS[option], "n_gru_layers": 3}
    jmodel = JRAFTStereo(_jcfg({**OPTIONS[option], "n_gru_layers": 3}), iters=ITERS,
                         test_mode=True)
    variables = draw_variables(jmodel, np.random.default_rng(4), *images)
    model = RAFTStereo(RAFTStereoConfig.from_dict(cfg), iters=ITERS)
    ours = state_dict_from_flax(variables)
    theirs = export_reference_pth(variables, model.state_dict())
    assert set(ours) == set(theirs) == set(model.state_dict())
    assert not any(k.startswith("fnet.") for k in ours)
    assert any(k.startswith("conv2.1.") for k in ours) == (tree == "shared")
    for k, t in ours.items():
        assert torch.equal(t, theirs[k]), k
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in ours.items()}}, path)
    loaded = load_reference_pth(model, path).state_dict()
    assert all(torch.equal(loaded[k], ours[k]) for k in ours)
