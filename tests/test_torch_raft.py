"""The port's slice as a whole: RAFT-Stereo inference with the pallas.json
field values, through ``make_forward_fn`` / ``_run_one`` on the CPU (plain
kernel versions), against the JAX model with identical weights; plus the
weight bridge, the package's isolation from JAX, the device policy and the
registry.
"""

import ast
from collections import OrderedDict
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import RAFTStereoConfig as JConfig
from dkt_stereo_tpu.ops.pad import pad_input as jpad_input
from dkt_stereo_tpu.ops.pad import unpad_input as jnp_unpad
from dkt_stereo_tpu.train.checkpoint import export_reference_pth
from dkt_stereo_tpu_torch.cli.config import load_model_config
from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
from dkt_stereo_tpu_torch.models.raft_stereo import RAFTStereo, RAFTStereoConfig
from dkt_stereo_tpu_torch.models.registry import create_model, get_model
from dkt_stereo_tpu_torch.weights import load_reference_pth, state_dict_from_flax

ROOT = Path(__file__).resolve().parents[1]
PALLAS = load_model_config(str(ROOT / "configs/raft_stereo/pallas.json"))
FP32 = {"mixed_precision": False, "corr_dtype": "float32"}
ITERS = 3


@pytest.fixture(scope="module")
def jax_run():
    """JAX reference: reg lookup, XLA encoder, fp32, at 1x30x60 padded to
    32x64 (the eval protocol's divide_factor 32), 3 iterations."""
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (30, 60, 3)).astype(np.float32) for _ in range(2))
    cfg = JConfig.from_dict({**PALLAS, **FP32, "corr_implementation": "reg",
                             "pallas_encoder": False})
    model = JRAFTStereo(cfg, iters=ITERS, test_mode=True)
    x1, spec = jpad_input(jnp.asarray(img1[None]), 32, "sintel")
    x2, _ = jpad_input(jnp.asarray(img2[None]), 32, "sintel")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x1, x2)
    _, disp = jax.jit(model.apply)(variables, x1, x2)
    disp = np.asarray(jnp_unpad(disp[..., None], spec))[0, ..., 0]
    variables = jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in variables.items()})
    return variables, (img1, img2), disp


@pytest.mark.parametrize("pallas_encoder, tol", [(True, 5e-3), (False, 2.5e-3)])
def test_slice_matches_jax(jax_run, pallas_encoder, tol):
    """pallas.json (reg_cuda lookup; fused fnet stage chain when
    ``pallas_encoder``) on the CPU's plain kernel versions vs the JAX model.
    Bound: 5e-3 px, the JAX package's own bound between its fused and
    unfused encoder paths (tests/test_pallas_encoder.py:123); the unfused
    port at half that. Measured ~1.2e-3 px on both, with |disp| up to ~190
    px from random weights: fp32 sums in another order, carried through the
    GRU iterations."""
    variables, (img1, img2), want = jax_run
    cfg = RAFTStereoConfig.from_dict({**PALLAS, **FP32, "pallas_encoder": pallas_encoder})
    model = RAFTStereo(cfg, iters=ITERS)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    disp, seconds = _run_one(make_forward_fn(model, device="cpu"), img1, img2)
    assert disp.shape == want.shape == (30, 60) and seconds > 0
    assert float(np.abs(disp - want).max()) <= tol


def test_mixed_precision_path_runs_on_cpu():
    """pallas.json as shipped (bf16 autocast, bf16 pyramid): finite output
    of the right shapes and dtypes, random weights from a seed."""
    model = create_model(PALLAS, iters=2, device="cpu", seed=0)
    x = torch.tensor(np.random.default_rng(1).uniform(0, 255, (2, 1, 32, 64, 3)), dtype=torch.float32)
    with torch.inference_mode():
        coarse, disp = model(x[0], x[1])
    assert coarse.shape == (1, 8, 16, 1) and disp.shape == (1, 32, 64)
    assert coarse.dtype == disp.dtype == torch.float32
    assert torch.isfinite(disp).all()
    # the same seed gives the same weights
    again = create_model(PALLAS, iters=2, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_state_dict_from_flax_matches_export_reference_pth(jax_run):
    """Key for key and value for value, the JAX package's own exporter given
    the port's state dict as its template."""
    variables = jax_run[0]
    port = RAFTStereo(RAFTStereoConfig.from_dict({**PALLAS, **FP32}), iters=ITERS)
    ours = state_dict_from_flax(variables)
    theirs = export_reference_pth(variables, port.state_dict())
    assert set(ours) == set(theirs) == set(port.state_dict())
    for k, t in ours.items():
        assert t.dtype == theirs[k].dtype and torch.equal(t, theirs[k]), k


def test_load_reference_pth_roundtrip(jax_run, tmp_path):
    """A reference-format checkpoint (DataParallel prefixes, nested under
    ``state_dict``) loads strictly and reproduces every tensor."""
    sd = state_dict_from_flax(jax_run[0])
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}, "epoch": 3}, path)
    model = load_reference_pth(RAFTStereo(RAFTStereoConfig.from_dict(PALLAS), iters=1), path)
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k
    sd.pop("fnet.conv2.bias")
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="fnet.conv2.bias"):
        load_reference_pth(RAFTStereo(RAFTStereoConfig.from_dict(PALLAS), iters=1), path)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax, flax or the
    JAX package (``dkt_stereo_tpu_torch`` shares the JAX package's prefix,
    so names are compared by their first dotted component)."""
    files = sorted((ROOT / "dkt_stereo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 64
    banned = {"jax", "jaxlib", "flax", "optax", "dkt_stereo_tpu"}
    found = [(f.name, m) for f in files for m in _imports(f) if m.split(".")[0] in banned]
    assert not found, found


def test_entry_points_default_to_the_gpu():
    """Without a device argument the entry points want CUDA and raise when
    there is none; they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    model = RAFTStereo(RAFTStereoConfig.from_dict(PALLAS), iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_forward_fn(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model(PALLAS)


def test_registry_and_unported_options():
    assert get_model("RAFTStereo")[0] is RAFTStereo
    # GWCNet and CGI-Stereo, once queued, are the port's own now
    from dkt_stereo_tpu_torch.models.cgi_stereo import CGIStereo
    from dkt_stereo_tpu_torch.models.gwcnet import GWCNet
    assert get_model("GWCNet")[0] is GWCNet and get_model("CGI_Stereo")[0] is CGIStereo
    with pytest.raises(KeyError, match="unknown model"):
        get_model("NoSuchNet")
    # the options no shipped config sets build their modules (their parity
    # with JAX: tests/test_torch_raft_options.py); an unknown value raises
    for override, fnet_norm in (({"corr_implementation": "cosine"}, "instance"),
                                ({"fast_in_stats": True}, "instance_fast"),
                                ({"backbone_type": "interpolate"}, None),
                                ({"shared_backbone": True}, None)):
        model = RAFTStereo(RAFTStereoConfig.from_dict({**PALLAS, **override}))
        assert (model.fnet.norm_fn if hasattr(model, "fnet") else None) == fnet_norm
        assert hasattr(model, "conv2") == ("shared_backbone" in override)
    for override in ({"corr_implementation": "no_such_mode"}, {"backbone_type": "no_such"}):
        with pytest.raises(ValueError, match="must be one of"):
            RAFTStereo(RAFTStereoConfig.from_dict({**PALLAS, **override}))
    # alt_pallas.json (alt_cuda, K2 encoder) builds in test mode and, with
    # K2's VJP, in train mode
    alt = load_model_config(str(ROOT / "configs/raft_stereo/alt_pallas.json"))
    model = create_model(alt, iters=1, device="cpu", seed=0)
    assert model.test_mode and model.cfg.corr_implementation == "alt_cuda"
    model = RAFTStereo(RAFTStereoConfig.from_dict(alt), test_mode=False)
    assert not model.test_mode and model.cfg.pallas_encoder and model.fnet.fused_fullres
    # the shipped training config builds in train mode (remat_iters on)
    train = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
    model = create_model(train, iters=2, device="cpu", seed=0, test_mode=False)
    assert model.training and not model.test_mode and model.cfg.remat_iters
    # mix_fmap_image builds in train mode, its blend weight an argument
    model = RAFTStereo(RAFTStereoConfig.from_dict({**train, "corr_implementation": "mix_fmap_image"}),
                       test_mode=False)
    assert model.cfg.corr_implementation == "mix_fmap_image" and hasattr(model, "fnet")
    model = create_model(PALLAS, iters=2, device="cpu", seed=0, test_mode=False)
    assert model.training and not model.test_mode and model.cfg.pallas_encoder
    from dkt_stereo_tpu_torch.train.state import DKTHyperParams

    assert DKTHyperParams(batched_teachers=True).batched_teachers



def _fake_capture(calls, counters=()):
    """``capture_cuda``'s contract on the CPU: buffers like the inputs, the
    body run once on them, and a replay that runs it again into the same
    output buffers without raising the launch counters."""

    def capture(body, inputs):
        calls.append(len(inputs))
        bufs = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype).zero_() for t in inputs]
        outs = [o.clone() for o in body(*bufs)]

        def replay():
            before = [c.launches for c in counters]
            for o, new in zip(outs, body(*bufs)):
                o.copy_(new)
            for c, n in zip(counters, before):
                c.launches = n

        return replay, bufs, outs

    capture.device_type = "cpu"
    return capture


def test_graph_engagement_rule(monkeypatch):
    """The refinement's CUDA graph engages only for a test-mode forward on
    the card without gradients, ``flow_init``, a ``torch.func`` transform,
    banded evaluation or an autocast region around it: CPU tensors never
    reach the cache, and the other cases run eagerly."""
    from dkt_stereo_tpu_torch.nn import norms

    model = create_model(PALLAS, iters=1, device="cpu", seed=0)
    x = torch.zeros(1, 32, 64, 3)
    with torch.inference_mode():
        for _ in range(2):
            model(x, x)
    assert not model._graphs.entries  # the CUDA capture serves no CPU tensor

    calls = []
    model._graphs.capture = _fake_capture(calls)
    with torch.no_grad():
        assert model._graphable(x, None)
        assert not model._graphable(x, torch.zeros(1, 8, 16, 1))
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert not model._graphable(x, None)
        monkeypatch.setattr(norms, "_BAND", {"halo": 0, "n": 1})
        assert not model._graphable(x, None)
        monkeypatch.setattr(norms, "_BAND", None)
        seen = []
        torch.func.vmap(lambda t: seen.append(model._graphable(t, None)) or t)(torch.zeros(2, 3))
        assert seen == [False]
    assert not model._graphable(x, None)  # gradients on

    train = create_model(PALLAS, iters=1, device="cpu", seed=0, test_mode=False)
    train._graphs.capture = _fake_capture(calls)
    with torch.no_grad():
        for _ in range(2):
            train(x, x)
            model(x, x, flow_init=torch.zeros(1, 8, 16, 1))
    for _ in range(2):
        model(x, x)
    assert not calls and not model._graphs.entries and not train._graphs.entries


def test_graph_first_forward_eager_then_captured():
    """A key's first forward runs eagerly and its second captures; the
    replays give the eager forward's bits, in the span ``raft.replay``
    inside ``raft.iter``, and a returned disparity is the caller's own:
    the next replay leaves it as it was."""
    from torch.profiler import ProfilerActivity, profile

    from dkt_stereo_tpu_torch.models import raft_stereo
    from dkt_stereo_tpu_torch.train.profiling import take_spans

    model = create_model(PALLAS, iters=2, device="cpu", seed=0)
    calls = []
    model._graphs.capture = _fake_capture(calls, raft_stereo._COUNTERS)
    rng = np.random.default_rng(3)
    x1, x2, y1, y2 = (torch.tensor(rng.uniform(0, 255, (1, 32, 64, 3)), dtype=torch.float32)
                      for _ in range(4))
    with torch.inference_mode():
        want = model(x1, x2)
        assert not calls
        got = model(x1, x2)
        assert calls == [7]  # fmap, the GRUs' three states and three context inputs
        other = model(y1, y2)
        take_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            again = model(x1, x2)
        spans = take_spans()
    assert calls == [7] and len(model._graphs.entries) == 1  # one key: the shapes
    replay, outer = spans[-2:]  # the fake replay's eager spans end first
    assert (replay.name, outer.name) == ("raft.replay", "raft.iter")
    assert replay.parent == outer.id and outer.parent is None
    for w, g, a, o in zip(want, got, again, other):
        assert torch.equal(w, g) and torch.equal(w, a) and not torch.equal(w, o)


class _Launches:
    launches = 0


def test_graph_cache_keys_weights_and_counters():
    """GraphCache: least recently used keys out at MAX_KEYS, a change of
    the weights' addresses drops every graph, the capture raises no counter
    and each replay adds what the capture counted; a copy starts empty."""
    import copy

    from dkt_stereo_tpu_torch.models.graphs import MAX_KEYS, GraphCache

    counter = _Launches()
    cache = GraphCache()

    def body(x):
        counter.launches += 3
        return (x * 2,)

    calls = []
    cache.capture = _fake_capture(calls, [counter])
    x = torch.ones(2)
    get = lambda key, w=(1,): cache.get(key, w, body, (x,), (counter,))  # noqa: E731
    assert get("a") is None and not calls
    graph = get("a")
    assert calls == [1] and counter.launches == 0
    (out,) = graph((torch.full((2,), 5.0),))
    assert torch.equal(out, torch.full((2,), 10.0)) and counter.launches == 3
    graph((x,))
    assert counter.launches == 6
    for key in "bcde"[:MAX_KEYS]:
        assert get(key) is None
    assert "a" not in cache.entries and len(cache.entries) == MAX_KEYS
    assert get("a") is None and "b" not in cache.entries
    assert get("c") is not None and calls == [1, 1]
    assert get("c", w=(2,)) is None and list(cache.entries) == ["c"]
    assert copy.deepcopy(cache).entries == OrderedDict()
