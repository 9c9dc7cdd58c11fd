"""The port's spans (``train/profiling.py::span``) on the CPU: off with no
profiler running, the frame's and the DKT step's trees under one, the
numbers unchanged by it, the set-up counters, and the benchmark's readers
of them in every cell's CPU rehearsal."""

import contextlib
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dkt_stereo_tpu_torch.eval.validate import make_forward_fn
from dkt_stereo_tpu_torch.models import registry
from dkt_stereo_tpu_torch.ops.cuda import _build
from dkt_stereo_tpu_torch.train import dkt_step, profiling
from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
from dkt_stereo_tpu_torch.train.state import DKTHyperParams

ROOT = Path(__file__).resolve().parents[1]
TRAIN = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
# a narrow fp32 RAFT: the spans do not depend on the widths
TINY = {**TRAIN, "mixed_precision": False, "corr_dtype": "float32", "corr_implementation": "reg",
        "hidden_dims": [16, 16, 16], "corr_levels": 2, "corr_radius": 2}
H, W = 32, 64


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_buffer():
    profiling.take_spans()
    yield
    profiling.take_spans()


def _pair(seed, B=1):
    g = torch.Generator().manual_seed(seed)
    return [255 * torch.rand((B, H, W, 3), generator=g) for _ in range(2)]


def _forward(iters=3):
    model = registry.create_model(TINY, iters=iters, device="cpu", seed=0)
    return make_forward_fn(model, "cpu")


def _batch(seed, B=1):
    g = torch.Generator().manual_seed(seed)
    img = [255 * torch.rand((B, H, W, 3), generator=g) for _ in range(4)]
    return {"img1": img[0], "img2": img[1], "img1_clean": img[2], "img2_clean": img[3],
            "flow": -4 * torch.rand((B, H, W), generator=g),
            "valid": (torch.rand((B, H, W), generator=g) < 0.9).float()}


def _dkt(remat=True, batched=False):
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2, num_steps=10,
                           batched_teachers=batched)
    config = {**TINY, "remat_iters": remat}
    state = dkt_step.create_dkt_state(config, hyper, seed=0, device="cpu")
    return state, dkt_step.make_dkt_train_step(config, hyper)


def _step(state, step_fn, seed=5):
    marks = []
    state, metrics = step_fn(state, _batch(seed), generator=torch.Generator().manual_seed(seed),
                             mark=marks.append)
    return metrics, marks


def test_off_span_is_the_shared_no_op(monkeypatch):
    """With no profiler running, ``span`` returns the one shared no-op,
    enters no ``record_function`` and records nothing through a frame and a
    DKT step."""
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(profiling, "record_function", no_range)
    assert profiling.span("eval.forward") is profiling.span("raft.iter", unit=3)
    assert profiling.span("raft.iter") is profiling._OFF
    _forward()(*_pair(1))
    state, step_fn = _dkt()
    metrics, marks = _step(state, step_fn)
    assert profiling.take_spans() == []
    assert marks == ["ema", "teachers", "fande", "student", "optimizer"]


def test_a_traced_frame_is_one_unit(tmp_path):
    """A 3-iteration frame through ``make_forward_fn`` under a CPU profile:
    one ``eval.forward`` root, its unit, whose children are the encoders,
    the pyramid, three iterations and the upsampling, in order; the
    exported Chrome trace holds the same names."""
    forward = _forward(iters=3)
    with _cpu_profile() as prof:
        forward(*_pair(1))
    spans = profiling.take_spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "eval.forward" and root.unit == f"eval.forward#{root.id}"
    children = sorted((s for s in spans if s is not root), key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["raft.encode", "raft.pyramid"] + 3 * ["raft.iter"] + [
        "raft.upsample"]
    for s in children:
        assert s.parent == root.id and s.unit == root.unit
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    path = tmp_path / "frame.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {s.name for s in spans} <= names


@pytest.mark.parametrize("remat", [False, True])
def test_a_traced_dkt_step_is_one_unit(remat):
    """A DKT step under a CPU profile: the root ``dkt.step``, its unit keyed
    by the step number, its parts in order; the teachers' and the student's
    RAFT stages inside their parts; under remat the backward's recomputed
    iterations are ``raft.iter`` spans inside ``dkt.student`` too. The
    ``mark`` hook is called in its order."""
    state, step_fn = _dkt(remat)
    state.step = 7
    with _cpu_profile():
        _, marks = _step(state, step_fn)
    spans = profiling.take_spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "dkt.step" and root.unit == "dkt.step#7"
    assert all(s.unit == root.unit for s in spans)
    parts = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert [s.name for s in parts] == ["dkt.ema", "dkt.teachers", "dkt.fande", "dkt.student",
                                       "dkt.reduce", "dkt.update", "dkt.divergence", "dkt.read"]
    by_id = {s.id: s for s in spans}
    inside = {p.name: [s.name for s in spans if s.parent == p.id] for p in parts}
    assert inside["dkt.teachers"].count("raft.upsample") == 2
    assert inside["dkt.teachers"].count("raft.iter") == 2 * 2
    assert inside["dkt.student"].count("raft.iter") == 2 * (2 if remat else 1)
    assert inside["dkt.student"].count("raft.encode") == 1
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert marks == ["ema", "teachers", "fande", "student", "optimizer"]


def test_a_traced_ns_step_is_one_unit():
    """An NS step (binocular rows only) under a CPU profile: the root
    ``ns.step`` keyed by the step number, a span at each of its marks and
    the metrics' read, in order."""
    config = {**TINY, "loss_func": "ns_loss", "remat_iters": False}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2, num_steps=10)
    state = dkt_step.create_dkt_state(config, hyper, seed=0, device="cpu")
    step_fn = make_ns_train_step(config, hyper, nb=1, nt=0)
    b = _batch(4)
    batch = {"im1_forward": b["img1"], "im2_forward": b["img2"],
             "bi": {"flow": b["flow"], "valid": b["valid"]}, "tri": {}}
    marks = []
    with _cpu_profile():
        step_fn(state, batch, mix_weight=0.5, mark=marks.append)
    spans = profiling.take_spans()
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "ns.step" and root.unit == "ns.step#0"
    parts = sorted((s for s in spans if s.parent == root.id), key=lambda s: s.start_ns)
    assert [s.name for s in parts] == ["ns.ema", "ns.forward", "ns.loss", "ns.backward",
                                       "ns.optimizer", "ns.read"]
    assert marks == ["ema", "forward", "loss", "backward", "optimizer"]


def test_numbers_are_bit_equal_with_the_profiler_on_and_off():
    """The same frame, and the same DKT step from the same state, with the
    profiler off and on: disparities, metrics and updated weights bit for
    bit."""
    forward = _forward()
    pair = _pair(2)
    off = forward(*pair)
    with _cpu_profile():
        on = forward(*pair)
    assert torch.equal(off, on)
    got = []
    for traced in (False, True):
        state, step_fn = _dkt()
        with _cpu_profile() if traced else contextlib.nullcontext():
            metrics, _ = _step(state, step_fn)
        got.append((metrics, {k: p.detach().clone() for k, p in state.student.named_parameters()},
                    {k: b.clone() for k, b in state.ema.state_dict().items()}))
    (m0, p0, e0), (m1, p1, e1) = got
    assert m0 == m1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(e0[k], e1[k]) for k in e0)


def test_a_batched_teacher_step_runs_under_the_profiler():
    """With ``batched_teachers`` the teachers run as one forward vmapped over
    their stacked weights: under the profiler its RAFT spans sit inside
    ``dkt.teachers`` (one forward's), and the step's metrics are those it
    gives untraced."""
    state, step_fn = _dkt(batched=True)
    off, _ = _step(state, step_fn)
    state, step_fn = _dkt(batched=True)
    with _cpu_profile():
        on, _ = _step(state, step_fn)
    assert on == off
    spans = profiling.take_spans()
    (teachers,) = [s for s in spans if s.name == "dkt.teachers"]
    inside = [s.name for s in spans if s.parent == teachers.id]
    assert inside == ["raft.encode", "raft.pyramid", "raft.iter", "raft.iter", "raft.upsample"]


def test_create_model_counts_its_seconds(monkeypatch):
    """``create_model.seconds`` adds each call's host seconds: a fake clock
    that moves by one second a reading gives exactly one a call, three for
    ``create_dkt_state`` (student, EMA, teacher)."""
    clock = iter(range(1000))
    monkeypatch.setattr(registry.time, "perf_counter", lambda: float(next(clock)))
    before = registry.create_model.seconds
    dkt_step.create_dkt_state(TINY, DKTHyperParams(train_iters=1, teacher_iters=1), seed=0,
                              device="cpu")
    assert registry.create_model.seconds - before == 3.0


def test_kernel_load_counts_its_first_loads(monkeypatch, tmp_path):
    """``_build.load.seconds`` adds the host seconds of a kernel's first load
    (its build and ``dlopen``) and nothing for a load that the cache
    serves."""
    clock = iter(range(0, 1000, 2))
    monkeypatch.setattr(_build.time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(_build, "build", lambda names: [tmp_path / f"lib{n}.so" for n in names])
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_loaded", {})
    before = _build.load.seconds
    lib = _build.load("corr_lookup")
    assert _build.load("corr_lookup") is lib
    assert _build.load.seconds - before == 2.0


SPAN_METRICS = {
    "serve": ["encode_host_ms.serve", "iters_host_ms.serve"],
    "train": ["teachers_host_ms.train", "student_host_ms.train", "sync_wait_ms.train",
              "update_host_ms.train"],
}


@pytest.mark.parametrize("cell", ["raft_720p_stream", "raft_720p_batch4", "raft_dkt_b8",
                                  "raft_dkt_booster_b2"])
def test_each_cell_reports_the_span_metrics(cell):
    """The CPU rehearsal of each cell with its trace on reports every new
    per-layer metric, and the parts add up: a frame's encoders and
    iterations take at most its ``eval.forward``; a DKT step's four host
    parts at most its ``dkt.step``."""
    from stereo_bench import harness, spans

    out, rec = harness.dry(cell, seed=2**31 + 11, trace=True)
    kind = "serve" if "720p" in cell else "train"
    want = SPAN_METRICS[kind] + ["kernel_load_s.setup", "model_init_s.setup"]
    assert set(want) <= set(out["metrics"]), sorted(out["metrics"])
    got = {m: out["metrics"][m]["value"] for m in want}
    assert all(v >= 0 for v in got.values()) and got["model_init_s.setup"] > 0
    if kind == "serve":
        whole = spans.ms(rec, "eval.forward", {"eval.forward"})
        assert 0 < got["encode_host_ms.serve"] + got["iters_host_ms.serve"] <= whole
    else:
        whole = spans.ms(rec, "dkt.step", {"dkt.step"})
        assert 0 < sum(got[m] for m in SPAN_METRICS["train"]) <= whole
    assert out["correct"]
