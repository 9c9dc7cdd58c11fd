"""The port's profiler (``train/profiling.py``) on the CPU: ``cli.train
--profile_dir``'s window of steps counted from a resumed step, with the
program's spans inside each step; ``--profile_port`` refused by design."""

import json
from pathlib import Path

import numpy as np
import pytest

from dkt_stereo_tpu_torch.cli import train as train_cli
from dkt_stereo_tpu_torch.data import png
from dkt_stereo_tpu_torch.train.checkpoint import save_checkpoint
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from dkt_stereo_tpu_torch.utils import logging as port_logging

ROOT = Path(__file__).resolve().parents[1]
TRAIN_JSON = ROOT / "configs/raft_stereo/train.json"


def _host_ranges(trace_path) -> list:
    """The host ranges of a Chrome trace (not their copies on a device's
    timeline): ``(name, start, end)`` in microseconds."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and not str(e.get("cat", "")).startswith("gpu_")]


def _steps(trace_path) -> list:
    """The ``ProfilerStep#N`` ranges of a Chrome trace, in order."""
    return sorted(n for n, _, _ in _host_ranges(trace_path) if n.startswith("ProfilerStep#"))


def _inside(trace_path, step, name) -> int:
    """How many ranges ``name`` lie inside the range ``step``."""
    ranges = _host_ranges(trace_path)
    ((_, s0, e0),) = [r for r in ranges if r[0] == step]
    return sum(n == name and s0 <= s <= e <= e0 for n, s, e in ranges)


def _make_booster(root, rng, scenes=2, H=80, W=144):
    for s in range(scenes):
        d = root / "Booster_dataset" / "quarter" / "train" / "balanced" / f"scene{s}"
        for cam in ("camera_00", "camera_02"):
            (d / cam).mkdir(parents=True)
            png.write(d / cam / "0000.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        np.save(d / "disp_00.npy", rng.uniform(2, 30, (H, W)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A Booster tree and a port checkpoint at step 3 (a run to resume)."""
    tmp = tmp_path_factory.mktemp("profile")
    data = _make_booster(tmp / "data", np.random.default_rng(3))
    state = create_dkt_state(json.loads(TRAIN_JSON.read_text()),
                             DKTHyperParams(train_iters=2, teacher_iters=2), seed=0, device="cpu")
    state.step = 3
    ckpt = save_checkpoint(tmp / "ckpt", state)
    return tmp, data, ckpt


@pytest.mark.parametrize("start,steps,want", [(1, 2, ["ProfilerStep#4", "ProfilerStep#5"]),
                                              (2, 5, ["ProfilerStep#5"]),
                                              (3, 1, None)])
def test_train_cli_traces_a_window_from_the_resumed_step(resumed, monkeypatch, start, steps,
                                                         want):
    """``cli.train --profile_dir`` resumed at step 3 and run to step 5
    (steps 3, 4, 5): ``--profile_start`` counts from the resumed step, so
    the window [4, 6) holds exactly ``--profile_steps`` = 2 steps, named by
    their global steps, each holding the program's spans of the loader's
    wait, the copy to the device and the DKT step; a window that runs past
    the run's end is written at the end with the steps it holds; one that
    starts after the end writes nothing."""
    tmp, data, ckpt = resumed
    monkeypatch.setattr(port_logging, "make_writer", port_logging._JsonlWriter)
    logdir = tmp / f"trace_{start}_{steps}"
    out = train_cli.main([
        "--config", str(TRAIN_JSON), "--train_datasets", "booster", "--data_root", str(data),
        "--batch_size", "1", "--num_steps", "5", "--image_size", "64", "128",
        "--train_iters", "2", "--valid_iters", "2", "--num_workers", "0",
        "--validation_frequency", "1000", "--restore_ckpt", ckpt,
        "--save_dir", str(tmp / f"run_{start}_{steps}"), "--profile_dir", str(logdir),
        "--profile_start", str(start), "--profile_steps", str(steps)], device="cpu")
    assert out["checkpoint"].endswith("step_6") and len(out["step_seconds"]) == 3
    if want is None:
        assert out["trace"] is None and not logdir.exists()
        return
    assert Path(out["trace"]).parent == logdir and Path(out["trace"]).name.endswith(
        ".pt.trace.json")
    assert _steps(out["trace"]) == want
    for step in want:
        for name in ("train.loader_wait", "train.to_device", "dkt.step"):
            assert _inside(out["trace"], step, name) == 1, (step, name)


def test_profile_port_is_refused_by_design(resumed):
    """``--profile_port`` raises, naming why: PyTorch has no live profiler
    server for TensorBoard to attach to."""
    tmp, data, ckpt = resumed
    with pytest.raises(NotImplementedError, match="Not to port, by design"):
        train_cli.main(["--config", str(TRAIN_JSON), "--data_root", str(data),
                        "--profile_port", "9012"], device="cpu")
