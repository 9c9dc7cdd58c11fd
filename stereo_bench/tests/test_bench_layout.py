"""Every data file and reader loads by name; BENCHMARK.json meets the
contract's shape; a cell added as files alone runs through the CPU
rehearsal."""

import json
import re
import shutil

import pytest

from stereo_bench import flops, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _names(kind, suffix):
    return sorted(p.name[:-len(suffix)] for p in (harness.ROOT / kind).glob(f"*{suffix}"))


@pytest.fixture(scope="module")
def spec():
    return harness.load_benchmark()


def test_every_file_loads_by_name(spec):
    for name in _names("configs", ".json"):
        cfg = harness.load_json(harness.ROOT, "configs", name)
        assert {"source", "model", "precision", "control", "reduced", "reference"} <= set(cfg)
        ref = harness.load_code(harness.ROOT, "reference", cfg["reference"])
        assert callable(ref.build) and callable(ref.disparity)
    for name in _names("workloads", ".json"):
        cell = harness.load_json(harness.ROOT, "workloads", name)
        assert (harness.ROOT / "configs" / f"{cell['config']}.json").exists()
        assert {"why", "limits", "flops_per_unit", "dry"} <= set(cell)
    for name in _names("drivers", ".py"):
        if name != "__init__":
            mod = harness.load_code(harness.ROOT, "drivers", name)
            assert callable(mod.run) and callable(mod.unit_flops)
    for name in _names("metrics", ".py"):
        assert callable(harness.load_code(harness.ROOT, "metrics", name).read)


def test_benchmark_names_its_files(spec):
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert {m["name"] for m in metrics} == set(_names("metrics", ".py"))
    assert {c["name"] for c in spec["configs"]} == set(_names("configs", ".json"))
    assert {w["name"] for w in spec["workloads"]} == set(_names("workloads", ".json"))
    for c in spec["configs"]:
        assert c["file"] == f"stereo_bench/configs/{c['name']}.json"
    for w in spec["workloads"]:
        cell = harness.load_json(harness.ROOT, "workloads", w["name"])
        assert w["config"] == cell["config"] and w["chips"] == 1
        assert w["why"] == cell["why"] and len(w["why"]) <= 200


def test_benchmark_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["stereo_bench"] and 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads",
                                                                                 cells))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        reported = harness.cell_metrics(spec, w, False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(spec, w, True)


def test_configs_run_the_shipped_port_configs():
    for name in _names("configs", ".json"):
        cfg = harness.load_json(harness.ROOT, "configs", name)
        with open(harness.REPO / cfg["port_config"]) as f:
            assert cfg["model"] == json.load(f)


def test_a_cell_added_as_files_alone_runs(tmp_path):
    root = tmp_path / "stereo_bench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_benchmark()
    cell = harness.load_json(root, "workloads", "raft_720p_stream")
    cell["frame"] = [700, 1000]
    cell["dry"]["frame"] = [50, 90]
    (root / "workloads" / "raft_new_stream.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": "raft_new_stream", "config": cell["config"],
                              "traffic": "new_stream", "chips": 1, "why": cell["why"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "raft_720p_stream" in m.get("workloads", []):
            m["workloads"].append("raft_new_stream")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out, rec = harness.dry("raft_new_stream", seed=7, root=root, repo=tmp_path)
    assert rec["image"] == (1, 64, 96) and rec["units"] >= 2
    assert out["correct"] and set(out["checks"]) == {"disp_max_gap_px"}
    assert "forward_host_ms.serve" in out["metrics"] and "breakdown" in out


STUB = """
import torch
from torch import nn
import torch.nn.functional as F


class Stub(nn.Module):
    def __init__(self, config):
        super().__init__()
        c = config["channels"]
        self.feat = nn.Conv2d(3, c, 3, padding=1)
        self.volume = nn.Conv3d(1, 1, 3, padding=1)
        self.bn = nn.BatchNorm3d(1)

    def set_precision(self, precision):
        return self


def build(config):
    return Stub(config)


def disparity(model, image1, image2, iters):
    f1 = model.feat(image1.permute(0, 3, 1, 2))
    f2 = model.feat(image2.permute(0, 3, 1, 2))
    cost = (f1 * f2).mean(1, keepdim=True)[:, None]
    for _ in range(iters):
        cost = model.bn(model.volume(cost))
    return cost[:, 0, 0]
"""


def _copy(tmp_path):
    root = tmp_path / "stereo_bench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def _add_cell(root, tmp_path, name, config, base="raft_720p_stream", **changes):
    """A workload file ``name`` like ``base`` on ``config``, and its entries."""
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text()) if (
        tmp_path / "BENCHMARK.json").exists() else harness.load_benchmark()
    cell = {**harness.load_json(root, "workloads", base), "config": config, **changes}
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": name, "config": config, "traffic": name, "chips": 1,
                              "why": cell["why"]})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))


def test_a_model_added_as_files_alone(tmp_path):
    """A second model is a reference file and a configuration file: its
    weights (3-D convolutions and batch norms) and its FLOPs come from the
    reference that the configuration names, with no edit elsewhere."""
    root = _copy(tmp_path)
    (root / "reference" / "stub3d.py").write_text(STUB)
    cfg = {**harness.load_json(root, "configs", "raft_stereo_pallas"), "reference": "stub3d",
           "model": {"channels": 4}, "iters": 2, "init_scale": {}}
    (root / "configs" / "stub3d.json").write_text(json.dumps(cfg))
    _add_cell(root, tmp_path, "stub3d_stream", "stub3d", frame=[30, 60], divis_by=4)
    ref = harness.load_code(root, "reference", "stub3d")
    w = harness.reference_weights(ref, cfg["model"], 3, "cpu", {})
    assert set(w) == {"feat.weight", "feat.bias", "volume.weight", "volume.bias", "bn.weight",
                      "bn.bias", "bn.running_mean", "bn.running_var", "bn.num_batches_tracked"}
    assert w["bn.running_var"].item() != 1.0
    pixels = 32 * 60
    want = 2 * 2 * pixels * 4 * 3 * 9 + 2 * 2 * pixels * 27
    assert flops.workload_flops("stub3d_stream", root=root) == want


def test_the_configured_reference_is_the_one_compared(tmp_path):
    """A configuration that names another reference file is judged by it: a
    copy of RAFT's that answers 2 px off makes the rehearsal incorrect."""
    root = _copy(tmp_path)
    (root / "reference" / "raft_off.py").write_text(
        "from stereo_bench.reference.raft_stereo import *  # noqa: F401,F403\n"
        "from stereo_bench.reference import raft_stereo\n\n\n"
        "def disparity(model, image1, image2, iters):\n"
        "    return raft_stereo.disparity(model, image1, image2, iters) + 2.0\n")
    cfg = {**harness.load_json(root, "configs", "raft_stereo_pallas"), "reference": "raft_off"}
    (root / "configs" / "raft_off.json").write_text(json.dumps(cfg))
    _add_cell(root, tmp_path, "raft_off_stream", "raft_off")
    out, _ = harness.dry("raft_off_stream", seed=7, trace=False, root=root, repo=tmp_path)
    assert not out["correct"] and out["checks"]["disp_max_gap_px"]["value"] > 1.9
