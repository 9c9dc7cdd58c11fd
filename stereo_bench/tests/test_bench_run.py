"""The command's refusals, and what a run may load."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

from stereo_bench import harness


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env={**os.environ, **(env or {})})


def test_a_measured_run_without_a_card_fails():
    r = _run(["-m", "stereo_bench.run", "--workload", "raft_720p_stream", "--seed", "2147483649",
              "--seconds", "1", "--trace", "0"], harness.REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "stereo_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    code = "from stereo_bench import harness; print(harness.dry('raft_720p_stream'))"
    r = _run(["-c", code], tmp_path, {"PYTHONPATH": str(tmp_path)})
    assert r.returncode != 0 and r.stdout == ""
    assert "dkt_stereo_tpu_torch" in r.stderr


def test_a_run_loads_no_jax():
    code = textwrap.dedent("""
        import json, sys
        from stereo_bench import harness
        out, _ = harness.dry("raft_dkt_b8", seed=3, trace=False)
        print(json.dumps(harness.forbidden_loaded()))
    """)
    r = _run(["-c", code], harness.REPO, {"PYTHONPATH": str(harness.REPO)})
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dkt_stereo_tpu_torch_lookalike", object())
    assert "dkt_stereo_tpu_torch_lookalike" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "dkt_stereo_tpu.ops", object())
    assert harness.forbidden_loaded() == ["dkt_stereo_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.ROOT / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"dkt_stereo_tpu_torch", "dkt_stereo_tpu", "jax", "jaxlib", "flax"}
        assert tops <= {"__future__", "contextlib", "dataclasses", "math", "torch",
                        "stereo_bench"}, (path, tops)
    for path in harness.ROOT.rglob("*.py"):
        assert not set(_imports(path)) & {"dkt_stereo_tpu", "jax", "jaxlib", "flax"}, path
