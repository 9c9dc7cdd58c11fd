"""The benchmark's data: cells, configurations, drivers and metric readers,
each found by its name in ``BENCHMARK.json``, and the result line.

Layout under ``stereo_bench/`` (a later cell, configuration, traffic kind
or metric is a new file and a new entry, never an edit):

  configs/<config>.json    the port's model config as it runs, precision,
                           iterations, the model reference by name, source,
                           assumed, reduced
  reference/<model>.py     the model's plain reference (below)
  workloads/<cell>.json    config, driver, traffic parameters, limits of
                           the correctness check, why, a tiny ``dry``
                           override for the CPU rehearsal
  drivers/<kind>.py        ``run(ctx) -> record`` and ``unit_flops``
  metrics/<metric>.py      ``read(record) -> number or None``

A model reference is plain PyTorch that imports nothing of the program and
gives: ``build(model_config) -> module`` (a module with the program's
parameter names and ``set_precision("fp32" | the control's precision)``);
``disparity(model, image1, image2, iters) -> (B, H, W)`` in test mode; for
training cells ``train_forward(model, image1, image2, iters, remat)`` and
``train_loss(preds, gt, valid) -> (loss, ok)``; and, where the program's
kernels have bytes that depend on the inputs, ``record(models, on)`` and
``launch_bytes(models, itemsize) -> {counter: bytes a batch row}``. It may
give its own ``seeded_state_dict`` in place of :mod:`stereo_bench.weights`'.
The drivers, the FLOP count and the weights take the model from it alone,
so a second model is a reference file and a configuration file.

A record is a dict that a driver fills (``setup_s``, ``window_s``,
``units``, spans, CUDA-event parts, the peak, the trace summary,
``checks``); every metric, end to end or per layer, is a reader of it.
"""

from __future__ import annotations

import importlib.util
import math
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# modules that no run may load, compared by top-level name, whole: the JAX
# package's name is a prefix of the port's
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dkt_stereo_tpu"})


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(Path(root) / kind / f"{name}.json") as f:
        return json.load(f)


def load_code(root: Path, kind: str, name: str):
    """``<root>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = Path(root) / kind / f"{name}.py"
    mod_name = f"stereo_bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(repo: Path = REPO) -> dict:
    with open(Path(repo) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; a metric with a
    ``workloads`` list only in those cells."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def stream_seed(seed: int, k: int) -> int:
    """The seed of a run's k-th random stream (weights, inputs, draws)."""
    return seed * 16 + k


def padded(frame, divis_by: int):
    """(H, W) rounded up to multiples of ``divis_by``."""
    return tuple(-(-s // divis_by) * divis_by for s in frame)


def reference_weights(ref, model_config: dict, seed: int, device, scaled: dict) -> dict:
    """Weights from ``seed`` for model reference ``ref``'s parameter names,
    by its own ``seeded_state_dict`` or :mod:`stereo_bench.weights`'."""
    import torch

    from stereo_bench import weights

    with torch.device("meta"):
        shapes = ref.build(model_config)
    draw = getattr(ref, "seeded_state_dict", weights.seeded_state_dict)
    return draw(shapes, seed, device, scaled)


def forbidden_loaded() -> list[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Context:
    """What a driver is given: the cell and its configuration by name, the
    run's seed, length and trace switch, the device, and in a rehearsal
    (``dry``) the cell's tiny override merged in. ``control`` puts the
    reference at the precision below the configuration's in the program's
    place (the control of the correctness check)."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device,
                 root: Path = ROOT, dry: bool = False, control: bool = False, t0: float = 0.0):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.root, self.dry, self.control = device, Path(root), dry, control
        cell = load_json(root, "workloads", workload)
        config = load_json(root, "configs", cell["config"])
        if dry:
            cell = {**cell, **cell.get("dry", {})}
            config = {**config, **config.get("dry", {})}
        self.cell, self.config = cell, config
        self.driver = load_code(root, "drivers", cell["driver"])
        self.reference = load_code(root, "reference", config["reference"])
        self.t0 = t0  # the process's start, on time.perf_counter's clock


def _number(v: float) -> float:
    """``v``, or 1e300 where it is not finite (JSON has no NaN)."""
    return float(v) if math.isfinite(v) else 1e300


def assemble(rec: dict, spec: dict, workload: str, trace: bool, root: Path, device: dict):
    """The result line's dict: ``correct``, ``attempted``, ``failed``, the
    metrics that read something, ``device``, with the trace ``breakdown``,
    and last ``checks``: each number compared beside its limit."""
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        value = load_code(root, "metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    checks = {k: {"value": _number(v), "limit": lim} for k, (v, lim) in rec["checks"].items()}
    passed = all(math.isfinite(v) and v <= lim for v, lim in rec["checks"].values())
    out = {"correct": bool(checks) and passed and rec["failed"] == 0,
           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "device": device}
    if trace and rec.get("trace"):
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = checks
    return out


def dry(workload: str, seed: int = 0, trace: bool = True, root: Path = ROOT,
        repo: Path = REPO, control: bool = False):
    """A rehearsal of one cell on the CPU at the cell's tiny ``dry`` size:
    the same driver, window (two units), trace reduction, readers and
    correctness check, with no card. Returns ``(result, record)``; nothing
    is printed, and no number of it is a device measurement."""
    import time

    import torch

    spec = load_benchmark(repo)
    ctx = Context(workload, seed, 0.0, trace, torch.device("cpu"), root, dry=True,
                  control=control, t0=time.perf_counter())
    rec = ctx.driver.run(ctx)
    device = {"platform": "cpu", "kind": "rehearsal", "count": 1, "memory_peak_bytes": 0}
    return assemble(rec, spec, workload, trace, root, device), rec
