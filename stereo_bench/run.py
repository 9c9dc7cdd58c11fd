"""Run one cell of the port's benchmark and print its result line.

  python -m stereo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``dkt_stereo_tpu_torch``)
and ``BENCHMARK.json``. The cell's inputs and weights come from ``--seed``;
set-up (imports, the kernels' build on a checkout's first run, the model,
the warm-up) is timed as ``setup_s``; then the cell's driver measures for
``--seconds``. With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones and the trace's breakdown.
Each number of the correctness check is printed beside its limit, last on
standard error and last in the line. A run with no CUDA card, or fewer
cards than the cell asks for, exits 1 and prints no result, as does a run
after which a JAX module is loaded.

Every cache the program and PyTorch keep (the kernels' nvcc builds under
``build/kernels``, Triton's, torch extensions', the CUDA JIT's) lives at a
fixed path under ``build/`` in the checkout.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (Linux: its
    start tick against the uptime; elsewhere, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
_BUILD = Path(__file__).resolve().parents[1] / "build"
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(_BUILD / _dir)

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_device(torch, count: int) -> dict:
    """The result's ``device``, with the card's power limit in watts
    (``nvidia-smi``; None where it cannot be read)."""
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader,nounits", "-i", "0"],
                               capture_output=True, text=True, timeout=60)
        watts = float(limit.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        watts = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "power_limit_w": watts}


def main(argv=None) -> int:
    args = parse(argv)
    from stereo_bench import bounds, harness

    spec = harness.load_benchmark()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    ctx = harness.Context(args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t0=T0)
    rec = ctx.driver.run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"JAX modules loaded in the run: {loaded}", file=sys.stderr)
        return 1
    device = card_device(torch, cell["chips"])
    device["memory_peak_bytes"] = int(rec["peak_bytes"])
    if args.trace:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["span_s"]
    out = harness.assemble(rec, spec, args.workload, bool(args.trace), harness.ROOT, device)
    if args.trace:
        print(f"card power limit {device['power_limit_w']} W; device ms a unit by class: "
              + bounds.bucket_line(rec["trace"]), file=sys.stderr)
    ms = [1e3 * t for t in rec["latencies_s"]]
    print(f"{len(ms)} units in {rec['window_s']:.3f} s; ms a unit: first "
          f"{', '.join(f'{t:.1f}' for t in ms[:5])}; quartiles "
          f"{', '.join(f'{t:.1f}' for t in statistics.quantiles(ms, n=4))}; max {max(ms):.1f}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
