"""Readings of a cell's correctness check on many seeds in one process, on
the card: the program's (the lower readings of each limit) and the
control's (the reference one precision below, in the program's place: the
upper readings). A short window at the cell's own load and sizes each;
one JSON line a run on standard output.

  python -m stereo_bench.calibrate --workload <cell> --seconds 3 \
      --seeds 11,12,... --control-seeds 21,22,23 [--fault half_batch --fault-seeds 31,32,33]

Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from stereo_bench import faults, harness


def explain(readings: dict, n: int = 4) -> dict:
    """Each step's losses on both sides and the ``n`` compared leaves with
    the widest gaps of the first gradient's and of the change's norms
    (:func:`stereo_bench.drivers.dkt_step.checks` reads the median leaf of
    both)."""
    got, want = readings["program"], readings["reference"]
    out = {"losses": [got["losses"], want["losses"]]}
    gmed = sorted(want["grad"].values())[len(want["grad"]) // 2]
    for key in ("grad", "change"):
        kept = {k: w for k, w in want[key].items() if want["grad"][k] >= 1e-3 * gmed}
        med = sorted(kept.values())[len(kept) // 2]
        gaps = sorted(((abs(got[key][k] - w) / max(w, med), k, got[key][k], w, want["grad"][k])
                       for k, w in kept.items()), reverse=True)[:n]
        out[key] = [[k, g, a, b, rg] for g, k, a, b, rg in gaps]
        out[key + "_median"] = med
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", choices=sorted(set(faults.FRAME_FAULTS + faults.STEP_FAULTS)),
                   help="plant this fault in the program for every --fault-seeds run")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--program-fp32", action="store_true",
                   help="run the program with mixed precision off (a witness run)")
    p.add_argument("--explain", action="store_true",
                   help="print each step's losses, the leaves with the widest gaps and "
                        "every leaf's readings")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    runs = [(int(s), False, None) for s in args.seeds.split(",") if s]
    runs += [(int(s), True, None) for s in args.control_seeds.split(",") if s]
    runs += [(int(s), False, args.fault) for s in args.fault_seeds.split(",") if s]
    for seed, control, fault in runs:
        t = time.perf_counter()
        ctx = harness.Context(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                              control=control, t0=t)
        if args.program_fp32:
            ctx.config = {**ctx.config, "model": {**ctx.config["model"], "mixed_precision": False}}
        with faults.planted(fault):
            rec = ctx.driver.run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "fault": fault, "reference_s": rec.get("reference_s"),
                          "units": rec["units"], "failed": rec["failed"],
                          "seconds": time.perf_counter() - t,
                          "checks": {k: v for k, (v, _) in rec["checks"].items()},
                          "reference": rec.get("reference_px", rec.get("reference_losses")),
                          "teacher_px": rec.get("reference_teacher_px"),
                          "loss_parts": rec.get("reference_loss_parts")}),
              flush=True)
        if args.explain and "readings" in rec:
            print(json.dumps({**explain(rec["readings"]), "leaves": rec["readings"]}),
                  flush=True)
        del rec, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
