"""Evaluation CLI (``dkt_stereo_tpu/cli/eval.py``; the reference's
tools/evaluate_stereo.py __main__, :339-404), on the GPU:

  python -m dkt_stereo_tpu_torch.cli.eval --config configs/raft_stereo/base.json \\
      --restore_ckpt ckpt.pth --datasets eth3d kitti-2015 ...

``--restore_ckpt`` takes a reference-format ``.pth`` (what
``torch.save(model.state_dict())`` writes, or the JAX package's
``export_reference_pth``) or a port checkpoint of ``cli.train`` (a
``step_N`` directory; ``--which`` picks its student, EMA or teacher
weights), loaded strictly. A JAX package (Orbax) checkpoint raises: ``python
-m dkt_stereo_tpu.cli.export`` turns it into a ``.pth``. ``main(argv, device="cpu")``
runs on the CPU; without ``device`` it wants a CUDA device and raises when
there is none.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--restore_ckpt", required=True)
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--divide_factor", type=int, default=32)
    p.add_argument(
        "--datasets",
        nargs="+",
        default=["eth3d", "middlebury-H", "kitti-2012", "kitti-2015", "booster-Q"],
    )
    p.add_argument("--data_root", default="data")
    p.add_argument(
        "--spatial_bands",
        type=int,
        default=0,
        help="split each frame into N horizontal bands over N devices with exact "
        "cross-band instance-norm statistics; not ported yet (ROADMAP.md Queue 1 item 11)",
    )
    p.add_argument("--band_halo", type=int, default=96)
    p.add_argument(
        "--which",
        choices=["student", "ema", "teacher"],
        default="student",
        help="which weights of a port checkpoint (ignored for .pth checkpoints)",
    )
    p.add_argument(
        "--mixed_precision",
        action="store_true",
        help="bf16 compute; default OFF to match the reference eval protocol "
        "(tools/evaluate_stereo.py:376-380 hard-disables AMP for accuracy runs)",
    )
    return p.parse_args(argv)


def main(argv=None, device=None):
    """Run the validators the arguments name and return their results
    (also printed as JSON). ``device`` is for callers in Python (the tests
    pass ``"cpu"``); it adds no command-line flag."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    from dkt_stereo_tpu_torch.cli.config import load_model_config, merge_config
    from dkt_stereo_tpu_torch.device import resolve_device
    from dkt_stereo_tpu_torch.eval.validate import make_forward_fn, preflight, run_validator
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.train.checkpoint import restore_variables

    dev = resolve_device(device)
    if args.spatial_bands > 1:
        raise NotImplementedError(
            "--spatial_bands > 1 (banded multi-device eval) is not ported yet: ROADMAP.md "
            "Queue 1 item 11")
    weights = restore_variables(args.restore_ckpt, args.which)
    if not os.path.isdir(args.data_root):
        raise SystemExit(f"--data_root {args.data_root!r} does not exist (checked before the "
                         "model is built)")
    preflight(args.datasets, args.data_root)

    config = load_model_config(args.config)
    # strict-disjoint check (ft_dkt.py:347-350); the eval CLI deliberately
    # overrides a config's mixed_precision: the reference's eval harness
    # disables AMP whatever the config says (tools/evaluate_stereo.py:376-380)
    merge_config(args, config, allow=("mixed_precision",))
    config = {**config, "mixed_precision": args.mixed_precision}
    model = create_model(config, iters=args.valid_iters, device=dev, test_mode=True)
    model.load_state_dict(weights, strict=True)
    fwd = make_forward_fn(model, dev)
    results = {}
    for name in args.datasets:
        results.update(run_validator(name, fwd, args.data_root, args.divide_factor))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
