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

``--spatial_bands N`` (N > 1) evaluates every frame in N horizontal bands,
one a rank of N processes that the CLI starts itself, rank k on ``cuda:k``
over NCCL (fewer than N CUDA devices raise), or all on the CPU over gloo
with ``device="cpu"``: ``eval/tiled.py::banded_forward_exact`` with
``--band_halo`` rows of halo, the fused encoder turned off (its kernel
computes its instance norm inside, where the cross-band statistics cannot
reach). Every rank runs the validators on the same frames; rank 0's
results are returned.
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
        help="split each frame into N horizontal bands, one a process and device, with exact "
        "cross-band instance-norm statistics and halo exchange (eval/tiled.py::"
        "banded_forward_exact); needs N CUDA devices",
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
    from dkt_stereo_tpu_torch.eval.validate import make_forward_fn, preflight
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.train.checkpoint import restore_variables

    dev = resolve_device(device)
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
    if args.spatial_bands > 1:
        from dkt_stereo_tpu_torch.parallel.mesh import default_backend, make_mesh, run_ranks

        devices = make_mesh(args.spatial_bands, dev)
        results = run_ranks(_band_rank, args.spatial_bands, args, config, weights, devices,
                            backend=default_backend(dev))[0]
    else:
        model = create_model(config, iters=args.valid_iters, device=dev, test_mode=True)
        model.load_state_dict(weights, strict=True)
        results = _validate(args, make_forward_fn(model, dev))
    print(json.dumps(results, indent=2))
    return results


def _validate(args, fwd) -> dict:
    from dkt_stereo_tpu_torch.eval.validate import run_validator

    results = {}
    for name in args.datasets:
        results.update(run_validator(name, fwd, args.data_root, args.divide_factor))
    return results


def _band_rank(rank, args, config, weights, devices):
    """One rank of ``--spatial_bands``: the validators over a forward that
    runs this rank's band of every frame."""
    import torch

    from dkt_stereo_tpu_torch.eval.tiled import banded_forward_exact
    from dkt_stereo_tpu_torch.models.registry import create_model

    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # module-level instance norms, which the cross-band statistics reach
    config = {**config, "pallas_encoder": False}
    model = create_model(config, iters=args.valid_iters, device=dev, test_mode=True)
    model.load_state_dict(weights, strict=True)
    model.eval()

    def fwd(img1, img2):
        return torch.stack([
            torch.from_numpy(banded_forward_exact(model, a, b, halo=args.band_halo,
                                                  divide_factor=args.divide_factor))
            for a, b in zip(img1, img2)]).to(dev)

    fwd.device = dev
    return _validate(args, fwd)


if __name__ == "__main__":
    main()
