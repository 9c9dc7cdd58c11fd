"""Demo (``dkt_stereo_tpu/cli/demo.py``; the reference's tools/demo.py:23-52):
stereo inference over image globs, on the GPU -> colormapped PNG (+ .npy,
+ .ply):

  python -m dkt_stereo_tpu_torch.cli.demo --config configs/raft_stereo/base.json \\
      --restore_ckpt ckpt.pth -l 'left/*.png' -r 'right/*.png' -o out/

``--restore_ckpt`` is a ``.pth`` or a port checkpoint (``--which``), as in
``cli/eval.py``. PNG inputs need no image library; JPEG inputs need PIL
(``data/readers.py``). ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from glob import glob
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--restore_ckpt", required=True)
    p.add_argument("-l", "--left_imgs", required=True)
    p.add_argument("-r", "--right_imgs", required=True)
    p.add_argument("-o", "--output_directory", default="demo_output")
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--divide_factor", type=int, default=32,
                   help="pad inputs to multiples of this (64 for n_downsample=3 configs)")
    p.add_argument("--which", choices=["student", "ema", "teacher"], default="student",
                   help="weight set of a port checkpoint (ignored for .pth)")
    p.add_argument("--save_numpy", action="store_true")
    p.add_argument("--save_ply", action="store_true",
                   help="also export a colored point cloud per frame "
                   "(utils/visualization.py:453-511)")
    p.add_argument("--focal", type=float, default=721.5,
                   help="focal length in px for --save_ply depth conversion")
    p.add_argument("--baseline", type=float, default=0.54,
                   help="stereo baseline in meters for --save_ply")
    return p.parse_args(argv)


def main(argv=None, device=None):
    """Write one colormapped PNG per pair (and the .npy / .ply asked for);
    returns the written PNG paths. ``device`` is for callers in Python."""
    args = parse_args(argv)

    from dkt_stereo_tpu_torch.cli.config import load_model_config
    from dkt_stereo_tpu_torch.data import png
    from dkt_stereo_tpu_torch.data.readers import read_image_rgb
    from dkt_stereo_tpu_torch.device import resolve_device
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.train.checkpoint import restore_variables
    from dkt_stereo_tpu_torch.utils.visualization import disp_to_color, disp_to_ply

    dev = resolve_device(device)
    weights = restore_variables(args.restore_ckpt, args.which)
    config = load_model_config(args.config)
    model = create_model(config, iters=args.valid_iters, device=dev, test_mode=True)
    model.load_state_dict(weights, strict=True)
    fwd = make_forward_fn(model, dev)

    out_dir = Path(args.output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for lp, rp in zip(sorted(glob(args.left_imgs)), sorted(glob(args.right_imgs))):
        img1 = read_image_rgb(lp).astype(np.float32)
        img2 = read_image_rgb(rp).astype(np.float32)
        disp, _ = _run_one(fwd, img1, img2, args.divide_factor)
        disp = -disp  # negative-flow convention -> positive disparity
        stem = Path(lp).stem
        if args.save_numpy:
            np.save(out_dir / f"{stem}.npy", disp)
        if args.save_ply:
            disp_to_ply(str(out_dir / f"{stem}.ply"), disp, img1, focal=args.focal,
                        baseline=args.baseline)
        rgb, _ = disp_to_color(disp)
        png.write(out_dir / f"{stem}.png", rgb[0].transpose(1, 2, 0).astype(np.uint8))
        written.append(out_dir / f"{stem}.png")
        print(f"{lp} -> {out_dir / (stem + '.png')}")
    return written


if __name__ == "__main__":
    main()
