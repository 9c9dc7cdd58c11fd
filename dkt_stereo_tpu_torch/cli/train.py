"""DKT fine-tuning driver (``dkt_stereo_tpu/cli/train.py``; the reference's
tools/ft_dkt.py), on the GPU:

  python -m dkt_stereo_tpu_torch.cli.train --config configs/raft_stereo/train.json \\
      --train_datasets booster --restore_ckpt <step_N dir or .pth> ...

The flags are the JAX CLI's. The host loop feeds the loader's batches to the
DKT step (``train/dkt_step.py``), logs, validates and checkpoints. A config
with ``"loss_func": "ns_loss"`` (``configs/raft_stereo/ns.json``) trains on
NeRF-Stereo triplets instead:

  python -m dkt_stereo_tpu_torch.cli.train --config configs/raft_stereo/ns.json \\
      --train_datasets nerf_stereo [sceneflow ...] [--ns_num_tri N] ...

through ``data/loader.py::MixedStereoLoader`` (``nb`` binocular and ``nt``
trinocular samples a batch, ``--ns_num_tri`` setting ``nt``) and
``train/ns_step.py`` with ``--conf_threshold`` and ``--disp_threshold``.

  - ``--restore_ckpt`` takes a reference ``.pth`` (student, EMA and teacher
    from it; ``--restore_ckpt_T`` pins the teacher to another) or a port
    checkpoint (``train/checkpoint.py``), restored in full or, with
    ``--restore_weights_only``, only its three weight sets (step 0, a fresh
    optimizer and schedule); ``--restore_ckpt_T`` then pins the teacher to
    that checkpoint's student. ``--auto_resume`` takes the newest
    ``step_N`` under ``--save_dir`` when there is one.
  - The loop runs while the step count is at most ``--num_steps``, so the
    last checkpoint is ``step_{num_steps+1}``; at every
    ``validation_frequency - 1`` it saves, then runs the five validators on
    a test-mode copy of the student at ``--valid_iters`` (a dataset absent
    on the machine is logged and skipped).
  - F&E draws from a ``torch.Generator`` seeded with ``--seed``.
  - Each save and the end log the host's seconds a step, the time the
    loop waited for the loader and the peak device memory.
  - ``--profile_dir`` traces the steps ``[step + --profile_start, step +
    --profile_start + --profile_steps)``, counted from the step the run
    starts at (a resumed run's too), into a Chrome/TensorBoard trace
    (``train/profiling.py::TraceWindow``), on rank 0.
  - Multi-process data parallelism, one process a device: the same command
    on every process with ``--coordinator_address host:port`` (rank 0's;
    any ``init_method`` URL, ``file://...`` too), ``--num_processes N`` and
    a distinct ``--process_id``. The backend is NCCL on GPUs (rank k on
    ``cuda:k`` of its host's devices) and gloo on the CPU. ``--batch_size``
    is the global batch and must divide by N; each rank loads its rows
    (``data/loader.py``), the state is broadcast from rank 0 once, and the
    step sums the gradients over the ranks (``parallel/mesh.py``). Rank 0
    logs, saves and validates; every rank waits at a barrier after each
    save and after each validation.

``main(argv, device="cpu")`` runs on the CPU; without ``device`` it wants a
CUDA device and raises when there is none. ``--batched_teachers`` (or
``batched_teachers`` in the config) runs the frozen and the EMA teacher as
one batched forward (``train/dkt_step.py``), which on an H100 is slower
than the two forwards it replaces (PERF.md); ``--profile_port`` raises:
JAX's live profiler server has no PyTorch counterpart (ROADMAP.md, "Not to
port, by design").
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from dkt_stereo_tpu_torch.cli.config import load_model_config, merge_config
from dkt_stereo_tpu_torch.data.datasets import fetch_dataset
from dkt_stereo_tpu_torch.data.loader import MixedStereoLoader, StereoLoader
from dkt_stereo_tpu_torch.data.triplet import split_modalities
from dkt_stereo_tpu_torch.device import resolve_device
from dkt_stereo_tpu_torch.eval import validate
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.parallel.mesh import (
    default_backend,
    initialize_multihost,
    rank_and_size,
    replicate,
)
from dkt_stereo_tpu_torch.train.checkpoint import (
    import_timm_mobilenetv2,
    latest_checkpoint,
    restore_checkpoint,
    restore_variables,
    save_checkpoint,
)
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state, make_dkt_train_step
from dkt_stereo_tpu_torch.train.ns_step import make_ns_train_step
from dkt_stereo_tpu_torch.train.profiling import TraceWindow
from dkt_stereo_tpu_torch.train.state import DKTHyperParams, make_schedule
from dkt_stereo_tpu_torch.utils.logging import Logger, save_images
from dkt_stereo_tpu_torch.utils.visualization import disp_to_color


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    # tools/ft_dkt.py:312-344 flags
    p.add_argument("--config", required=True)
    p.add_argument("--name", default="model")
    p.add_argument("--save_dir", default="runs/debug")
    p.add_argument("--restore_ckpt", default=None)
    p.add_argument("--restore_ckpt_T", default=None)
    p.add_argument(
        "--restore_weights_only",
        action="store_true",
        help="take the student/EMA/teacher weights from a port --restore_ckpt but start a "
        "fresh run (step 0, fresh optimizer and schedule): the two-stage recipes' stage 2 "
        "(the reference restores state_dict only, tools/ft_dkt.py:133-151)",
    )
    p.add_argument(
        "--auto_resume",
        action="store_true",
        help="resume from the newest step_N checkpoint in --save_dir when one exists "
        "(relaunch the identical command after an interruption; the checkpoint, optimizer "
        "and schedule included, overrides --restore_ckpt)",
    )
    p.add_argument("--pretrained_backbone", default=None,
                   help="raw timm mobilenetv2_100 checkpoint (.pth/.npz) for IGEV's or CGI's "
                        "trunk (the reference's timm pretrained=True, igev_stereo/extractor.py:330, "
                        "cgi/CGI_Stereo.py:44); applied "
                        "when no --restore_ckpt is given")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--num_steps", type=int, default=200000)
    p.add_argument("--image_size", type=int, nargs="+", default=[320, 720])
    p.add_argument("--train_iters", type=int, default=16)
    p.add_argument("--wdecay", type=float, default=1e-5)
    p.add_argument("--cascade_train", action="store_true")
    p.add_argument("--batched_teachers", action="store_true",
                   help="run the frozen and the EMA teacher as one batched forward over "
                        "their stacked weights (also enabled by batched_teachers:true in "
                        "--config); on an H100 this is slower than the two forwards it "
                        "replaces (PERF.md)")
    p.add_argument("--ema_decay", type=float, default=0.99999)
    p.add_argument("--clamp", type=float, default=1.0)
    p.add_argument("--tau_gt", type=float, default=3.0)
    p.add_argument("--tau_pl", type=float, default=3.0)
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--img_gamma", type=float, nargs="+", default=None)
    p.add_argument("--saturation_range", type=float, nargs="+", default=[0, 1.4])
    p.add_argument("--do_flip", default=False, choices=["h", "v", False])
    p.add_argument("--spatial_scale", type=float, nargs="+", default=[-0.2, 0.4])
    p.add_argument("--noyjitter", action="store_true")
    # NeRF-Stereo training (loss_func=ns_loss + nerf_stereo)
    p.add_argument("--conf_threshold", type=float, default=0.5)
    p.add_argument("--disp_threshold", type=float, default=512.0)
    p.add_argument("--ns_num_tri", type=int, default=None)
    p.add_argument("--data_root", default="data")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--num_workers", type=int, default=16)
    p.add_argument("--validation_frequency", type=int, default=1000)
    # multi-process data parallelism: one process a device, the same command
    # and a distinct --process_id on every process
    p.add_argument("--coordinator_address", default=None,
                   help="rank 0's host:port (or an init_method URL such as file:///path)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    # observability (train/profiling.py)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (host ops, and CUDA kernels on the GPU; "
                        "Chrome/TensorBoard JSON) of steps [step + --profile_start, step + "
                        "--profile_start + --profile_steps), counted from the run's first step")
    p.add_argument("--profile_start", type=int, default=3,
                   help="first step to trace, after the run's first (skip warm-up)")
    p.add_argument("--profile_steps", type=int, default=3)
    p.add_argument("--profile_port", type=int, default=None,
                   help="JAX's live profiler server: not ported, by design (it raises)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each refinement iteration in the backward pass "
                        "(remat_iters): activation memory O(1) in train_iters")
    return p.parse_args(argv)


_VALIDATORS = (("validate_eth3d", "ETH3D", {}),
               ("validate_middlebury", "Middlebury", {"resolution": "H"}),
               ("validate_kitti", "KITTI", {"split": "2012"}),
               ("validate_kitti", "KITTI", {"split": "2015"}),
               ("validate_booster", "Booster_dataset", {"resolution": "Q"}))


def _check_flags(args):
    """Refuse ``--profile_port`` and a global batch that cannot split over
    the processes, before any process group is joined."""
    if args.profile_port is not None:
        raise NotImplementedError(
            "--profile_port: not to port, by design: PyTorch has no in-process profiler "
            "server for TensorBoard to attach to (JAX's jax.profiler.start_server); trace a "
            "window of steps with --profile_dir instead (ROADMAP.md, \"Not to port, by "
            "design\")")
    n = args.num_processes or 1
    if args.batch_size % n:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by --num_processes "
                         f"{n} (the global batch is split over the processes)")


class StepTimes:
    """Host seconds of each step of this process's run: the whole iteration
    of the loop (without saving and validating), the part blocked in the
    loader's ``next`` and the step's own part (the copy to the device, the
    DKT step and its metrics, which wait for the device)."""

    def __init__(self):
        self.iteration, self.wait, self.step = [], [], []

    def add(self, iteration, wait, step):
        self.iteration.append(iteration)
        self.wait.append(wait)
        self.step.append(step)

    def summary(self, device) -> dict:
        """Median, min and max in ms of the steps after the first, and the
        peak device memory in GiB (CUDA only)."""
        out = {"steps": len(self.step)}
        for name, secs in (("ms_per_step", self.iteration), ("wait_ms", self.wait),
                           ("step_ms", self.step)):
            ms = 1e3 * np.asarray(secs[1:] or secs)
            if ms.size:
                out[name] = {"median": float(np.median(ms)), "min": float(ms.min()),
                             "max": float(ms.max())}
        if device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        return out


def _to_device(batch, dev):
    """The loader's (nested) batch of CPU tensors on ``dev``."""
    if isinstance(batch, dict):
        return {k: _to_device(v, dev) for k, v in batch.items()}
    return batch.to(dev, non_blocking=True)


def _restore(args, state):
    """Apply --pretrained_backbone, --auto_resume, --restore_ckpt and
    --restore_ckpt_T to ``state`` (the JAX CLI's order and semantics)."""
    def load_all(sd, teacher=None):
        state.student.load_state_dict(sd, strict=True)
        state.ema.load_state_dict(sd, strict=True)
        state.teacher.load_state_dict(sd if teacher is None else teacher, strict=True)

    if args.pretrained_backbone and not args.restore_ckpt:
        load_all(import_timm_mobilenetv2(args.pretrained_backbone, state.student))
    if args.auto_resume:
        latest = latest_checkpoint(args.save_dir)
        if latest is not None:
            logging.info("auto-resume from %s", latest)
            args.restore_ckpt = latest
    if not args.restore_ckpt:
        return
    if args.restore_ckpt.endswith(".pth"):
        teacher = None
        if args.restore_ckpt_T and args.restore_ckpt_T != args.restore_ckpt:
            teacher = restore_variables(args.restore_ckpt_T)
        load_all(restore_variables(args.restore_ckpt), teacher)
    else:
        restore_checkpoint(args.restore_ckpt, state, weights_only=args.restore_weights_only)
        if args.restore_ckpt_T:
            # pin the frozen teacher (ft_dkt.py:144-151): a .pth, or a port
            # checkpoint's student
            state.teacher.load_state_dict(restore_variables(args.restore_ckpt_T), strict=True)


def _validate(args, config, state, dev, cache) -> dict:
    """The five validators on a test-mode copy of the student at
    ``valid_iters``; a dataset absent on the machine is logged and
    skipped."""
    if "model" not in cache:
        cache["model"] = create_model(config, iters=args.valid_iters, device=dev, test_mode=True)
    model = cache["model"]
    model.load_state_dict(state.student.state_dict(), strict=True)
    fwd = validate.make_forward_fn(model, dev)
    results = {}
    for fn, sub, kw in _VALIDATORS:
        try:
            results.update(getattr(validate, fn)(fwd, data_root=f"{args.data_root}/{sub}", **kw))
        except (OSError, AssertionError) as e:  # the dataset is absent on this machine
            logging.warning("validation %s %s skipped: %r", fn, kw, e)
    return results


def _log_step(lg, metrics, cpu_batch, total_steps):
    """Rank 0's scalars and, every 100 steps, its image dumps."""
    lg.writer.add_scalar("live_loss", metrics["loss"], total_steps)
    lg.writer.add_scalar("learning_rate", metrics["learning_rate"], total_steps)
    for k in ("ema_divergence", "teacher_divergence"):
        if k in metrics:
            lg.writer.add_scalar(k, metrics[k], total_steps)
    lg.push({k: metrics[k] for k in ("epe", "1px", "3px", "5px", "loss") if k in metrics})
    if total_steps % 100 == 0 and "flow" in cpu_batch:
        # image dumps (ft_dkt.py:252-272): inputs and colormapped GT
        gt_img, _ = disp_to_color(-cpu_batch["flow"][0].numpy())
        save_images(lg.writer, "train", {
            "image1": cpu_batch["img1"].numpy().transpose(0, 3, 1, 2),
            "image1_clean": cpu_batch["img1_clean"].numpy().transpose(0, 3, 1, 2),
            "disp_gt": gt_img}, total_steps)


def train(args, device=None) -> dict:
    """Run the fine-tune; returns ``{"checkpoint": the last step_N path,
    "timing": StepTimes.summary, "step_seconds": each step's own host
    seconds, "validation": the last validators' results, "trace": the
    profiler trace's path or None}``. With ``--num_processes`` > 1 this
    process is one rank; rank 0 alone writes the checkpoints, logs and the
    trace, and every rank returns the same checkpoint path."""
    config = load_model_config(args.config)
    _check_flags(args)
    dev = resolve_device(device)
    joined = initialize_multihost(args.coordinator_address, args.num_processes,
                                  args.process_id, default_backend(dev))
    try:
        return _train(args, config, dev)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train(args, config, dev) -> dict:
    rank, size = rank_and_size()
    if dev.type == "cuda" and size > 1:  # one process a device
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    # strict-disjoint check (ft_dkt.py:347-350); batched_teachers may come
    # from either surface
    merge_config(args, config, allow=("batched_teachers",))
    if args.remat:
        config["remat_iters"] = True
    hyper = DKTHyperParams(
        lr=args.lr, wdecay=args.wdecay, num_steps=args.num_steps, train_iters=args.train_iters,
        valid_iters=args.valid_iters, ema_decay=args.ema_decay, tau_gt=args.tau_gt,
        tau_pl=args.tau_pl, clamp=args.clamp, cascade_train=args.cascade_train,
        batched_teachers=args.batched_teachers or bool(config.get("batched_teachers", False)))

    dataset = fetch_dataset(args.train_datasets, tuple(args.image_size),
                            tuple(args.spatial_scale), args.saturation_range, args.img_gamma,
                            args.do_flip, args.noyjitter, data_root=args.data_root,
                            conf_threshold=args.conf_threshold,
                            disp_threshold=args.disp_threshold)
    ns_mode = config.get("loss_func") == "ns_loss"
    bi_ds, tri_ds = split_modalities(dataset)
    if ns_mode:
        if tri_ds is None:
            raise SystemExit("loss_func=ns_loss needs trinocular data: add nerf_stereo to "
                             "--train_datasets")
        loader = MixedStereoLoader(bi_ds, tri_ds, batch_size=args.batch_size,
                                   num_tri=args.ns_num_tri, num_workers=args.num_workers,
                                   seed=args.seed, num_hosts=size, host_id=rank)
    else:
        if tri_ds is not None:
            raise SystemExit("nerf_stereo training data needs loss_func=ns_loss in the config "
                             "(the NS step consumes the trinocular batch contract)")
        loader = StereoLoader(dataset, batch_size=args.batch_size,
                              num_workers=args.num_workers, seed=args.seed, num_hosts=size,
                              host_id=rank)
    if len(loader) == 0:
        # an empty epoch would spin the training loop forever
        raise SystemExit(f"dataset too small for --batch_size {args.batch_size}: the loader "
                         f"yields 0 batches an epoch ({len(dataset)} samples)")

    state = create_dkt_state(config, hyper, seed=args.seed, device=dev)
    _restore(args, state)
    # every rank built the same state; rank 0's is the one all ranks train
    replicate(state.student, state.ema, state.teacher, state.optimizer)
    # the step's draws (F&E's, the blend weights): the global batch's, the same on
    # every rank
    generator = torch.Generator().manual_seed(args.seed)
    if ns_mode:
        step_fn = make_ns_train_step(config, hyper, nb=loader.nb, nt=loader.nt,
                                     conf_threshold=args.conf_threshold,
                                     disp_threshold=args.disp_threshold, num_hosts=size)
    else:
        step_fn = make_dkt_train_step(config, hyper)
    schedule = make_schedule(hyper)
    save_dir = Path(args.save_dir)
    lg = window = None
    if rank == 0:
        save_dir.mkdir(parents=True, exist_ok=True)
        lg = Logger(str(save_dir), get_lr=lambda: float(schedule(state.step)),
                    start_step=state.step)  # a resumed run logs at its true step
        if args.profile_dir is not None:
            window = TraceWindow(args.profile_dir, state.step + args.profile_start,
                                 args.profile_steps, dev)
    times, cache, results = StepTimes(), {}, {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    logging.info("training %s for %d steps on %s (rank %d of %d)", config["model"],
                 args.num_steps, dev, rank, size)
    try:
        while state.step <= args.num_steps:
            batches = iter(loader)
            while state.step <= args.num_steps:
                t0 = time.perf_counter()
                cpu_batch = next(batches, None)
                if cpu_batch is None:
                    break
                t1 = time.perf_counter()
                with window.step(state.step) if window else contextlib.nullcontext():
                    batch = _to_device(cpu_batch, dev)
                    state, metrics = step_fn(state, batch, generator=generator)
                t2 = time.perf_counter()
                total_steps = state.step
                if lg is not None:
                    _log_step(lg, metrics, cpu_batch, total_steps)
                times.add(time.perf_counter() - t0, t1 - t0, t2 - t1)
                if window is not None and total_steps >= window.last:
                    window.close()  # the window is done: write its trace

                if total_steps % args.validation_frequency == args.validation_frequency - 1:
                    if rank == 0:
                        path = save_checkpoint(save_dir, state, total_steps + 1)
                        logging.info("saved %s", path)
                        logging.info("timing %s", json.dumps(times.summary(dev)))
                    _barrier(size)
                    if rank == 0:
                        results = _validate(args, config, state, dev, cache)
                        logging.info("validation %s", json.dumps(results))
                        lg.write_dict(results)
                    _barrier(size)
        if rank == 0:
            final = save_checkpoint(save_dir, state)
        else:
            final = str(save_dir.absolute() / f"step_{state.step}")
        _barrier(size)
    finally:
        loader.close()
        if window is not None:
            window.close()
        if lg is not None:
            lg.close()
    if window is not None and window.path:
        logging.info("profiler trace written to %s", window.path)
    timing = times.summary(dev)
    logging.info("timing %s", json.dumps(timing))
    logging.info("FINISHED TRAINING -> %s", final)
    return {"checkpoint": final, "timing": timing, "step_seconds": list(times.step),
            "validation": results, "trace": window.path if window else None}


def _barrier(size: int) -> None:
    """Every rank waits here (a no-op for one process): after rank 0's save
    and after its validation, so that no rank runs ahead into the next
    step's collectives while rank 0 is busy."""
    if size > 1:
        torch.distributed.barrier()


def main(argv=None, device=None):
    """``device`` is for callers in Python (the tests pass ``"cpu"``); it
    adds no command-line flag."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
    )
    return train(parse_args(argv), device)


if __name__ == "__main__":
    main()
