"""Frames through the program's evaluation entry: a seeded pool of host
image pairs, each request copied to the card, replicate-padded as
``eval/validate.py::_run_one`` pads (``ops/pad.py``, sintel mode), run by
``make_forward_fn``'s forward, unpadded and copied back before the next one
is sent (a closed loop with one client). Shared by the ``stream`` (B=1) and
``batch`` drivers.

Host spans a request: ``forward`` (inside the forward call: the host's
dispatch, as the device runs behind it) and ``copy_wait`` (unpad and the
copy back, which waits for the device); the copy in and the padding before
them complete the request's latency.

Correctness: once the window has closed and the program is freed, a sample
of the window's frames drawn from the seed is run again through the plain
reference that the configuration names (fp32, TF32 off), padded the same
way in plain PyTorch, and each sampled disparity is compared pixel by
pixel: the widest gap, in px. (The mean gap is kept beside the reference's
scale for the record: the control reads it less than three times the
program's largest, so no limit on it would hold.) The reference's recorded
lookups give the bytes a launch of the program's correlation kernels at
these inputs (``launch_bytes``), which the rooflines read.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from stereo_bench import flops, harness, trace
from stereo_bench.reference.precision import exact_fp32


def unit_flops(cell: dict, config: dict, ref) -> int:
    """Model FLOPs of one frame at the cell's padded size."""
    B = cell["batch"]
    H, W = harness.padded(cell["frame"], cell["divis_by"])
    return flops.frame_flops(ref, config["model"], B, H, W, config["iters"]) // B


def pad_plain(x: torch.Tensor, divis_by: int):
    """Symmetric replicate padding of (B, H, W, 3) to multiples of
    ``divis_by``; returns the padded tensor and the (top, left) offsets."""
    H, W = x.shape[1:3]
    Hp, Wp = harness.padded((H, W), divis_by)
    t, l = (Hp - H) // 2, (Wp - W) // 2
    out = F.pad(x.permute(0, 3, 1, 2), (l, Wp - W - l, t, Hp - H - t), mode="replicate")
    return out.permute(0, 2, 3, 1), (t, l)


def reference_model(ctx, weights, precision):
    ref = ctx.reference
    model = ref.build(ctx.config["model"]).to(ctx.device)
    model.load_state_dict(weights, strict=True)
    return model.set_precision(precision).eval()


def reference_frames(ctx, weights, pool, picks):
    """The reference's disparity of each picked (pair, row) of the pool,
    and the bytes a launch of the program's kernels at those inputs."""
    cell, config, ref = ctx.cell, ctx.config, ctx.reference
    model = reference_model(ctx, weights, "fp32")
    recording = hasattr(ref, "record")
    if recording:
        ref.record([model], True)
    out = {}
    with torch.no_grad(), exact_fp32():
        for p, b in sorted(set(picks)):
            x = [torch.as_tensor(pool[p][j][b:b + 1], device=ctx.device) for j in (0, 1)]
            (x1, (t, l)), (x2, _) = (pad_plain(v, cell["divis_by"]) for v in x)
            disp = ref.disparity(model, x1, x2, config["iters"])[0]
            H, W = cell["frame"]
            out[p, b] = disp[t:t + H, l:l + W].cpu().numpy()
    itemsize = 2 if config["precision"] == "bfloat16" else 4
    launch = ref.launch_bytes([model], itemsize) if recording else {}
    del model
    return out, launch


def make_forward(ctx, weights):
    """The program's forward (``make_forward_fn`` over ``create_model`` of
    the config, the seeded weights loaded), or in the control the
    reference one precision below, in its place."""
    from dkt_stereo_tpu_torch.eval.validate import make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    config, dev = ctx.config, ctx.device
    if ctx.control:
        model = reference_model(ctx, weights, config["control"])

        def forward(x1, x2):
            with torch.no_grad(), exact_fp32():
                return ctx.reference.disparity(model, x1, x2, config["iters"])

        return forward
    with torch.device(dev):
        model = create_model(config["model"], iters=config["iters"], device=dev)
    model.load_state_dict(weights, strict=True)
    return make_forward_fn(model, dev)


def run(ctx) -> dict:
    from dkt_stereo_tpu_torch.ops.pad import pad_input, unpad_input

    cell, config, dev = ctx.cell, ctx.config, ctx.device
    B, (H, W), divis = cell["batch"], cell["frame"], cell["divis_by"]
    cuda = dev.type == "cuda"
    weights = harness.reference_weights(ctx.reference, config["model"],
                                        harness.stream_seed(ctx.seed, 0), dev,
                                        config["init_scale"])
    gen = torch.Generator(device=dev).manual_seed(harness.stream_seed(ctx.seed, 1))
    pool = (255 * torch.rand((cell["pool"], 2, B, H, W, 3), generator=gen, device=dev)).cpu()
    pool = pool.numpy()
    forward = make_forward(ctx, weights)

    def frame(i):
        left, right = pool[i % len(pool)]
        t0 = time.perf_counter()
        x1, spec = pad_input(torch.as_tensor(left, device=dev), divis, "sintel")
        x2, _ = pad_input(torch.as_tensor(right, device=dev), divis, "sintel")
        t1 = time.perf_counter()
        disp = forward(x1, x2)
        t2 = time.perf_counter()
        out = unpad_input(disp[..., None], spec)[..., 0].cpu().numpy()
        return out, (t0, t1, t2, time.perf_counter())

    for i in range(cell["warmup"]):
        frame(i)  # each ends with its copy back, so the card is idle after
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    outs, stamps = [], []
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    while len(outs) < 2 or time.perf_counter() < deadline:
        out, ts = frame(len(outs))
        outs.append(out)
        stamps.append(ts)
    t_end = stamps[-1][3]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n = len(outs)
    rec = {
        "setup_s": t_start - ctx.t0, "window_s": t_end - t_start, "units": n, "frames": n * B,
        "latencies_s": [ts[3] - ts[0] for ts in stamps],
        "spans": {"forward": [ts[2] - ts[1] for ts in stamps],
                  "copy_wait": [ts[3] - ts[2] for ts in stamps]},
        "frames_per_unit": B, "peak_bytes": peak, "rows": B,
        "image": (B, *harness.padded((H, W), divis)),
        "flops_per_frame": cell["flops_per_unit"],
        "attempted": n * B, "failed": sum(int(not np.isfinite(o).all()) for o in outs),
    }
    if ctx.trace:
        rec["trace"] = trace.traced(lambda k: [frame(n + j) for j in range(k)],
                                    cell["trace_units"], dev)
    del forward
    if cuda:
        torch.cuda.empty_cache()

    rng = np.random.default_rng(harness.stream_seed(ctx.seed, 2))
    frames = [(i, b) for i in range(n) for b in range(B)]
    picks = [frames[j] for j in rng.choice(len(frames), min(cell["check_frames"], len(frames)),
                                           replace=False)]
    t_ref = time.perf_counter()
    want, rec["launch_bytes"] = reference_frames(ctx, weights, pool,
                                                 [(i % len(pool), b) for i, b in picks])
    rec["reference_s"] = time.perf_counter() - t_ref
    gaps = np.stack([np.abs(outs[i][b] - want[i % len(pool), b]) for i, b in picks])
    scale = np.stack([np.abs(want[i % len(pool), b]) for i, b in picks])
    rec["reference_px"] = {"max": float(scale.max()), "mean": float(scale.mean()),
                           "mean_gap": float(gaps.mean())}
    rec["checks"] = {"disp_max_gap_px": (float(gaps.max()), cell["limits"]["disp_max_gap_px"])}
    return rec
