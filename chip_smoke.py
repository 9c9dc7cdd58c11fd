#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (dkt_stereo_tpu_torch) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its result on a line of its own; any failure or
out-of-tolerance result raises and exits non-zero:

  1. device: the card's name and power limit; builds the kernels from
     dkt_stereo_tpu_torch/csrc with nvcc (in parallel) and times the build;
  2. K1 (corr lookup) vs its plain version at the main path's shapes, bf16
     and fp32 pyramids, coordinates far out of range included;
  3. K2 (encoder stage) vs its plain version at (2, 736, 1280, 64) bf16 and
     at a ragged (3, 37, 45, 64), both stage variants, with cuDNN's conv of
     the same shape as yardstick;
  4. full-model parity, kernels vs plain path (the plain path is the CPU's),
     fp32 with TF32 off, 1x256x512, 2 iterations;
  5. the main path: configs/raft_stereo/pallas.json, bf16, 1x736x1280,
     32 iterations, seeded random weights, through make_forward_fn/_run_one,
     counting the kernel launches of the timed frames;
  6. a per-kernel profile of one main-path frame (torch.profiler), the
     "kernels" JSON line and the card's line.

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 non-tensor
MAIN_FRAMES = 20


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, n):
    """Mean device time of one call over ``n`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_k1(torch):
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup, corr_lookup_plain

    B, H, W1, r, L = 1, 184, 320, 4, 4
    g = torch.Generator(device="cuda").manual_seed(1)
    coords = torch.rand((B, H, W1, 1), generator=g, device="cuda") * (W1 + 40) - 20
    flat = coords.view(-1)
    flat[:8] = torch.tensor([-1e9, 1e9, 3e7, -0.5, -1.0, 0.0, 17.0, W1 - 1.0])
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        pyr = [torch.randn((B, H, W1, W1 >> i), generator=g, device="cuda").to(dt) for i in range(L)]
        got = corr_lookup(pyr, coords, r)
        want = corr_lookup_plain(pyr, coords, r)
        err = float((got - want).abs().max())
        vmax = max(float(v.abs().max()) for v in pyr)
        # the kernel shares one fractional weight across the taps of a
        # (pixel, level); the plain version rounds each tap position on its
        # own: at positions < 512 that moves a weight by <= 2^-15, so the
        # difference stays below 1e-4 of the volume's scale
        tol = 1e-4 * vmax
        check(err <= tol, f"K1 {dt} max-abs {err} > {tol}")
        res[str(dt).split(".")[-1]] = (pyr, err)
    pyr, err = res["bfloat16"]
    max_err = max(e for _, e in res.values())
    ms = cuda_ms(torch, lambda: corr_lookup(pyr, coords, r), 200)
    plain_ms = cuda_ms(torch, lambda: corr_lookup_plain(pyr, coords, r), 20)
    # bytes this run's data needs: in-range taps read once, coords, output
    taps_read = 0
    for i, v in enumerate(pyr):
        x0 = torch.floor(coords.clamp(-1e6, 1e6) / 2**i - r)
        idx = x0 + torch.arange(2 * r + 2, device="cuda")
        taps_read += int(((idx >= 0) & (idx < v.shape[-1])).sum()) * v.element_size()
    out_bytes = B * H * W1 * L * (2 * r + 1) * 4
    nbytes = taps_read + coords.numel() * 4 + out_bytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 corr_lookup: max_abs fp32 {res['float32'][1]:.3e} bf16 {res['bfloat16'][1]:.3e} | "
          f"bf16 pyramid {tuple(pyr[0].shape)}..{tuple(pyr[-1].shape)}: kernel_ms {ms:.4f} "
          f"plain_ms {plain_ms:.4f} library_ms none (no single PyTorch call computes the "
          f"four-level lookup) bound_ms {bound_ms:.4f} ({nbytes / 1e6:.2f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, max_abs_err=max_err)


def phase_k2(torch):
    import torch.nn.functional as F

    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage, encoder_stage_plain

    C = 64
    dt = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, H, W):
        u, v = (torch.randn((B, H, W, C), generator=g, device="cuda").to(dt) for _ in range(2))
        a1, a2 = (0.5 + torch.rand((B, C), generator=g, device="cuda") for _ in range(2))
        b1, b2 = (0.1 * torch.randn((B, C), generator=g, device="cuda") for _ in range(2))
        return u, a1, b1, dict(v=v, a2=a2, b2=b2, emit_h=True)

    def errors(name, args, kw):
        """Relative max-abs error of each output against the plain version
        (over the largest |value|), and the absolute max-abs error of y/h."""
        got = encoder_stage(*args, **kw)
        want = encoder_stage_plain(*args, **kw)
        # y and h are bf16 roundings of fp32 values summed in another order:
        # a rounding boundary can flip one bf16 ulp (2^-8 relative); the
        # statistics are fp32 sums over up to 1.9M pixels
        rel, abs_err = {}, 0.0
        for k, gt, wt in zip(("y", "sum", "sumsq", "h"), got, want):
            diff = float((gt.float() - wt.float()).abs().max())
            rel[k] = diff / float(wt.float().abs().max())
            if k in ("y", "h"):
                abs_err = max(abs_err, diff)
        tol = {"y": 2**-7, "h": 2**-7, "sum": 1e-4, "sumsq": 1e-4}
        for k, e in rel.items():
            check(e <= tol[k], f"K2 {name} {k} relative error {e} > {tol[k]}")
        return rel, abs_err

    def fmt(rel):
        return " ".join(f"{k} {e:.2e}" for k, e in rel.items())

    w = torch.randn((C, C, 3, 3), generator=g, device="cuda") * (2.0 / (9 * C)) ** 0.5
    # ragged edges: tiles that overhang the image on the right and bottom
    u, a1, b1, res_kw = inputs(3, 37, 45)
    for name, kw in (("plain", {}), ("residual+emit_h", res_kw)):
        rel, _ = errors(f"ragged {name}", (u, a1, b1, w), kw)
        print(f"K2 encoder_stage [{name}] (3,37,45,64) bf16, ragged tiles: rel max_abs {fmt(rel)}")

    B, H, W = 2, 736, 1280
    u, a1, b1, res_kw = inputs(B, H, W)
    variants = {"plain": dict(), "residual+emit_h": res_kw}
    results = {}
    for name, kw in variants.items():
        rel, abs_err = errors(name, (u, a1, b1, w), kw)
        ms = cuda_ms(torch, lambda: encoder_stage(u, a1, b1, w, **kw), 10)
        plain_ms = cuda_ms(torch, lambda: encoder_stage_plain(u, a1, b1, w, **kw), 3)
        nbytes = 2 * u.numel() * u.element_size() + w.numel() * 2 + 4 * B * C * 4
        if "v" in kw:
            nbytes += 2 * u.numel() * u.element_size() + 2 * B * C * 4
        flops = 2.0 * B * H * W * C * C * 9
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops else "operations",
                             max_abs_err=abs_err, rel=rel)
    # cuDNN's conv of the same shape alone, as a yardstick the port never calls
    x = u.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wl = w.to(dt).contiguous(memory_format=torch.channels_last)
    lib_ms = cuda_ms(torch, lambda: F.conv2d(x, wl, padding=1), 10)
    for name, r in results.items():
        r["library_ms"] = lib_ms
        print(f"K2 encoder_stage [{name}] (2,736,1280,64) bf16: rel max_abs {fmt(r.pop('rel'))} "
              f"| max_abs {r['max_abs_err']:.3e} | kernel_ms {r['ms']:.3f} "
              f"plain_ms {r['plain_ms']:.3f} library_ms {lib_ms:.3f} (cuDNN conv2d alone) "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})")
    return results


def phase_parity(torch, config):
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {**config, "mixed_precision": False, "corr_dtype": "float32"}
    # two iterations: with random weights the GRU amplifies fp32 rounding
    # differences each iteration; on the CPU alone the fused and unfused
    # encoder paths drift apart by 1.4e-4, 8.5e-4, 1.8e-2 and 3.9 px after 1,
    # 2, 4 and 8 iterations at this size, so a longer run tests the weights,
    # not the kernels
    iters = 2
    gpu = create_model(cfg, iters=iters, device="cuda", seed=0)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(3)
    img1, img2 = (rng.uniform(0, 255, (256, 512, 3)).astype(np.float32) for _ in range(2))
    d_gpu, _ = _run_one(make_forward_fn(gpu, device="cuda"), img1, img2)
    d_cpu, _ = _run_one(make_forward_fn(cpu, device="cpu"), img1, img2)
    err = float(np.abs(d_gpu - d_cpu).max())
    scale = float(np.abs(d_cpu).max())
    # the JAX package's bound between its fused and unfused encoder paths
    # (tests/test_pallas_encoder.py:123)
    tol = 5e-3
    print(f"full-model parity (fp32, TF32 off, 1x256x512, {iters} iters): disp_up max_abs "
          f"kernels-vs-plain {err:.3e} px (max |disp| {scale:.1f} px, tol {tol})")
    check(np.isfinite(d_gpu).all() and err <= tol, f"full-model parity {err} > {tol}")
    torch.backends.cudnn.allow_tf32 = True
    del gpu, cpu


def phase_main(torch, config, card):
    from dkt_stereo_tpu_torch.eval.validate import _run_one, make_forward_fn
    from dkt_stereo_tpu_torch.models.registry import create_model
    from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
    from dkt_stereo_tpu_torch.ops.cuda.encoder_conv import encoder_stage

    iters = 32
    model = create_model(config, iters=iters, seed=0)
    forward = make_forward_fn(model)
    rng = np.random.default_rng(0)
    img1, img2 = (rng.uniform(0, 255, (736, 1280, 3)).astype(np.float32) for _ in range(2))
    _run_one(forward, img1, img2)  # warm-up
    torch.cuda.reset_peak_memory_stats()

    corr_lookup.launches = 0
    encoder_stage.launches = 0
    times = []
    for _ in range(MAIN_FRAMES):
        disp, dt = _run_one(forward, img1, img2)
        times.append(dt)
    launches = {"corr_lookup": corr_lookup.launches, "encoder_stage": encoder_stage.launches}

    check(disp.shape == (736, 1280), f"disp shape {disp.shape}")
    check(bool(np.isfinite(disp).all()), "non-finite disparity")
    want = {"corr_lookup": iters * MAIN_FRAMES, "encoder_stage": 4 * MAIN_FRAMES}
    check(launches == want, f"launch counts {launches} != {want}")
    ms = 1e3 * np.asarray(times)
    print(f"main path (pallas.json, bf16, 1x736x1280, {iters} iters, {MAIN_FRAMES} frames): "
          f"ms/frame median {np.median(ms):.2f} mean {ms.mean():.2f} min {ms.min():.2f} "
          f"max {ms.max():.2f} | frames/s {1e3 / ms.mean():.3f} | "
          f"launches {launches} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"| disp range [{disp.min():.2f}, {disp.max():.2f}] | {card}")
    return model, forward, (img1, img2), launches


def phase_profile(torch, forward, images):
    """Device time by kernel over one main-path frame, and the share of the
    frame's host-clock time in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dkt_stereo_tpu_torch.eval.validate import _run_one

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _run_one(forward, *images)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    busy = sum(t for t, _ in by_name.values())
    lines = [f"{t:9.3f} ms {n:6d}x  {name}" for name, (t, n) in ranked]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_profile.txt").write_text("\n".join(lines) + "\n")
    print(f"profile of one frame (profiler on): wall {wall * 1e3:.2f} ms, kernels {busy:.2f} ms, "
          f"device idle share {1 - busy / (wall * 1e3):.3f}; top kernels:")
    for line in lines[:12]:
        print("  " + line[:160])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from dkt_stereo_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1

    card = gpu_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {[p.name for p in libs]}")

    k1 = phase_k1(torch)
    k2 = phase_k2(torch)
    config = json.loads((ROOT / "configs/raft_stereo/pallas.json").read_text())
    phase_parity(torch, config)
    _, forward, images, launches = phase_main(torch, config, card)
    phase_profile(torch, forward, images)

    k2p = k2["plain"]
    kernels = [
        dict(name="corr_lookup", route="cuda", source="dkt_stereo_tpu_torch/csrc/corr_lookup.cu",
             replaces="dkt_stereo_tpu/ops/pallas/corr_lookup.py:290",
             launches=launches["corr_lookup"], **k1),
        dict(name="encoder_stage", route="cuda",
             source="dkt_stereo_tpu_torch/csrc/encoder_stage.cu",
             replaces="dkt_stereo_tpu/ops/pallas/encoder_conv.py:274",
             launches=launches["encoder_stage"],
             max_abs_err=max(r["max_abs_err"] for r in k2.values()),
             **{k: k2p[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
