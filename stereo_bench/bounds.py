"""The yardstick of the kernels and of the chip: published peaks of one
H100, the bytes and operations the port's kernels must move for their
inputs, kernel-name classes, and the reduction of a record to a roofline
share. The arithmetic is ``chip_smoke.py``'s (``k1_fwd_bytes``,
``k1_bwd_bytes``, ``k2_bound``, ``BUCKETS``), kept here where the program
cannot change it. K1's bytes are counted at the coordinates that the
cell's own inputs give (the reference records them as it runs), not at
the most a grid could need.
"""

from __future__ import annotations

import re

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; fp32 non-tensor

# kernel names in the device trace, by the port's CUDA sources
K1_FWD = r"corr_lookup_kernel"
K1_BWD = r"corr_lookup_bwd_kernel"
K2_FWD = r"encoder_stage_fwd_kernel|encoder_stage_f32_kernel<true>"

# device-time classes of a breakdown, by kernel name; the first match wins
BUCKETS = (
    ("K3", r"corr_alt_kernel"),
    ("K4 bwd", r"geo_lookup_bwd"),
    ("K4", r"geo_lookup_kernel"),
    ("K1 bwd", r"corr_lookup_bwd_kernel"),
    ("K1", r"corr_lookup_kernel"),
    ("K5 bwd", r"row_sample_bwd_kernel"),
    ("K5", r"row_sample_kernel"),
    ("K2 adjoint", r"encoder_stage_adjoint_kernel|encoder_stage_f32_kernel<false>"),
    ("K2", r"encoder_stage"),
    ("convolutions/GEMMs", r"xmma|cutlass|gemm|nvjet|conv|wgrad|dgrad|fprop"),
    ("cuDNN layout transforms", r"nchwToNhwc|nhwcToNchw|AddPadding"),
    ("strided bf16 adds", r"elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast"
                          r"<at::native::CUDAFunctor_add<c10::BFloat16>"),
    ("casts/copies", r"copy_kernel|Memcpy|Memset|CatArray"),
    ("batch norm", r"batch_norm"),
    ("reductions", r"reduce_kernel"),
    ("gathers/reflection pads", r"scatter_gather|reflection_pad"),
    ("resize/pool/softmax", r"upsample|pool|SoftMax"),
    ("optimizer", r"Optimizer|multi_tensor"),
    ("other elementwise", r""),
)


def bucket_of(name: str) -> str:
    return next(b for b, pat in BUCKETS if re.search(pat, name))


def bucket_line(trace: dict) -> str:
    """Device ms and operations a unit (frame or step) of a trace summary,
    by class."""
    tot = {b: [0.0, 0] for b, _ in BUCKETS}
    for name, (sec, n) in trace["kernels"].items():
        t = tot[bucket_of(name)]
        t[0] += sec
        t[1] += n
    u = trace["units"]
    return " | ".join(f"{b} {1e3 * s / u:.2f} ms/{n / u:.0f}" for b, (s, n) in tot.items() if n)


def k1_fwd_bytes(coords, widths, r, vol_itemsize, out_itemsize):
    """Bytes K1's forward must move for these inputs: the in-range values of
    each (pixel, level) window read once (a NaN coordinate reads nothing),
    the coordinates, the output written once. ``coords`` (B, H, W, 1) at
    level 0; ``widths`` the levels' widths."""
    c = coords[~torch.isnan(coords)]
    taps_read = 0
    for i, w2 in enumerate(widths):
        x0 = torch.floor((c / 2**i).clamp(-(r + 2), w2 + r + 1) - r)
        idx = x0[:, None] + torch.arange(2 * r + 2, device=c.device)
        taps_read += int(((idx >= 0) & (idx < w2)).sum()) * vol_itemsize
    out_bytes = coords.numel() * len(widths) * (2 * r + 1) * out_itemsize
    return taps_read + coords.numel() * 4 + out_bytes


def k1_bwd_bytes(coords, widths, r, g_itemsize, vol_itemsize):
    """Bytes K1's backward must move for these inputs: every d/dvolume entry
    written once (zeros included), the g taps that land on at least one
    in-range entry (all of a NaN coordinate's), the coordinates."""
    taps = 2 * r + 1
    out_bytes = coords.numel() * sum(widths) * vol_itemsize
    nan = torch.isnan(coords)
    c = coords.nan_to_num(0.0)
    k = torch.arange(taps, device=c.device)
    g_read = 0
    for i, w2 in enumerate(widths):
        x0 = torch.floor((c / 2**i).clamp(-(r + 2), w2 + r + 1) - r) + k
        read = ((x0 >= 0) & (x0 < w2)) | ((x0 + 1 >= 0) & (x0 + 1 < w2)) | nan
        g_read += int(read.sum()) * g_itemsize
    return out_bytes + g_read + coords.numel() * 4


def k2_bound(B, H, W, v_and_h):
    """(bound ms, bound_by) of one bf16 K2 stage: u read and y written once
    (and v read, h written), the taps, the affines and the statistics; the
    conv's multiply-adds at the bf16 tensor-core rate."""
    C = 64
    act = B * H * W * C * 2
    nbytes = 2 * act + C * C * 9 * 2 + 4 * B * C * 4
    if v_and_h:
        nbytes += 2 * act + 2 * B * C * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * H * W * C * C * 9 / PEAK_FLOPS["bfloat16"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_seconds(rec: dict, pattern: str) -> float:
    """Device seconds of the traced kernels whose name matches ``pattern``."""
    return sum(s for name, (s, _) in rec["trace"]["kernels"].items() if re.search(pattern, name))


def roofline(rec: dict, counter: str, pattern: str, seconds_per_launch) -> float | None:
    """Percent of the bound: the launches that the program's ``counter``
    counted in the traced part times the least seconds one launch can take,
    over the device seconds of the kernels matching ``pattern``. None where
    the traced part launched none."""
    trace = rec.get("trace")
    if not trace:
        return None
    n = trace["launches"].get(counter, 0)
    t = kernel_seconds(rec, pattern)
    if not n or t <= 0:
        return None
    return 100.0 * n * seconds_per_launch / t


def kernel_roofline(rec: dict, counter: str, pattern: str) -> float | None:
    """The roofline share of a kernel whose bytes a launch the run measured
    at its own inputs (``rec["launch_bytes"][counter]``, a batch row,
    times ``rec["rows"]`` a launch): over HBM's bandwidth, the least
    seconds a launch can take."""
    per_row = rec.get("launch_bytes", {}).get(counter)
    if per_row is None:
        return None
    return roofline(rec, counter, pattern, per_row * rec["rows"] / HBM_BYTES_PER_S)


def k2_fwd_roofline(rec: dict) -> float | None:
    """The fused feature encoder launches four stages a forward on both
    images, (2B, H, W): three plain and one with the residual stream and
    its emitted copy (``nn/blocks.py::fused_fullres_layer1``)."""
    B, H, W = rec["image"]
    plain, _ = k2_bound(2 * B, H, W, False)
    vh, _ = k2_bound(2 * B, H, W, True)
    return roofline(rec, "encoder_stage", K2_FWD, (3 * plain + vh) / 4 / 1e3)
