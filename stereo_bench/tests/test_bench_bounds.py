"""The copied bound arithmetic gives the kernels' recorded bytes (PERF.md's
table of kernels); the reference records the coordinates that it is fed
at a cell's own inputs; the trace reduction's interval arithmetic."""

import pytest
import torch

from stereo_bench import bounds, harness, trace
from stereo_bench.reference import raft_stereo
from stereo_bench.weights import seeded_state_dict


def _k1_inputs(gen, shape, widths):
    """chip_smoke.py's K1 inputs: coordinates in [-20, W1 + 20], far out of
    range, negative, integer and last-column ones and three NaN; bf16
    levels."""
    B, H, W1 = shape
    coords = torch.rand((B, H, W1, 1), generator=gen) * (W1 + 40) - 20
    coords.view(-1)[:11] = torch.tensor([-1e9, 1e9, 3e7, -0.5, -1.0, 0.0, 17.0, W1 - 1.0]
                                        + [float("nan")] * 3)
    return coords


@pytest.mark.parametrize("shape,widths,fwd_mb,bwd_mb", [
    ((1, 184, 320), (320, 160, 80, 40), 8.65, 74.69),
    ((8, 80, 180), (180, 90, 45, 22), 16.19, 84.95),
])
def test_k1_bytes(shape, widths, fwd_mb, bwd_mb):
    coords = _k1_inputs(torch.Generator().manual_seed(1), shape, widths)
    fwd = bounds.k1_fwd_bytes(coords, widths, 4, 2, 2)
    bwd = bounds.k1_bwd_bytes(coords, widths, 4, 2, 2)
    # the chip's coordinates came from the card's generator: the in-range
    # count of other draws of the same law differs by ~0.02 MB
    assert fwd / 1e6 == pytest.approx(fwd_mb, abs=0.03)
    assert bwd / 1e6 == pytest.approx(bwd_mb, abs=0.03)


def test_the_reference_records_its_lookups():
    """The bytes a launch are those of the coordinates the reference's
    lookups saw: one record a lookup, K1's backward only with gradients."""
    cfg = harness.load_json(harness.ROOT, "configs", "raft_stereo_pallas")["model"]
    model = raft_stereo.build(cfg)
    w = seeded_state_dict(model, 5, "cpu", {"update_block.flow_head.conv2.weight": 0.02})
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(2)
    a, b = (255 * torch.rand((2, 64, 128, 3), generator=g) for _ in range(2))
    raft_stereo.record([model], True)
    with torch.no_grad():
        raft_stereo.disparity(model, a, b, 3)
    calls = list(model.lookups)
    got = raft_stereo.launch_bytes([model], 2)
    raft_stereo.record([model], False)
    assert len(calls) == 3 and model.lookups is None and "corr_lookup_bwd" not in got
    coords, widths, grad = calls[1]
    assert coords.shape == (2, 16, 32, 1) and widths == [32, 16, 8, 4] and not grad
    want = sum(bounds.k1_fwd_bytes(c, w, 4, 2, 2) for c, w, _ in calls) / 3 / 2
    assert got["corr_lookup"] == pytest.approx(want)
    # every window in range would read more: disparities push some out
    pixels = 16 * 32
    assert got["corr_lookup"] < pixels * (4 * 10 * 2 + 4 + 4 * 9 * 2)


def test_k2_bound():
    ms, by = bounds.k2_bound(2, 736, 1280, False)
    assert ms == pytest.approx(0.1440, abs=5e-5) and by == "bytes"
    assert bounds.k2_bound(2, 736, 1280, True)[0] == pytest.approx(0.2880, abs=5e-5)


def test_rooflines_read_launches_over_kernel_time():
    rec = {"rows": 2, "launch_bytes": {"corr_lookup": 4.0e6}, "image": (1, 736, 1280),
           "trace": {"launches": {"corr_lookup": 32, "encoder_stage": 4, "corr_lookup_bwd": 1},
                     "kernels": {"void corr_lookup_kernel<bf16>(...)": [0.000368, 32],
                                 "void corr_lookup_bwd_kernel<bf16>(...)": [1.0, 1],
                                 "encoder_stage_fwd_kernel<true>": [0.0012, 4]}}}
    per_launch = 2 * 4.0e6 / bounds.HBM_BYTES_PER_S
    k1 = bounds.kernel_roofline(rec, "corr_lookup", bounds.K1_FWD)
    assert k1 == pytest.approx(100 * 32 * per_launch / 0.000368)
    # no bytes measured for the backward: no reading, never a zero
    assert bounds.kernel_roofline(rec, "corr_lookup_bwd", bounds.K1_BWD) is None
    plain, vh = bounds.k2_bound(2, 736, 1280, False)[0], bounds.k2_bound(2, 736, 1280, True)[0]
    assert bounds.k2_fwd_roofline(rec) == pytest.approx(100 * (3 * plain + vh) / 1e3 / 0.0012)
    assert bounds.kernel_roofline({**rec, "trace": None}, "corr_lookup", bounds.K1_FWD) is None


def test_union_and_gaps():
    assert trace._union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    host = [("cudaStreamSynchronize", 0, 10), ("cudaLaunchKernel", 3, 5), ("cudaMemcpyAsync", 3, 4)]
    assert trace._label(host, 3.5) == "cudaMemcpyAsync"
    assert trace._label(host, 20) == "host"


def test_buckets():
    assert bounds.bucket_of("void corr_lookup_bwd_kernel<__nv_bfloat16>") == "K1 bwd"
    assert bounds.bucket_of("void corr_lookup_kernel<__nv_bfloat16>") == "K1"
    assert bounds.bucket_of("anything") == "other elementwise"
