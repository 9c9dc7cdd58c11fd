"""The FLOP count: a hand count on a small conv net, and the cells' stored
counts."""

import pytest
import torch
from torch import nn

from stereo_bench import flops, harness


def test_count_matches_a_hand_count():
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.ReLU(), nn.Conv2d(8, 4, 1))
    x = torch.empty((2, 3, 10, 12), device="meta")
    net = net.to("meta")
    counter = flops.FlopCounterMode(display=False)
    with counter:
        net(x)
    pixels = 2 * 10 * 12
    assert counter.get_total_flops() == 2 * pixels * (8 * 3 * 9 + 4 * 8)
    counter = flops.FlopCounterMode(display=False)
    with counter:
        net(x.requires_grad_()).sum().backward()
    assert counter.get_total_flops() == 3 * 2 * pixels * (8 * 3 * 9 + 4 * 8)


@pytest.mark.parametrize("workload", ["raft_720p_stream", "raft_dkt_b8"])
def test_stored_counts(workload):
    cell = harness.load_json(harness.ROOT, "workloads", workload)
    assert cell["flops_per_unit"] == flops.workload_flops(workload)


def test_a_frame_is_the_known_order():
    # the JAX package's HLO count of a 736x1280 frame at 32 iterations is
    # 10.33 TFLOP; this count leaves out elementwise work
    cell = harness.load_json(harness.ROOT, "workloads", "raft_720p_stream")
    assert 10.0e12 < cell["flops_per_unit"] < 10.5e12
