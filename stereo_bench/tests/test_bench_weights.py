"""The seeded weights: from the seed alone, non-trivial biases and batch
norm statistics, an alias drawn once, any model of convolutions, linear
layers and norms, and a refusal of a module they do not know."""

import pytest
import torch
from torch import nn

from stereo_bench import harness
from stereo_bench.reference import raft_stereo
from stereo_bench.weights import seeded_state_dict


class Volume(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv3d(4, 8, 3, padding=1)
        self.bn = nn.BatchNorm3d(8)
        self.up = nn.ConvTranspose2d(8, 4, 4, 2, 1)
        self.gn = nn.GroupNorm(2, 4)
        self.head = nn.Linear(4, 1)


def test_draws_come_from_the_seed_and_are_not_trivial():
    cfg = harness.load_json(harness.ROOT, "configs", "raft_stereo_pallas")["model"]
    with torch.device("meta"):
        model = raft_stereo.build(cfg)
    a = seeded_state_dict(model, 7, "cpu", {})
    b = seeded_state_dict(model, 7, "cpu", {})
    c = seeded_state_dict(model, 8, "cpu", {})
    assert set(a) == set(model.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cnet.conv1.weight"], c["cnet.conv1.weight"])
    bias = a["update_block.gru08.convz.bias"]
    fan_in = a["update_block.gru08.convz.weight"][0].numel()
    assert bias.abs().max() <= fan_in ** -0.5 and bias.abs().mean() > 0.2 * fan_in ** -0.5
    var, mean = a["cnet.norm1.running_var"], a["cnet.norm1.running_mean"]
    assert 0.5 <= var.min() and var.max() <= 2.0 and var.std() > 0.2
    assert mean.abs().max() <= 0.25 and mean.abs().mean() > 0.05
    assert (a["cnet.norm1.weight"] - 1).abs().mean() > 0.05
    # norm3 is also downsample.1: one draw under both names
    assert torch.equal(a["cnet.layer2.0.norm3.running_var"],
                       a["cnet.layer2.0.downsample.1.running_var"])


def test_scaled_entries():
    cfg = harness.load_json(harness.ROOT, "configs", "raft_stereo_dkt")
    with torch.device("meta"):
        model = raft_stereo.build(cfg["model"])
    a = seeded_state_dict(model, 7, "cpu", {})
    b = seeded_state_dict(model, 7, "cpu", cfg["init_scale"])
    for key, factor in cfg["init_scale"].items():
        assert torch.allclose(b[key], a[key] * factor)


def test_any_model_of_known_modules():
    model = Volume()
    w = seeded_state_dict(model, 3, "cpu", {})
    assert set(w) == set(model.state_dict())
    model.load_state_dict(w, strict=True)
    assert w["bn.running_var"].min() >= 0.5 and w["up.bias"].abs().max() > 0
    assert w["conv.weight"].std() == pytest.approx((2 / (8 * 27)) ** 0.5, rel=0.15)


def test_unknown_modules_are_refused():
    model = nn.Sequential(nn.Conv2d(3, 4, 1), nn.PReLU())
    with pytest.raises(ValueError, match="1.weight"):
        seeded_state_dict(model, 3, "cpu", {})
