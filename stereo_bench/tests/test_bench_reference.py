"""The plain reference against the port on the CPU at a tiny size, both in
fp32: the test-mode forward, the train-mode forward, and three DKT steps by
the checks the benchmark makes."""

import json

import pytest
import torch

from stereo_bench import harness
from stereo_bench.drivers import dkt_step as driver
from stereo_bench.reference import raft_stereo
from stereo_bench.reference.raft_stereo import RAFTStereo
from stereo_bench.weights import seeded_state_dict


def _config(name):
    cfg = harness.load_json(harness.ROOT, "configs", name)
    return {**cfg["model"], "mixed_precision": False}


def _weights(model_config, seed):
    with torch.device("meta"):
        shapes = RAFTStereo(model_config)
    return seeded_state_dict(shapes, seed, "cpu", {"update_block.flow_head.conv2.weight": 0.02})


def _images(seed, B=1, H=64, W=128):
    g = torch.Generator().manual_seed(seed)
    return [255 * torch.rand((B, H, W, 3), generator=g) for _ in range(2)]


@pytest.mark.parametrize("config", ["raft_stereo_pallas", "raft_stereo_dkt"])
def test_test_mode_forward_matches_the_port(config):
    from dkt_stereo_tpu_torch.models.registry import create_model

    model_config = _config(config)
    w = _weights(model_config, 11)
    ref = RAFTStereo(model_config)
    ref.load_state_dict(w)
    port = create_model(model_config, iters=4, device="cpu")
    port.load_state_dict(w, strict=True)
    a, b = _images(1)
    with torch.no_grad():
        want = ref(a, b, 4)
        got = port(a, b)
    assert want[1].abs().max() > 0.5
    assert (got[1] - want[1]).abs().max() < 1e-4
    assert (got[0] - want[0]).abs().max() < 1e-4


def test_train_mode_forward_matches_the_port():
    from dkt_stereo_tpu_torch.models.registry import create_model

    model_config = _config("raft_stereo_dkt")
    w = _weights(model_config, 12)
    ref = RAFTStereo(model_config)
    ref.load_state_dict(w)
    port = create_model(model_config, iters=3, device="cpu", test_mode=False)
    port.load_state_dict(w, strict=True)
    a, b = _images(2, B=2)
    want = ref(a, b, 3, test_mode=False, remat=True)
    got = port(a, b)["disp_preds"]
    assert got.shape == want.shape == (3, 2, 64, 128)
    assert (got - want).abs().max() < 1e-4


def test_three_dkt_steps_match_the_port():
    config = {"model": _config("raft_stereo_dkt"), "train_iters": 2, "teacher_iters": 3}
    w = _weights(config["model"], 13)
    cell = harness.load_json(harness.ROOT, "workloads", "raft_dkt_b8")
    g = torch.Generator().manual_seed(5)
    batches = [driver.make_batch(g, 2, 64, 128, "cpu", cell["labels"], cell["augment"])
               for _ in range(3)]
    draws = [driver.make_draws(g, 2, "cpu") for _ in range(3)]
    got, ok = driver.first_steps(driver.Program(config, w, torch.device("cpu")), w, batches,
                                 draws)
    want, ok_ref = driver.first_steps(
        driver.Reference(raft_stereo, {**config, "precision": "float32"}, w, "cpu", "fp32"), w,
        batches, draws)
    assert ok and ok_ref
    checks = driver.checks(got, want, {"loss_gap": 0, "grad_gap": 0, "change_gap": 0})
    assert checks["loss_gap"][0] < 1e-5, json.dumps(checks)
    assert checks["grad_gap"][0] < 1e-3, json.dumps(checks)
    assert checks["change_gap"][0] < 1e-2, json.dumps(checks)
