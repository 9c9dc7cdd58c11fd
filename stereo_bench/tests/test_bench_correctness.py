"""The correctness check fails what it has to fail.

On the CPU at each cell's ``dry`` size (limits read there: the program on
8 seeds, the control on 3): sound runs pass; the control (the reference
one precision below, fp8, in the program's place) fails; each fault that
the cell can have, planted in the program underneath a whole run
(:mod:`stereo_bench.faults`), fails. On the card (``card`` marker) the
control fails at the cell's own size."""

import pytest
import torch

from stereo_bench import faults, harness

FRAME_CELLS = ["raft_720p_stream", "raft_720p_batch4"]
STEP_CELLS = ["raft_dkt_b8", "raft_dkt_booster_b2"]
CELLS = FRAME_CELLS + STEP_CELLS


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_pass(workload):
    out, rec = harness.dry(workload, seed=4, trace=False)
    assert out["correct"], out["checks"]
    assert rec["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    out, _ = harness.dry(workload, seed=102, trace=False, control=True)
    assert not out["correct"], out["checks"]


# the stream's batch is one pair, so it has no half to leave out; an EMA
# teacher left as it was moves nothing that two or three steps can see
# (DKT's decay of 0.99999 moves it below fp32's rounding), PERF.md §6
@pytest.mark.parametrize("workload,fault", [
    *[("raft_720p_stream", f) for f in faults.FRAME_FAULTS if f != "half_batch"],
    *[("raft_720p_batch4", f) for f in faults.FRAME_FAULTS],
    *[(w, f) for w in STEP_CELLS for f in faults.STEP_FAULTS if f != "ema_frozen"],
])
def test_faults_fail(workload, fault):
    with faults.planted(fault):
        out, _ = harness.dry(workload, seed=3, trace=False)
    assert not out["correct"], (fault, out["checks"])


def test_faults_are_removed_after_use():
    from dkt_stereo_tpu_torch.eval import validate
    from dkt_stereo_tpu_torch.train import dkt_step

    before = validate.make_forward_fn, dkt_step.make_dkt_train_step
    with faults.planted("half_batch"):
        assert validate.make_forward_fn is not before[0]
    assert (validate.make_forward_fn, dkt_step.make_dkt_train_step) == before


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3000104729, 3000209458, 3000314187])
def test_the_control_fails_at_full_size(card, workload, seed):
    ctx = harness.Context(workload, seed, 2.0, False, card, control=True)
    rec = ctx.driver.run(ctx)
    assert not all(v <= lim for v, lim in rec["checks"].values()), rec["checks"]
    torch.cuda.empty_cache()
