"""The DKT step's batched teachers and ``mix_fmap_image`` training, on the
CPU: K1's plain twin under ``torch.func.vmap`` against its unbatched calls
(the batching rule that folds the teacher axis into the batch), the JAX
package's batched-teacher protocol (tests/test_dkt.py:322) on the port's
step, and one whole step with both options against the JAX step.
"""

import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.models import RAFTStereo as JRAFTStereo
from dkt_stereo_tpu.models import raft_stereo as jraft_module
from dkt_stereo_tpu_torch.nn.norms import FrozenBatchNorm2d
from dkt_stereo_tpu_torch.nn.precision import batch_norm_fp32, policy_mismatches
from dkt_stereo_tpu_torch.ops.cuda.corr_lookup import corr_lookup
from dkt_stereo_tpu_torch.train.dkt_step import (
    batched_teachers, create_dkt_state, make_dkt_train_step)
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from tests.test_torch_gwcnet import draw_variables
from tests.test_torch_train import _check_step_against_jax, _jax_cfg

ROOT = Path(__file__).resolve().parents[1]
TRAIN = json.loads((ROOT / "configs/raft_stereo/train.json").read_text())
FP32 = {"mixed_precision": False, "corr_dtype": "float32"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coords_mapped", [True, False])
def test_k1_plain_twin_batches_bit_for_bit(dtype, coords_mapped):
    """``corr_lookup`` under ``vmap`` over two slots (levels always mapped,
    coordinates mapped or shared, as in a teacher's first iteration) equals
    its calls slot by slot, bit for bit, in the output's dtype; the mapped
    axis comes out first."""
    g = torch.Generator().manual_seed(0)
    T, B, H, W = 2, 2, 3, 37
    levels = [torch.randn(T, B, H, W, W >> i, generator=g).to(dtype) for i in range(4)]
    coords = torch.rand(T, B, H, W, 1, generator=g) * (W + 8) - 4
    coords[0, 1, 2, 5] = float("nan")
    c_dim = 0 if coords_mapped else None
    c = coords if coords_mapped else coords[0]
    with torch.no_grad():
        got = torch.func.vmap(lambda c, *lv: corr_lookup(lv, c, 4, dtype),
                              in_dims=(c_dim, *[0] * 4))(c, *levels)
        want = torch.stack([corr_lookup([lv[t] for lv in levels],
                                        coords[t] if coords_mapped else c, 4, dtype)
                            for t in range(T)])
    assert got.shape == want.shape == (T, B, 36, H, W) and got.dtype == dtype
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    assert bool(got[0, 1, :, 2, 5].isnan().all())


def _batch(rng, B=1, H=32, W=64):
    """A batch whose GT spans [-60, 60] px, so that some of it lies within
    F&E's 3 px of a random teacher's disparity and the GT loss is not
    empty."""
    batch = {k: rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
             for k in ("img1", "img2", "img1_clean", "img2_clean")}
    batch["flow"] = rng.uniform(-60, 60, (B, H, W)).astype(np.float32)
    batch["valid"] = np.ones((B, H, W), np.float32)
    return batch


def test_batched_teachers_protocol():
    """tests/test_dkt.py:322's protocol on the port (RAFT with instance-norm
    context, fp32, 1x32x64, 2 + 2 iterations): (a) with teacher and EMA
    weights equal the two slots are bit-identical, and (b) the batched
    step's loss is within 1e-3 relative of the unbatched step's and every
    updated weight within 2.5 x the first AdamW move (lr0 = lr / 25): the
    grouped convolutions of the batched forward sum in another order."""
    config = {**TRAIN, **FP32, "context_norm": "instance", "remat_iters": False}
    hyper = dict(train_iters=2, teacher_iters=2, num_steps=100)
    batch = {k: torch.tensor(v) for k, v in _batch(np.random.default_rng(0)).items()}
    draws = {"filter_gt": torch.tensor([0.3]), "ensemble_gt": torch.tensor(0.6),
             "ensemble_pl": torch.tensor(0.2)}
    seq_hyper, bat_hyper = DKTHyperParams(**hyper), DKTHyperParams(**hyper, batched_teachers=True)
    states = [create_dkt_state(config, h, seed=0, device="cpu") for h in (seq_hyper, bat_hyper)]
    with torch.no_grad():
        d_pl, d_ema = batched_teachers(config, bat_hyper)(
            states[1].teacher, states[1].ema, batch["img1_clean"], batch["img2_clean"])
        _, d_seq = states[1].teacher(batch["img1_clean"], batch["img2_clean"])
    assert d_pl.shape == (1, 32, 64) and torch.equal(d_pl, d_ema)
    assert float((d_pl - d_seq).abs().max()) <= 1e-3 * float(d_seq.abs().max())

    out = [make_dkt_train_step(config, h)(s, batch, draws=draws)
           for h, s in zip((seq_hyper, bat_hyper), states)]
    (s_seq, m_seq), (s_bat, m_bat) = out
    assert m_bat["ok"] == m_seq["ok"] == 1.0 and m_bat["loss_PL"] > 0
    assert m_bat["loss"] == pytest.approx(m_seq["loss"], rel=1e-3)
    lr0 = seq_hyper.lr / 25.0
    for (k, a), b in zip(s_bat.student.named_parameters(), s_seq.student.parameters()):
        assert float((a - b).detach().abs().max()) < 2.5 * lr0, k


def test_autocast_policy_matches_cpu_autocast():
    """The op-by-op policy that stands in for autocast under ``vmap``
    (``nn/precision.py``) gives each listed op the dtype and the values that
    ``torch.autocast("cpu")`` gives it (``chip_smoke.py`` phase 44 holds the
    CUDA lists so)."""
    assert policy_mismatches("cpu") == {}


def _module_outputs(model: torch.nn.Module, call, slot=None):
    """``[(module name, output)]`` in the order ``call()`` ran the modules
    of ``model``; under ``vmap`` (``slot`` given) each output is that slot
    of the mapped tensor. The first tensor of a tuple or list output."""
    seen = []

    def hook(name):
        def record(module, args, out):
            while isinstance(out, (tuple, list)):
                out = out[0]
            if not isinstance(out, torch.Tensor):
                return
            if slot is not None:
                dim = torch._C._functorch.maybe_get_bdim(out)
                out = torch._C._functorch.get_unwrapped(out).movedim(dim, 0)[slot]
            seen.append((name, out.detach().clone()))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return seen


def _bn_fp32(bn, x):
    """Frozen batch norm as the policy runs it on bf16 activations."""
    return batch_norm_fp32(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)


@pytest.mark.parametrize("context_norm", ["instance", "batch"])
def test_batched_bf16_teachers_match_autocast(context_norm, monkeypatch):
    """train.json's mixed precision (RAFT, 3 GRU levels, 1x32x64, 2
    iterations), the EMA's weights the teacher's times 1 + 0.02 N(0, 1) and
    every frozen BN's statistics and affine random: each slot of the batched
    teachers against its model's own forward under ``torch.autocast``,
    module by module in the order they ran, every output bit-identical and
    of the same dtype, the disparities too. The mapped batch norm of bf16
    activations is its affine map written out in fp32
    (``nn/precision.py::batch_norm_fp32``), which can round a value
    otherwise than the native kernel of the unbatched forward; so
    (batch-norm context) each native batch norm of the unbatched forwards is
    first held within one bf16 step of its largest value of the written-out
    map's output, and the unbatched forwards then run with that map."""
    config = {**TRAIN, "context_norm": context_norm, "remat_iters": False}
    hyper = DKTHyperParams(train_iters=2, teacher_iters=2, num_steps=100, batched_teachers=True)
    state = create_dkt_state(config, hyper, seed=0, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for model in (state.teacher, state.ema):
            for name, b in model.named_buffers():
                if name.endswith("running_mean"):
                    b.copy_(0.1 * torch.randn(b.shape, generator=g))
                elif name.endswith("running_var"):
                    b.copy_(0.5 + torch.rand(b.shape, generator=g))
            for name, p in model.named_parameters():
                if model is state.ema or ".norm" in name:
                    p.mul_(1 + 0.02 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(6)
    img1, img2 = (torch.tensor(rng.uniform(0, 255, (1, 32, 64, 3)).astype(np.float32))
                  for _ in range(2))
    fn = batched_teachers(config, hyper)
    with torch.no_grad():
        d_pl, d_ema = fn(state.teacher, state.ema, img1, img2)
        steps = []

        def native_vs_copy(bn, args, out):
            want = _bn_fp32(bn, args[0])
            steps.append(float((out.float() - want.float()).abs().max()) /
                         float(want.abs().max()))

        bns = [m for model in (state.teacher, state.ema) for m in model.modules()
               if isinstance(m, FrozenBatchNorm2d)]
        handles = [m.register_forward_hook(native_vs_copy) for m in bns]
        for model in (state.teacher, state.ema):
            model(img1, img2)
        for h in handles:
            h.remove()
        assert len(steps) == len(bns) and (len(bns) > 0) == (context_norm == "batch")
        assert max(steps, default=0.0) <= 2**-7

        monkeypatch.setattr(FrozenBatchNorm2d, "forward", _bn_fp32)
        for slot, model, disp in ((0, state.teacher, d_pl), (1, state.ema, d_ema)):
            want = _module_outputs(model, lambda: model(img1, img2))
            got = _module_outputs(fn.model, lambda: fn(state.teacher, state.ema, img1, img2),
                                  slot)
            assert [n for n, _ in got] == [n for n, _ in want]
            assert [t.dtype for _, t in got] == [t.dtype for _, t in want]
            first = next((k for k, ((_, a), (_, b)) in enumerate(zip(got, want))
                          if not torch.equal(a, b)), None)
            assert first is None, got[first][0]
            assert torch.equal(disp, model(img1, img2)[1])


def record_jax_mix_draws(monkeypatch) -> list:
    """Has the JAX RAFT model's module see ``jax`` with a uniform that
    appends each value it draws (the ``mix`` blend weight) to the returned
    list as the computation runs."""
    seen = []

    def recorded(*args, **kw):
        u = jax.random.uniform(*args, **kw)
        jax.debug.callback(lambda x: seen.append(float(x)), u)
        return u

    class _Jax:
        random = types.SimpleNamespace(uniform=recorded)

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(jraft_module, "jax", _Jax())
    return seen


@pytest.fixture(scope="module")
def narrow_variables():
    """Student and teacher variables of train.json at hidden 32, fp32, the
    teacher's parameters the student's times 1 + 0.02 N(0, 1), so that the
    teachers agree at some pixels and the pseudo-label loss is not empty."""
    rng = np.random.default_rng(3)
    model = JRAFTStereo(_jax_cfg(hidden_dims=(32, 32, 32)), iters=2, test_mode=False)
    dummy = np.zeros((1, 32, 64, 3), np.float32)
    student = draw_variables(model, rng, dummy, dummy)
    teacher = {"params": jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.02 * rng.standard_normal(a.shape))).astype(np.float32),
        student["params"]), "batch_stats": student["batch_stats"]}
    return [student, teacher]


def test_batched_mix_step_matches_jax(narrow_variables, monkeypatch):
    """One DKT step with ``batched_teachers`` and ``mix_fmap_image`` against
    the JAX step from the same weights, batch and draws: the teachers as one
    vmapped forward (cosine in test mode) on both sides, the student's blend
    weight the one the JAX model draws from the step's ``mix`` key (read
    back from the JAX model's draw), the bounds of
    tests/test_torch_train.py::test_dkt_step_matches_jax, except that 99 %
    of the updated elements (not 99.9 %) lie within 1e-2*lr: at hidden 32
    more gradient elements sit near 0, and Adam's first step turns each one
    whose sign fp32 reordering flips into a 2*lr move (measured 99.55 %;
    99.85 % without either option; tests/test_torch_ns.py holds its narrow
    RAFT to 99 % for the same reason)."""
    seen = record_jax_mix_draws(monkeypatch)
    mix = {"hidden_dims": (32, 32, 32), "corr_implementation": "mix_fmap_image"}

    def more_draws():
        assert len(seen) == 1 and 0 < seen[0] < 1
        return {"mix": torch.tensor(seen[0])}

    _check_step_against_jax(
        narrow_variables, _batch(np.random.default_rng(4)),
        dict(train_iters=2, teacher_iters=2, num_steps=100, batched_teachers=True),
        jax.random.PRNGKey(3), config={**TRAIN, **FP32, **mix, "hidden_dims": [32, 32, 32]},
        more_draws=more_draws, share=0.99, jcfg=_jax_cfg(**mix))
