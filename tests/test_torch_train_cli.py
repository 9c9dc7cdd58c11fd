"""The port's training side on the CPU: checkpoints (save, resume,
``restore_variables``, ``latest_checkpoint``), ``cli.train`` through the
two-stage recipe's semantics (a ``.pth`` start, a mid-run save,
``--auto_resume``, stage 2 with ``--restore_weights_only`` and
``--restore_ckpt_T``), ``cli.export`` into the JAX package's importer,
``--pretrained_backbone`` against the JAX timm importer, ``cli.eval`` and
``cli.demo`` on port checkpoints, and the refusals.

The runs are RAFT ``train.json`` at batch 1, 64 x 128 crops, 2 student and
2 validation iterations, on a Booster tree. The CLI's F&E draws come from a
``torch.Generator`` where the JAX CLI splits a PRNG key, so the two CLIs'
steps are not compared here: the step is held against JAX in
``tests/test_torch_train.py`` and the batches in
``tests/test_torch_data_train.py``.
"""

import argparse
import copy
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dkt_stereo_tpu_torch.cli import train as train_cli
from dkt_stereo_tpu_torch.data import png
from dkt_stereo_tpu_torch.models.registry import create_model
from dkt_stereo_tpu_torch.train.checkpoint import (
    CHECKPOINT_FILE,
    import_timm_mobilenetv2,
    latest_checkpoint,
    restore_checkpoint,
    restore_variables,
    save_checkpoint,
)
from dkt_stereo_tpu_torch.train.dkt_step import create_dkt_state
from dkt_stereo_tpu_torch.train.state import DKTHyperParams
from dkt_stereo_tpu_torch.utils import logging as port_logging

ROOT = Path(__file__).resolve().parents[1]
TRAIN_JSON = ROOT / "configs/raft_stereo/train.json"


def _make_booster(root, rng, scenes=2, H=80, W=144):
    """``tests/test_eval.py::_make_booster``'s Booster tree, made large
    enough for 64 x 128 crops, with two scenes."""
    for s in range(scenes):
        d = root / "Booster_dataset" / "quarter" / "train" / "balanced" / f"scene{s}"
        for cam in ("camera_00", "camera_02"):
            (d / cam).mkdir(parents=True)
            png.write(d / cam / "0000.png", rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        np.save(d / "disp_00.npy", rng.uniform(2, 30, (H, W)).astype(np.float32))
    return root


def _args(data, save_dir, *extra, steps=1):
    return ["--config", str(TRAIN_JSON), "--train_datasets", "booster", "--data_root", str(data),
            "--batch_size", "1", "--num_steps", str(steps), "--image_size", "64", "128",
            "--train_iters", "2", "--valid_iters", "2", "--num_workers", "0", "--lr", "1e-5",
            "--ema_decay", "0.9999", "--tau_pl", "3.0", "--save_dir", str(save_dir), *extra]


def _snapshot(state):
    return {"step": state.step,
            **{w: {k: v.clone() for k, v in getattr(state, w).state_dict().items()}
               for w in ("student", "ema", "teacher")},
            "optimizer": copy.deepcopy(state.optimizer.state_dict())}


def _run(monkeypatch, argv):
    """``cli.train.main(argv, device="cpu")`` with the JSONL writer, and the
    state the first step is handed."""
    seen = []
    make = train_cli.make_dkt_train_step

    def recording(config, hyper):
        step = make(config, hyper)

        def step_fn(state, batch, **kw):
            if not seen:
                seen.append(_snapshot(state))
            return step(state, batch, **kw)

        return step_fn

    monkeypatch.setattr(train_cli, "make_dkt_train_step", recording)
    monkeypatch.setattr(port_logging, "make_writer", port_logging._JsonlWriter)
    return train_cli.main(argv, device="cpu"), seen[0]


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage 1 from a seeded .pth (2 steps, a save after step 1, copied
    aside as it is written: what a run killed after that save leaves), the
    same command with --auto_resume on the copy, and stage 2 (1 step) from
    stage 1's last checkpoint."""
    tmp = tmp_path_factory.mktemp("train")
    data = _make_booster(tmp / "data", np.random.default_rng(3))
    ref = tmp / "ref.pth"
    torch.save(create_model(json.loads(TRAIN_JSON.read_text()), iters=1, device="cpu",
                            seed=0).state_dict(), ref)
    out = {"tmp": tmp, "data": data, "ref": ref}
    with pytest.MonkeyPatch.context() as mp:
        def save_and_copy(save_dir, state, step=None):
            path = save_checkpoint(save_dir, state, step)
            if step is not None:  # the mid-run save
                shutil.copytree(path, tmp / "killed" / Path(path).name)
            return path

        mp.setattr(train_cli, "save_checkpoint", save_and_copy)
        out["s1"], out["s1_first"] = _run(mp, _args(
            data, tmp / "s1", "--restore_ckpt", str(ref), "--validation_frequency", "2"))
        mp.setattr(train_cli, "save_checkpoint", save_checkpoint)
        shutil.copytree(tmp / "killed", tmp / "s1r")
        out["resumed"], out["resumed_first"] = _run(mp, _args(
            data, tmp / "s1r", "--restore_ckpt", str(ref), "--validation_frequency", "2",
            "--auto_resume"))
        out["s2"], out["s2_first"] = _run(mp, _args(
            data, tmp / "s2", "--restore_ckpt", str(tmp / "s1" / "step_2"),
            "--restore_weights_only", "--restore_ckpt_T", str(ref), "--ema_decay", "0.99999",
            "--validation_frequency", "1000", steps=0))
    return out


def _file(path):
    return torch.load(Path(path) / CHECKPOINT_FILE, map_location="cpu", weights_only=True)


def test_stage1_from_a_pth_saves_logs_and_validates(runs):
    """A .pth start sets student = EMA = teacher = the .pth; the run saves
    ``step_2`` after step 1 (``validation_frequency`` 2; the JAX CLI's name)
    and ends at ``step_{num_steps+1}``, the same name; the JSONL log holds the step scalars and the
    Booster validator's keys, the other validators' absent datasets are
    skipped."""
    first, ref = runs["s1_first"], torch.load(runs["ref"], weights_only=True)
    assert first["step"] == 0
    for w in ("student", "ema", "teacher"):
        _same(first[w], ref)
    s1 = runs["tmp"] / "s1"
    assert sorted(p.name for p in s1.iterdir()) == ["metrics.jsonl", "step_2"]
    assert runs["s1"]["checkpoint"] == str(s1 / "step_2")
    assert _file(runs["tmp"] / "killed" / "step_2")["step"] == 1
    assert _file(s1 / "step_2")["step"] == 2
    tags = {json.loads(line)["tag"] for line in (s1 / "metrics.jsonl").read_text().splitlines()}
    assert {"live_loss", "learning_rate", "ema_divergence", "teacher_divergence",
            "Booster-epe", "Booster-d1"} <= tags
    assert set(runs["s1"]["validation"]) == {"Booster-epe", "Booster-d1"}
    timing = runs["s1"]["timing"]
    assert timing["steps"] == 2 and timing["ms_per_step"]["min"] > 0 and "wait_ms" in timing


def test_auto_resume_restores_the_saved_state(runs):
    """``--auto_resume`` restores ``step_2`` bit for bit: the step, the three
    weight sets and the optimizer state (AdamW's step count, the schedule's
    position), and the run ends at ``step_{num_steps+1}``."""
    saved = _file(runs["tmp"] / "killed" / "step_2")
    first = runs["resumed_first"]
    assert first["step"] == saved["step"] == 1
    for w in ("student", "ema", "teacher"):
        _same(first[w], saved[w])
    opt, want = first["optimizer"], saved["optimizer"]
    assert opt["param_groups"] == want["param_groups"] and set(opt["state"]) == set(want["state"])
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(opt["state"][i][k]), torch.as_tensor(v)), (i, k)
    assert runs["resumed"]["checkpoint"].endswith("s1r/step_2")
    assert _file(runs["resumed"]["checkpoint"])["step"] == 2


def test_stage2_restores_weights_only_and_pins_the_teacher(runs):
    """``--restore_weights_only``: step 0, a fresh optimizer, stage 1's
    student and EMA; ``--restore_ckpt_T`` the .pth bit for bit."""
    first, s1 = runs["s2_first"], _file(runs["tmp"] / "s1" / "step_2")
    assert first["step"] == 0 and first["optimizer"]["state"] == {}
    _same(first["student"], s1["student"])
    _same(first["ema"], s1["ema"])
    _same(first["teacher"], torch.load(runs["ref"], weights_only=True))
    assert runs["s2"]["checkpoint"].endswith("s2/step_1")


def test_checkpoint_round_trip_and_restore_variables(runs, tmp_path):
    """A saved state restores bit for bit (step, the three state dicts, the
    optimizer state) into a fresh state, saves again to the same contents;
    ``restore_variables`` returns each weight set, or a .pth's state dict."""
    ckpt = runs["tmp"] / "s1" / "step_2"
    hyper = DKTHyperParams(train_iters=2)
    state = create_dkt_state(json.loads(TRAIN_JSON.read_text()), hyper, seed=None, device="cpu")
    restore_checkpoint(ckpt, state)
    want = _file(ckpt)
    assert state.step == want["step"] == 2
    assert state.applied_steps == int(want["optimizer"]["state"][0]["step"]) > 0
    path = save_checkpoint(tmp_path, state)
    got = _file(path)
    assert Path(path).name == "step_2" and got["step"] == 2
    for w in ("student", "ema", "teacher"):
        _same(got[w], want[w])
        _same(restore_variables(ckpt, w), want[w])
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(got["optimizer"]["state"][i][k]),
                               torch.as_tensor(v))
    # weights only: a fresh optimizer and step stay as they were
    fresh = create_dkt_state(json.loads(TRAIN_JSON.read_text()), hyper, seed=None, device="cpu")
    restore_checkpoint(ckpt, fresh, weights_only=True)
    assert fresh.step == 0 and fresh.optimizer.state_dict()["state"] == {}
    _same(fresh.student.state_dict(), want["student"])
    _same(restore_variables(runs["ref"], "ema"), torch.load(runs["ref"], weights_only=True))
    with pytest.raises(ValueError, match="which="):
        restore_variables(ckpt, "teachers")


def test_latest_checkpoint_ignores_temporary_dirs_and_files(tmp_path):
    """``--auto_resume``'s discovery (``tests/test_dkt.py::test_latest_checkpoint``'s
    case): the newest ``step_N`` directory wins; a save in progress and
    stray files are ignored."""
    assert latest_checkpoint(tmp_path / "missing") is None
    for name in ("step_1", "step_10", "step_2", ".step_11.tmp-123",
                 "step_12.orbax-checkpoint-tmp-5"):
        (tmp_path / name).mkdir()
    (tmp_path / "step_99").write_text("not a dir")
    assert latest_checkpoint(tmp_path).endswith("step_10")


def test_export_loads_into_the_jax_package(runs, tmp_path):
    """``cli.export`` of stage 2's student, with the .pth as template nested
    under ``state_dict`` with DataParallel prefixes: the nesting and the
    prefixes are kept, and the file loads strictly through the JAX package's
    ``import_reference_pth`` into a tree whose ``state_dict_from_flax``
    gives back the same tensors. A .pth as --restore_ckpt, and a template of
    another key set, raise."""
    import jax
    import jax.numpy as jnp

    from dkt_stereo_tpu.models.raft_stereo import RAFTStereo as JRAFTStereo
    from dkt_stereo_tpu.models.raft_stereo import RAFTStereoConfig as JConfig
    from dkt_stereo_tpu.train.checkpoint import import_reference_pth
    from dkt_stereo_tpu_torch.cli.export import main as export_main
    from dkt_stereo_tpu_torch.weights import state_dict_from_flax

    ref = torch.load(runs["ref"], weights_only=True)
    template = tmp_path / "template.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()}, "epoch": 7}, template)
    out = tmp_path / "exported.pth"
    export_main(["--restore_ckpt", runs["s2"]["checkpoint"], "--template", str(template),
                 "--out", str(out)])
    exported = torch.load(out, weights_only=True)
    assert exported["epoch"] == 7
    student = restore_variables(runs["s2"]["checkpoint"], "student")
    assert set(exported["state_dict"]) == {f"module.{k}" for k in student}

    # the JAX model's variable tree, shapes only (the importer reads shapes
    # and dtypes), from one traced init
    cfg = JConfig.from_dict({**json.loads(TRAIN_JSON.read_text()), "corr_implementation": "reg"})
    dummy = jnp.zeros((1, 32, 64, 3), jnp.float32)
    shapes = jax.eval_shape(JRAFTStereo(cfg, iters=1, test_mode=False).init,
                            jax.random.PRNGKey(0), dummy, dummy)
    tree = import_reference_pth(str(out), jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    back = state_dict_from_flax(tree)
    for k, v in exported["state_dict"].items():
        assert torch.equal(back[k.removeprefix("module.")], v), k

    with pytest.raises(SystemExit, match="port checkpoint"):
        export_main(["--restore_ckpt", str(runs["ref"]), "--template", str(template),
                     "--out", str(tmp_path / "x.pth")])
    torch.save({k: v for k, v in ref.items() if k != "fnet.conv2.bias"}, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="fnet.conv2.bias"):
        export_main(["--restore_ckpt", runs["s2"]["checkpoint"], "--template",
                     str(tmp_path / "short.pth"), "--out", str(tmp_path / "x.pth")])


def test_pretrained_backbone_matches_jax(tmp_path):
    """A raw timm ``mobilenetv2_100`` state (``tests/fake_timm.py``, with
    distinctive running statistics), as ``.pth`` and ``.npz``: the IGEV
    trunk ``import_timm_mobilenetv2`` gives equals the JAX importer's trunk
    mapped through ``state_dict_from_flax``, the rest of the model is
    untouched, and ``--pretrained_backbone`` without ``--restore_ckpt`` sets
    it in the student, EMA and teacher. A tensor missing or misshapen
    raises."""
    import jax
    import jax.numpy as jnp

    from dkt_stereo_tpu.nn.mobilenetv2 import MobileNetV2Trunk
    from dkt_stereo_tpu.train.checkpoint import import_timm_mobilenetv2 as jimport
    from dkt_stereo_tpu_torch.weights import state_dict_from_flax
    from tests import fake_timm

    torch.manual_seed(0)
    timm = fake_timm.create_model("mobilenetv2_100", features_only=True).state_dict()
    for k, v in timm.items():
        if k.endswith("running_mean") or k.endswith("weight") and v.dim() == 1:
            timm[k] = torch.randn_like(v)
        elif k.endswith("running_var"):
            timm[k] = torch.rand_like(v) + 0.5
    torch.save(timm, tmp_path / "timm.pth")
    np.savez(tmp_path / "timm.npz", **{k: v.numpy() for k, v in timm.items()})

    shapes = jax.eval_shape(MobileNetV2Trunk().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    template = {c: {"feature": {"trunk": jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes[c])}} for c in ("params", "batch_stats")}
    want = state_dict_from_flax(jimport(str(tmp_path / "timm.pth"), template), igev=True)

    config = json.loads((ROOT / "configs/igev_stereo/train.json").read_text())
    state = create_dkt_state(config, DKTHyperParams(train_iters=1), seed=None, device="cpu")
    before = {k: v.clone() for k, v in state.student.state_dict().items()}
    for src in ("timm.pth", "timm.npz"):
        got = import_timm_mobilenetv2(str(tmp_path / src), state.student)
        for k, v in before.items():
            if k in want and not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], want[k]), (src, k)
            else:
                assert torch.equal(got[k], v), (src, k)
    args = argparse.Namespace(pretrained_backbone=str(tmp_path / "timm.pth"), restore_ckpt=None,
                              auto_resume=False)
    train_cli._restore(args, state)
    for w in ("student", "ema", "teacher"):
        sd = getattr(state, w).state_dict()
        assert torch.equal(sd["feature.block3.1.2.conv_pwl.weight"],
                           want["feature.block3.1.2.conv_pwl.weight"]), w
    with pytest.raises(ValueError, match="missing mobilenetv2 tensors"):
        import_timm_mobilenetv2({k: v for k, v in timm.items() if k != "blocks.5.2.bn3.bias"},
                                state.student)
    bad = dict(timm, **{"conv_stem.weight": torch.zeros(16, 3, 3, 3)})
    with pytest.raises(ValueError, match="manifest"):
        import_timm_mobilenetv2(bad, state.student)


def test_eval_and_demo_read_port_checkpoints(runs, tmp_path):
    """``cli.eval`` and ``cli.demo`` on stage 2's checkpoint with each
    ``--which`` give what they give on a .pth of that weight set."""
    from dkt_stereo_tpu_torch.cli.demo import main as demo_main
    from dkt_stereo_tpu_torch.cli.eval import main as eval_main

    ckpt, data = runs["s2"]["checkpoint"], tmp_path / "one"
    scene = "Booster_dataset/quarter/train/balanced/scene0"
    shutil.copytree(runs["data"] / scene, data / scene)
    base = ["--config", str(TRAIN_JSON), "--valid_iters", "2", "--datasets", "booster-Q",
            "--data_root", str(data)]
    results = {}
    for which in ("student", "ema", "teacher"):
        pth = tmp_path / f"{which}.pth"
        torch.save(restore_variables(ckpt, which), pth)
        ours = eval_main(base + ["--restore_ckpt", ckpt, "--which", which], device="cpu")
        assert ours == eval_main(base + ["--restore_ckpt", str(pth)], device="cpu")
        results[which] = ours["Booster-epe"]
    assert results["student"] != results["teacher"]
    left = str(data / "Booster_dataset/quarter/train/balanced/scene0/camera_00/0000.png")
    demo = ["--config", str(TRAIN_JSON), "--valid_iters", "2", "-l", left, "-r",
            left.replace("camera_00", "camera_02"), "--save_numpy"]
    demo_main(demo + ["--restore_ckpt", ckpt, "--which", "ema", "-o", str(tmp_path / "a")],
              device="cpu")
    demo_main(demo + ["--restore_ckpt", str(tmp_path / "ema.pth"), "-o", str(tmp_path / "b")],
              device="cpu")
    assert np.array_equal(np.load(tmp_path / "a" / "0000.npy"), np.load(tmp_path / "b" / "0000.npy"))


def test_train_cli_refusals(runs, tmp_path, monkeypatch):
    """The JAX CLI's two NeRF-Stereo exits (``loss_func=ns_loss`` without
    ``nerf_stereo`` data; ``nerf_stereo`` data under ``train.json``'s
    ``sequence_loss_raft``); ``--batched_teachers``, once refused, reaches
    the step and runs it; ``--profile_port`` raises by design; a global
    batch that does not split over ``--num_processes``, a
    missing coordinator and a process id out of range raise before any
    process group is joined. A FallingThings JPEG without PIL raises naming the
    file; a JAX package (Orbax) checkpoint given to the eval CLI raises
    pointing at its export CLI; without ``device`` the train CLI wants a
    CUDA device."""
    from dkt_stereo_tpu.train.checkpoint import save_checkpoint as jsave
    from dkt_stereo_tpu_torch.cli.eval import main as eval_main
    from dkt_stereo_tpu_torch.data import datasets

    data, save = runs["data"], tmp_path / "s"
    ns_cfg = tmp_path / "ns.json"
    ns_cfg.write_text(json.dumps({**json.loads(TRAIN_JSON.read_text()), "loss_func": "ns_loss"}))
    argv = _args(data, save)
    with pytest.raises(SystemExit, match="needs trinocular data"):
        train_cli.main(argv[:1] + [str(ns_cfg)] + argv[2:], device="cpu")
    ns_list = tmp_path / "nerf-stereo" / "trainingQ.txt"  # the file list is all it reads
    ns_list.parent.mkdir()
    ns_list.write_text("s/im0.png s/im1.png s/im2.png s/disp.png s/conf.png\n")
    with pytest.raises(SystemExit, match="needs loss_func=ns_loss"):
        train_cli.main(argv + ["--train_datasets", "nerf_stereo", "--data_root", str(tmp_path)],
                       device="cpu")
    make, seen = train_cli.make_dkt_train_step, []
    monkeypatch.setattr(train_cli, "make_dkt_train_step",
                        lambda config, hyper: seen.append(hyper.batched_teachers) or make(config,
                                                                                          hyper))
    monkeypatch.setattr(port_logging, "make_writer", port_logging._JsonlWriter)
    batched = train_cli.main(argv + ["--batched_teachers"], device="cpu")
    monkeypatch.setattr(train_cli, "make_dkt_train_step", make)
    assert seen == [True] and Path(batched["checkpoint"]).exists()
    # --profile_port stays refused by design; the multi-process flags are
    # checked before any process group is joined (the working runs:
    # tests/test_torch_profiling.py, tests/test_torch_parallel.py)
    with pytest.raises(NotImplementedError, match="Not to port, by design"):
        train_cli.main(argv + ["--profile_port", "9012"], device="cpu")
    with pytest.raises(SystemExit, match="must be divisible by --num_processes 2"):
        train_cli.main(argv + ["--num_processes", "2", "--coordinator_address", "localhost:1234",
                               "--process_id", "0"], device="cpu")
    argv2 = [v if v != "1" or argv[i - 1] != "--batch_size" else "2" for i, v in enumerate(argv)]
    for extra, match in ((["--num_processes", "2"], "needs --coordinator_address"),
                         (["--num_processes", "2", "--coordinator_address", "localhost:1234",
                           "--process_id", "2"], "outside")):
        with pytest.raises(ValueError, match=match):
            train_cli.main(argv2 + extra, device="cpu")

    ft = tmp_path / "FallingThings"
    (ft / "scene").mkdir(parents=True)
    for side in ("left", "right"):
        (ft / "scene" / f"0_{side}.jpg").write_bytes(b"\xff\xd8\xff")
    png.write(ft / "scene" / "0_left.depth.png", np.full((8, 8), 3000, np.uint16))
    (ft / "scene" / "_camera_settings.json").write_text(
        json.dumps({"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}))
    (ft / "filenames.txt").write_text("scene/0_left.jpg\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="0_left.jpg"):
        datasets.FallingThings(None, root=str(ft)).get_sample(0)
    monkeypatch.undo()

    orbax = jsave(str(tmp_path / "orbax"), {"w": np.zeros(3, np.float32)}, step=3)
    with pytest.raises(ValueError, match="dkt_stereo_tpu.cli.export"):
        eval_main(["--config", str(TRAIN_JSON), "--restore_ckpt", orbax, "--datasets",
                   "booster-Q", "--data_root", str(data)], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(argv)
