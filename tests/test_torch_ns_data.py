"""The port's NeRF-Stereo data side on the CPU, without a JAX compile:
``data/imgproc.py``'s numpy forms of OpenCV's operations against ``cv2``,
``TripletFlowAugmentor`` and ``NerfStereo`` against the JAX classes with
equal generators, ``collate_mixed``, ``split_modalities`` and
``MixedStereoLoader`` against the JAX package's, and ``cli.train`` on a
tiny ``ns.json`` over a triplet tree, alone and mixed with a binocular
dataset."""

import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dkt_stereo_tpu.data import loader as jloader
from dkt_stereo_tpu.data import triplet as jtriplet
from dkt_stereo_tpu_torch.cli import train as train_cli
from dkt_stereo_tpu_torch.data import augmentor, imgproc, png, triplet
from dkt_stereo_tpu_torch.data.datasets import fetch_dataset
from dkt_stereo_tpu_torch.data.loader import MixedStereoLoader
from dkt_stereo_tpu_torch.train.checkpoint import CHECKPOINT_FILE
from dkt_stereo_tpu_torch.utils import logging as port_logging

ROOT = Path(__file__).resolve().parents[1]
NS = json.loads((ROOT / "configs/raft_stereo/ns.json").read_text())
TINY = {**NS, "mixed_precision": False, "corr_dtype": "float32", "corr_levels": 2,
        "corr_radius": 2, "n_gru_layers": 1, "hidden_dims": [16, 16, 16]}


# --- OpenCV's operations -------------------------------------------------------------------------


def test_warp_affine_matches_cv2():
    """``cv2.warpAffine(INTER_LINEAR)`` with a zero border, as the triplet
    augmentor calls it (a rotation from ``getRotationMatrix2D`` about a
    random centre, then a y translation from a float32 matrix), plus larger
    angles and the identity, on 1- and 3-channel uint8 at widths with and
    without a scalar tail (W % 16): bit for bit (measured: every value over
    ~4.6 M)."""
    rng = np.random.default_rng(5)
    for i in range(18):
        H, W, C = int(rng.integers(4, 160)), int(rng.integers(4, 260)), (1, 3, 3)[i % 3]
        if i < 2:
            W = 16 * int(rng.integers(1, 12))  # no tail
        img = rng.integers(0, 256, (H, W, C) if C > 1 else (H, W), dtype=np.uint8)
        center = (rng.uniform(0, H), rng.uniform(0, W))
        angle = rng.uniform(-0.1, 0.1) if i % 2 else rng.uniform(-30, 30)
        rot = cv2.getRotationMatrix2D(center, angle, 1.0)
        assert np.array_equal(imgproc.rotation_matrix(center, angle, 1.0), rot)
        trans = np.float32([[1, 0, 0], [0, 1, rng.uniform(-3, 3)]])
        ident = cv2.getRotationMatrix2D(center, 0.0, 1.0)
        for m in (rot, trans, ident):
            want = cv2.warpAffine(img, m, (W, H), flags=cv2.INTER_LINEAR)
            assert np.array_equal(imgproc.warp_affine_linear(img, m), want), (i, H, W, C)


def test_resize_nearest_matches_cv2():
    """``cv2.resize(INTER_NEAREST)`` in the ``fx``/``fy`` form (the
    augmentor's disparity and confidence, float32) and the ``dsize`` form
    (``NerfStereo``'s ``scale``, uint8 images too), at random sizes and
    scales, the identity and exact ratios included: bit for bit."""
    rng = np.random.default_rng(6)
    for i in range(30):
        H, W = int(rng.integers(3, 150)), int(rng.integers(3, 220))
        a = rng.uniform(0, 100, (H, W)).astype(np.float32)
        fx, fy = (float(2 ** rng.uniform(-0.5, 1.0)) for _ in range(2))
        if i % 5 == 0:
            fx = fy = float(rng.choice([1.0, 0.5, 1.25, 2.0, 0.75]))
        want = cv2.resize(a, None, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST)
        got = imgproc.resize_nearest(a, fx=fx, fy=fy)
        assert got.dtype == want.dtype and np.array_equal(got, want), (H, W, fx, fy)
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        size = (int(rng.integers(2, 200)), int(rng.integers(2, 150)))
        want = cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(imgproc.resize_nearest(img, size), want), (H, W, size)


def test_bgr_to_gray_and_six_channel_resize_match_cv2():
    """``cvtColor(BGR2GRAY)`` on every value of each channel and on random
    images; ``augmentor._resize_linear`` on the augmentor's 6-channel
    (clean, augmented) stacks at the triplet augmentor's scales: bit for
    bit."""
    rng = np.random.default_rng(7)
    ramp = np.stack(np.meshgrid(np.arange(256), np.arange(256)), -1).astype(np.uint8)
    for img in (np.concatenate([ramp, ramp[..., :1]], -1), ramp[..., [1, 0, 1]],
                rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)):
        img = np.ascontiguousarray(img)
        assert np.array_equal(imgproc.bgr_to_gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    for _ in range(12):
        H, W = int(rng.integers(9, 120)), int(rng.integers(9, 160))
        img = rng.integers(0, 256, (H, W, 6), dtype=np.uint8)
        fx = float(2 ** rng.uniform(-0.2, 0.5))
        fy = fx * float(2 ** rng.uniform(-0.2, 0.2))
        want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(augmentor._resize_linear(img, fx, fy), want), (H, W, fx, fy)


# --- the triplet dataset -------------------------------------------------------------------------


def _make_ns_tree(root, rng, scenes=4, H=200, W=280, disp_px=20.0):
    """A NeRF-Stereo tree in the reference's layout (core/stereo_datasets.py
    :374-401): 8-bit image triplets, 16-bit disparity (x 64) and confidence
    (x 65536) maps, and ``trainingQ.txt``."""
    base = root / "nerf-stereo"
    lines = []
    for s in range(scenes):
        d = base / "training_set" / f"scene{s}"
        d.mkdir(parents=True)
        for name in ("im0", "im1", "im2"):
            png.write(d / f"{name}.png", rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        disp = disp_px + rng.uniform(-0.5 * disp_px, 0.5 * disp_px, (H, W))
        png.write(d / "disp.png", (disp * 64.0).astype(np.uint16))
        png.write(d / "conf.png", (rng.uniform(0.2, 1.0, (H, W)) * 65536.0).clip(0, 65535)
                  .astype(np.uint16))
        lines.append(" ".join(f"scene{s}/{n}.png" for n in ("im0", "im1", "im2", "disp",
                                                          "conf")))
    (base / "trainingQ.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def ns_tree(tmp_path_factory):
    return _make_ns_tree(tmp_path_factory.mktemp("ns"), np.random.default_rng(2))


def _same(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_triplet_augmentor_matches_jax():
    """``TripletFlowAugmentor`` against the JAX class, the same generator
    seed each, over 24 seeds, which draw the augmentor's random branches
    (asymmetric colour, stretch, flips, the rotation's binomial draw, the
    eraser at a crop larger than twice its half size; grayscale at least
    once): every output bit for bit."""
    rng = np.random.default_rng(3)
    ims = [rng.integers(0, 256, (200, 280, 3), dtype=np.uint8) for _ in range(3)]
    gt = rng.uniform(2, 40, (200, 280)).astype(np.float32)
    conf = rng.uniform(0, 1, (200, 280)).astype(np.float32)
    kw = dict(crop_size=(160, 224), min_scale=-0.2, max_scale=0.5, do_flip=True)
    gray = 0
    for seed in range(24):
        ours = triplet.TripletFlowAugmentor(**kw, rng=np.random.default_rng(seed))(
            *ims, gt, conf)
        theirs = jtriplet.TripletFlowAugmentor(**kw, rng=np.random.default_rng(seed))(
            *ims, gt, conf)
        _same(ours, theirs)
        a = ours["im2_aug"]
        gray += int((a[..., 0] == a[..., 1]).all() and (a[..., 1] == a[..., 2]).all())
    assert gray >= 1


def test_nerf_stereo_samples_match_jax(ns_tree):
    """``fetch_dataset(["nerf_stereo"])`` (the NS augmentor's parameters and
    the CLI's thresholds) and ``NerfStereo.get_sample`` against the JAX
    package on a tree of 16-bit PNG maps, and ``scale=2``'s nearest
    downscale: equal samples (float32, negative flow)."""
    from dkt_stereo_tpu.data.datasets import fetch_dataset as jfetch

    kw = dict(data_root=str(ns_tree), conf_threshold=0.7, disp_threshold=400.0)
    ours, theirs = fetch_dataset(["nerf_stereo"], (96, 128), **kw), jfetch(
        ["nerf_stereo"], (96, 128), **kw)
    assert isinstance(ours, triplet.NerfStereo) and len(ours) == len(theirs) == 4
    assert ours.image_list == theirs.image_list
    assert (ours.conf_threshold, ours.disp_threshold) == (0.7, 400.0)
    aug = ours.augmentor
    assert (aug.crop_size, aug.min_scale, aug.max_scale, aug.do_flip) == ((96, 128), -0.2, 0.5,
                                                                          True)
    for i in range(4):
        s = ours.get_sample(i, np.random.default_rng(i))
        _same(s, theirs.get_sample(i, np.random.default_rng(i)))
        assert s["im1_forward"].shape == (96, 128, 3) and (s["flow"] <= 0).all()
    args = (str(ns_tree / "nerf-stereo" / "training_set"),
            str(ns_tree / "nerf-stereo" / "trainingQ.txt"))
    half = {"aug_params": {"crop_size": (64, 96)}, "scale": 2}
    _same(triplet.NerfStereo(*args, **half).get_sample(1, np.random.default_rng(9)),
          jtriplet.NerfStereo(*args, **half).get_sample(1, np.random.default_rng(9)))


# --- collate and the mixed loader ----------------------------------------------------------------


class _Bi:
    """A binocular pool whose samples draw from the generator they get."""

    def __init__(self, n, H=8, W=12):
        self.n, self.H, self.W = n, H, W

    def __len__(self):
        return self.n

    def get_sample(self, i, rng=None):
        u = rng.uniform(0, 1, (self.H, self.W)).astype(np.float32)
        z = np.full((self.H, self.W, 3), float(i), np.float32) + u[..., None]
        return {"img1": z, "img2": z + 1, "img1_clean": z, "img2_clean": z + 1,
                "flow": -u, "valid": (u > 0.5).astype(np.float32)}


class _Tri(_Bi):
    def get_sample(self, i, rng=None):
        u = rng.uniform(0, 1, (self.H, self.W)).astype(np.float32)
        z = np.full((self.H, self.W, 3), 100.0 + i, np.float32) + u[..., None]
        return {"im1_forward": z, "im2_forward": z + 1, "flow": -3 * u, "conf": u,
                "im0": z, "im1": z + 1, "im2": z + 2}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_collate_mixed_and_split_modalities_match_jax(ns_tree):
    """``collate_mixed``'s nested batch (binocular rows first) of CPU
    tensors equals the JAX collate's arrays, mixed and trinocular only;
    ``split_modalities`` partitions a mixed composition as JAX's does."""
    from dkt_stereo_tpu.data.datasets import fetch_dataset as jfetch

    rng = np.random.default_rng(0)
    bi = [_Bi(4).get_sample(i, rng) for i in range(3)]
    tri = [_Tri(4).get_sample(i, rng) for i in range(2)]
    for samples in (bi + tri, tri):
        ours, nb, nt = triplet.collate_mixed(samples)
        theirs, jnb, jnt = jtriplet.collate_mixed(samples)
        assert (nb, nt) == (jnb, jnt)
        assert isinstance(ours["im1_forward"], torch.Tensor)
        flat = _numpy(ours)
        assert set(flat) == set(theirs) and set(flat["bi"]) == set(theirs["bi"])
        for k in ("im1_forward", "im2_forward"):
            assert np.array_equal(flat[k], theirs[k])
        for part in ("bi", "tri"):
            for k in theirs[part]:
                assert np.array_equal(flat[part][k], theirs[part][k]), (part, k)

    (ns_tree / "Booster_dataset").mkdir(exist_ok=True)
    kw = dict(data_root=str(ns_tree))
    for names in (["nerf_stereo"], ["nerf_stereo", "booster"], ["booster", "nerf_stereo"]):
        ours, theirs = fetch_dataset(names, (64, 96), **kw), jfetch(names, (64, 96), **kw)
        (obi, otri), (jbi, jtri) = triplet.split_modalities(ours), jtriplet.split_modalities(theirs)
        assert (obi is None) == (jbi is None) and (otri is None) == (jtri is None)
        assert type(otri).__name__ == type(jtri).__name__ == "NerfStereo"
        assert otri.image_list == jtri.image_list


@pytest.mark.parametrize("n_bi,n_tri,batch,num_tri",
                         [(12, 6, 6, 2), (12, 6, 6, None), (0, 7, 3, None), (9, 0, 4, None),
                          (5, 40, 8, None), (40, 5, 8, None), (10, 10, 4, 4), (10, 10, 4, 0)])
def test_mixed_loader_split_length_and_indices_match_jax(n_bi, n_tri, batch, num_tri):
    """``MixedStereoLoader``'s split (``num_tri`` or proportional, clipped
    to [1, B - 1]), its length (the scarcer pool) and each epoch's index
    order against the JAX loader's, for several pool sizes, batch sizes and
    ``num_tri``; the batches of an epoch (``num_workers=0``) equal JAX's
    collate of the samples drawn with ``default_rng((seed, epoch, 0,
    b))``."""
    bi, tri = (_Bi(n_bi) if n_bi else None), (_Tri(n_tri) if n_tri else None)
    ours = MixedStereoLoader(bi, tri, batch_size=batch, num_tri=num_tri, num_workers=0, seed=5)
    theirs = jloader.MixedStereoLoader(bi, tri, batch_size=batch, num_tri=num_tri,
                                       num_workers=1, seed=5)
    assert (ours.nb, ours.nt) == (theirs.nb, theirs.nt)
    assert len(ours) == len(theirs) > 0
    for e in range(3):
        theirs.epoch = e
        assert np.array_equal(ours.epoch_indices(e), theirs._epoch_indices()), e
    view = jloader._MixedView(bi, tri)
    for b, got in enumerate(ours):
        chunk = ours.epoch_indices(0)[b * batch:(b + 1) * batch]
        rng = np.random.default_rng((5, 0, 0, b))
        want = jtriplet.collate_mixed([view.get_sample(int(i), rng) for i in chunk])[0]
        flat = _numpy(got)
        for k in ("im1_forward", "im2_forward"):
            assert np.array_equal(flat[k], want[k])
        for part in ("bi", "tri"):
            assert set(flat[part]) == set(want[part])
            for k in want[part]:
                assert np.array_equal(flat[part][k], want[part][k]), (b, part, k)
    assert ours.epoch == 1


def test_mixed_loader_refusals_match_jax():
    """The JAX loader's errors: ``num_tri`` outside [0, B] and a split that
    draws from an empty pool."""
    for bi, tri, kw in ((_Bi(4), _Tri(4), {"num_tri": 5}), (None, _Tri(6), {"num_tri": 2}),
                        (_Bi(6), None, {"num_tri": 1})):
        for cls in (MixedStereoLoader, jloader.MixedStereoLoader):
            with pytest.raises(ValueError, match="outside|empty pool"):
                cls(bi, tri, batch_size=4, num_workers=0 if cls is MixedStereoLoader else 1,
                    **kw)


# --- cli.train on ns.json ------------------------------------------------------------------------


def _losses(save_dir, tag):
    rows = [json.loads(line) for line in (save_dir / "metrics.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == tag]


def test_ns_train_cli_end_to_end(tmp_path, monkeypatch):
    """``cli.train.main(..., device="cpu")`` on ``ns.json`` cut to the JAX
    test's tiny RAFT (tests/test_ns_train.py:272) over 8 triplets: 16 steps
    at batch 8 on ``nerf_stereo`` alone, where the NS step's loss falls (the
    mean of the last 4 below the first 4's, as the JAX test requires) and
    a checkpoint lands; then 2 steps of ``nerf_stereo`` mixed with a
    binocular dataset at ``--ns_num_tri 4`` (batches of 4 + 4)."""
    monkeypatch.setattr(port_logging, "make_writer", port_logging._JsonlWriter)
    data = _make_ns_tree(tmp_path / "data", np.random.default_rng(1), scenes=8, H=48, W=64,
                         disp_px=4.0)
    cfg = tmp_path / "ns_tiny.json"
    cfg.write_text(json.dumps(TINY))
    base = ["--config", str(cfg), "--data_root", str(data), "--batch_size", "8",
            "--image_size", "32", "48", "--train_iters", "2", "--valid_iters", "2",
            "--num_workers", "0", "--validation_frequency", "10000", "--lr", "1e-3"]
    save = tmp_path / "run"
    out = train_cli.main(base + ["--train_datasets", "nerf_stereo", "--num_steps", "16",
                                 "--save_dir", str(save)], device="cpu")
    assert Path(out["checkpoint"]).name == "step_17"
    assert (Path(out["checkpoint"]) / CHECKPOINT_FILE).exists()
    losses = _losses(save, "live_loss")
    assert len(losses) == 17 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses

    # a binocular pool beside the triplets: KITTI-2015's layout, 8 pairs
    kitti = data / "KITTI" / "KITTI_2015" / "training"
    rng = np.random.default_rng(4)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        (kitti / sub).mkdir(parents=True)
    for i in range(8):
        for sub in ("image_2", "image_3"):
            png.write(kitti / sub / f"{i:06d}_10.png",
                      rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        png.write(kitti / "disp_occ_0" / f"{i:06d}_10.png",
                  (rng.uniform(1, 8, (48, 64)) * 256).astype(np.uint16))
    mixed = tmp_path / "mixed"
    seen = []
    make = train_cli.make_ns_train_step

    def recording(config, hyper, **kw):
        seen.append((kw["nb"], kw["nt"]))
        return make(config, hyper, **kw)

    monkeypatch.setattr(train_cli, "make_ns_train_step", recording)
    out = train_cli.main(base + ["--train_datasets", "nerf_stereo", "kitti_2015",
                                 "--ns_num_tri", "4", "--num_steps", "1", "--save_dir",
                                 str(mixed)], device="cpu")
    assert seen == [(4, 4)] and out["timing"]["steps"] == 2
    assert all(np.isfinite(_losses(mixed, "live_loss")))
    assert (Path(out["checkpoint"]) / CHECKPOINT_FILE).exists()
