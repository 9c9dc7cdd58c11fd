"""The port's training data layer against the JAX package's, on the CPU:
PIL's HSV conversion and ``ImageEnhance`` (which the JAX photometric ops
run) against the port's numpy forms, ``cv2.resize(INTER_LINEAR)`` against
``augmentor._resize_linear``, every augmentor, every training dataset,
``fetch_dataset``, the new readers and the loader's batches against their
JAX twins at the same seeded generators. No JAX compile: the JAX data layer
is numpy, PIL and OpenCV.
"""

import ast
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance

from dkt_stereo_tpu.data import augmentor as jaug
from dkt_stereo_tpu.data import datasets as jds
from dkt_stereo_tpu.data import loader as jloader
from dkt_stereo_tpu.data import photometric as jphoto
from dkt_stereo_tpu.data import readers as jreaders
from dkt_stereo_tpu_torch.data import augmentor, datasets, photometric, png, readers
from dkt_stereo_tpu_torch.data.loader import StereoLoader

ROOT = Path(__file__).resolve().parents[1]


def _all_rgb():
    """Every 24-bit triple once, as a 4096 x 4096 x 3 uint8 image."""
    v = np.arange(2**24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(
        4096, 4096, 3)


# --- photometric primitives -------------------------------------------------------------


@pytest.mark.parametrize("direction", ["rgb_to_hsv", "hsv_to_rgb"])
def test_hsv_matches_pil_on_every_input(direction):
    """PIL's RGB->HSV and HSV->RGB (libImaging/Convert.c) bit for bit over
    all 2^24 inputs."""
    img = _all_rgb()
    if direction == "rgb_to_hsv":
        want = np.array(Image.fromarray(img, "RGB").convert("HSV"))
    else:
        want = np.array(Image.fromarray(img, "HSV").convert("RGB"))
    got = getattr(photometric, direction)(img)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert int((got != want).any(-1).sum()) == 0


@pytest.mark.parametrize("op", ["Brightness", "Contrast", "Color"])
def test_enhance_matches_pil(op, rng):
    """``ImageEnhance.{Brightness, Contrast, Color}`` bit for bit at 60 seeded
    factors in [0, 1.6] (extrapolation above 1), on noise and on a smooth
    image."""
    fn = {"Brightness": photometric.adjust_brightness, "Contrast": photometric.adjust_contrast,
          "Color": photometric.adjust_saturation}[op]
    yy, xx = np.mgrid[:48, :80]
    smooth = np.stack([xx * 3 % 256, yy * 5 % 256, (xx + yy) % 256], -1).astype(np.uint8)
    for img in (rng.integers(0, 256, (48, 80, 3), dtype=np.uint8), smooth):
        for alpha in list(rng.uniform(0, 1.6, 60)) + [0.0, 1.0, 1.6]:
            want = np.array(getattr(ImageEnhance, op)(Image.fromarray(img)).enhance(alpha))
            assert np.array_equal(fn(img, float(alpha)), want), (op, alpha)


def test_photo_aug_matches_jax():
    """``PhotoAug`` with the dense and sparse augmentors' parameters, with and
    without gamma, against the JAX ``PhotoAug`` (PIL) at the same seeded
    generator: equal arrays, and the generators end in equal states."""
    img = np.random.default_rng(5).integers(0, 256, (36, 52, 3), dtype=np.uint8)
    for params in ((0.4, 0.4, (0.6, 1.4), 0.5 / 3.14), (0.3, 0.3, (0.7, 1.3), 0.3 / 3.14),
                   (0.4, 0.4, (0, 1.4), 0.5 / 3.14, (0.8, 1.2, 0.9, 1.1))):
        ours, theirs = photometric.PhotoAug(*params), jphoto.PhotoAug(*params)
        for seed in range(12):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            assert np.array_equal(ours(img, r1), theirs(img, r2)), (params, seed)
            assert r1.bit_generator.state == r2.bit_generator.state


# --- resize --------------------------------------------------------------------------------


def test_resize_linear_matches_cv2():
    """``cv2.resize(INTER_LINEAR)``: uint8 bit for bit, float32 flow within
    1e-6 x max|flow|, at seeded sizes and scales in 0.6-1.5, stretched,
    below and above 1; an exact 2x downscale (INTER_AREA in OpenCV) raises."""
    rng = np.random.default_rng(11)
    for _ in range(24):
        H, W = int(rng.integers(9, 140)), int(rng.integers(9, 200))
        fx = float(rng.uniform(0.6, 1.5))
        fy = fx * float(2 ** rng.uniform(-0.3, 0.3))
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        want = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(augmentor._resize_linear(img, fx, fy), want), (H, W, fx, fy)
        flow = rng.uniform(-200, 200, (H, W, 2)).astype(np.float32)
        want = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        got = augmentor._resize_linear(flow, fx, fy)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(flow).max()
    with pytest.raises(NotImplementedError, match="INTER_AREA"):
        augmentor._resize_linear(img, 0.5, 0.5)


def test_resize_sparse_flow_map_matches_jax(rng):
    flow = rng.uniform(-30, 30, (23, 37, 2)).astype(np.float32)
    valid = (rng.uniform(size=(23, 37)) > 0.6).astype(np.float32)
    for fx, fy in ((1.3, 1.1), (0.8, 0.9), (1.0, 1.0)):
        ours = augmentor.resize_sparse_flow_map(flow, valid, fx, fy)
        theirs = jaug.resize_sparse_flow_map(flow, valid, fx, fy)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# --- augmentors ------------------------------------------------------------------------------


def _assert_same(ours, theirs, flow_index):
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape)
        if i == flow_index:
            assert np.abs(a - b).max() <= 1e-6 * max(1.0, float(np.abs(b).max())), i
        else:
            assert np.array_equal(a, b), i


@pytest.mark.parametrize("name", ["FlowAugmentorRTClean", "SparseFlowAugmentorRTClean",
                                  "FlowAugmentor", "SparseFlowAugmentor", "CropAugmentor"])
def test_augmentor_matches_jax(name):
    """Each augmentor against its JAX twin at the same seeded generators, with
    ``do_flip`` False, "h", "v" and "hf" and ``yjitter`` on and off, on a
    source larger than the crop and one smaller (the forced resize):
    every output equal (dense flow within 1e-6 of its scale), the
    generators in equal states afterwards."""
    ours_cls, theirs_cls = getattr(augmentor, name), getattr(jaug, name)
    sparse = "Sparse" in name
    rng = np.random.default_rng(3)
    crop = (40, 64)
    for H, W in ((70, 110), (30, 50)):
        img1 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        img2 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        disp = rng.uniform(1, 40, (H, W)).astype(np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], -1)
        valid = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
        for do_flip in (False, "h", "v", "hf"):
            for yjitter in (False, True):
                kw = {} if name == "CropAugmentor" else {"do_flip": do_flip, "yjitter": yjitter}
                if name == "CropAugmentor" and (H < crop[0] or do_flip or yjitter):
                    continue
                for seed in range(3):
                    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
                    a = ours_cls(crop, rng=r1, **kw)
                    b = theirs_cls(crop, rng=r2, **kw)
                    args = (img1, img2, flow, valid) if sparse else (img1, img2, flow)
                    out_a, out_b = a(*args), b(*args)
                    _assert_same(out_a, out_b, flow_index=len(out_b) - (2 if sparse else 1))
                    assert r1.bit_generator.state == r2.bit_generator.state


# --- readers ---------------------------------------------------------------------------------


def test_training_readers_match_jax(tmp_path, rng):
    """``readFlowKITTI`` of files written by OpenCV and by the port's
    ``writeFlowKITTI`` (which OpenCV reads back), 16-bit RGB and RGBA PNG
    decoded as cv2 decodes them, files written with adaptive row filters,
    and the Sintel, FallingThings and TartanAir readers, against the JAX
    readers."""
    uv = rng.uniform(-100, 100, (21, 33, 2))
    jreaders.writeFlowKITTI(str(tmp_path / "cv.png"), uv)
    readers.writeFlowKITTI(str(tmp_path / "port.png"), uv)
    cv_file = cv2.imread(str(tmp_path / "cv.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED), cv_file)
    for name in ("cv.png", "port.png"):
        for a, b in zip(readers.readFlowKITTI(str(tmp_path / name)),
                        jreaders.readFlowKITTI(str(tmp_path / name))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    rgba = rng.integers(0, 65536, (9, 14, 4)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "rgba16.png"), rgba)
    want = cv2.imread(str(tmp_path / "rgba16.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(png.read(tmp_path / "rgba16.png"), want[..., [2, 1, 0, 3]])
    # adaptive row filters (every filter type on a smooth image with noise)
    # decode to the image in the port and in OpenCV, 8 and 16 bits
    yy, xx = np.mgrid[:23, :31]
    smooth = np.stack([xx * 7 % 256, yy * 3 % 256, rng.integers(0, 256, (23, 31))], -1)
    for img in (smooth.astype(np.uint8), (smooth * 257).astype(np.uint16)):
        png.write(tmp_path / "adaptive.png", img, adaptive=True)
        assert np.array_equal(png.read(tmp_path / "adaptive.png"), img)
        back = cv2.imread(str(tmp_path / "adaptive.png"), cv2.IMREAD_UNCHANGED)[..., ::-1]
        assert np.array_equal(back, img)

    sintel = tmp_path / "disparities" / "seq" / "frame_0001.png"
    sintel.parent.mkdir(parents=True)
    Image.fromarray(rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)).save(sintel)
    occ = tmp_path / "occlusions" / "seq" / "frame_0001.png"
    occ.parent.mkdir(parents=True)
    Image.fromarray(np.where(rng.uniform(size=(12, 16)) > 0.8, 255, 0).astype(np.uint8)).save(occ)
    (tmp_path / "_camera_settings.json").write_text(
        json.dumps({"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}))
    Image.fromarray(rng.integers(1000, 30000, (12, 16)).astype(np.uint16)).save(
        tmp_path / "0_left.depth.png")
    np.save(tmp_path / "depth.npy", rng.uniform(2, 50, (12, 16)).astype(np.float32))
    for fn, path in (("readDispSintelStereo", sintel),
                     ("readDispFallingThings", tmp_path / "0_left.depth.png"),
                     ("readDispTartanAir", tmp_path / "depth.npy")):
        for a, b in zip(getattr(readers, fn)(str(path)), getattr(jreaders, fn)(str(path))):
            assert a.dtype == b.dtype and np.array_equal(a, b), fn


# --- training datasets -------------------------------------------------------------------------


def _img(path, rng, h=44, w=60):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(path)


def _disp16(path, rng, h=44, w=60):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d = (rng.uniform(1, 40, (h, w)) * 256).astype(np.uint16)
    d[: h // 4] = 0
    cv2.imwrite(str(path), d)


def _pfm(path, rng, h=44, w=60):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    jreaders.writePFM(str(path), rng.uniform(1, 40, (h, w)).astype(np.float32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One data root with a tiny tree of every training dataset, as the JAX
    tests build them (PIL and OpenCV writers; FallingThings' images JPEG)."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(17)
    sf = root / "sceneflow"
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for split in ("TRAIN", "TEST"):
            for side in ("left", "right"):
                _img(sf / "FlyingThings3D" / dstype / split / "A/0000" / side / "0006.png", rng)
        for side in ("left", "right"):
            _img(sf / "Monkaa" / dstype / "scene" / side / "0.png", rng)
            _img(sf / "Driving" / dstype / "a/b/c" / side / "0.png", rng)
    for split in ("TRAIN", "TEST"):
        _pfm(sf / "FlyingThings3D/disparity" / split / "A/0000/left/0006.pfm", rng)
    _pfm(sf / "Monkaa/disparity/scene/left/0.pfm", rng)
    _pfm(sf / "Driving/disparity/a/b/c/left/0.pfm", rng)

    sintel = root / "SintelStereo" / "training"
    for pass_ in ("clean", "final"):
        for side in ("left", "right"):
            _img(sintel / f"{pass_}_{side}" / "alley" / "frame_0001.png", rng)
    _img(sintel / "disparities" / "alley" / "frame_0001.png", rng)
    (sintel / "occlusions" / "alley").mkdir(parents=True)
    Image.fromarray(np.where(rng.uniform(size=(44, 60)) > 0.8, 255, 0).astype(np.uint8)).save(
        sintel / "occlusions" / "alley" / "frame_0001.png")

    ft = root / "FallingThings"
    _img(ft / "scene" / "0_left.jpg", rng)
    _img(ft / "scene" / "0_right.jpg", rng)
    Image.fromarray(rng.integers(1000, 30000, (44, 60)).astype(np.uint16)).save(
        ft / "scene" / "0_left.depth.png")
    (ft / "scene" / "_camera_settings.json").write_text(
        json.dumps({"camera_settings": [{"intrinsic_settings": {"fx": 768.2}}]}))
    (ft / "filenames.txt").write_text("scene/0_left.jpg\n")

    entries = ["abandonedfactory/Easy/P000/image_left/000000_left.png",
               "seasonsforest_winter/Easy/P000/image_left/000000_left.png",
               "hospital/Hard/P001/image_left/000001_left.png"]
    for e in entries:
        _img(root / e, rng)
        _img(root / e.replace("_left", "_right"), rng)
        dp = root / e.replace("image_left", "depth_left").replace("left.png", "left_depth.npy")
        dp.parent.mkdir(parents=True, exist_ok=True)
        np.save(dp, rng.uniform(2, 50, (44, 60)).astype(np.float32))
    (root / "tartanair_filenames.txt").write_text("\n".join(entries))

    for year, l, r, d in (("2012", "colored_0", "colored_1", "disp_occ"),
                          ("2015", "image_2", "image_3", "disp_occ_0")):
        for i in range(2):
            for image_set in ("training", "testing"):
                _img(root / f"KITTI/KITTI_{year}" / image_set / l / f"00000{i}_10.png", rng)
                _img(root / f"KITTI/KITTI_{year}" / image_set / r / f"00000{i}_10.png", rng)
            _disp16(root / f"KITTI/KITTI_{year}/training" / d / f"00000{i}_10.png", rng)

    for i in range(2):
        scene = root / "ETH3D" / "two_view_training" / f"s{i}"
        _img(scene / "im0.png", rng)
        _img(scene / "im1.png", rng)
        _pfm(root / "ETH3D" / "two_view_training_gt" / f"s{i}" / "disp0GT.pfm", rng)
    for name in ("Adirondack", "Jadeplant"):
        d = root / "Middlebury" / "MiddEval3" / "trainingH" / name
        _img(d / "im0.png", rng)
        _img(d / "im1.png", rng)
        _pfm(d / "disp0GT.pfm", rng)
        occ = np.full((44, 60), 255, np.uint8)
        occ[:, :8] = 128
        Image.fromarray(occ).save(d / "mask0nocc.png")
    for s in range(2):
        b = root / "Booster_dataset" / "quarter" / "train" / "balanced" / f"scene{s}"
        _img(b / "camera_00" / "0000.png", rng)
        _img(b / "camera_02" / "0000.png", rng)
        np.save(b / "disp_00.npy", rng.uniform(1, 40, (44, 60)).astype(np.float32))
    return root


AUG = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4, "do_flip": False,
       "yjitter": True}
DATASETS = {
    "sceneflow_train": ("SceneFlowDatasets", "sceneflow", {"dstype": "frames_finalpass"}),
    "sintel": ("SintelStereo", "SintelStereo", {}),
    "falling_things": ("FallingThings", "FallingThings", {}),
    "tartan_air": ("TartanAir", "", {}),
    "tartan_air_hospital": ("TartanAir", "", {"keywords": ("hospital",)}),
    "kitti_mix": ("KITTI", "KITTI", {"split": "mix"}),
    "kitti_2012": ("KITTI", "KITTI", {"split": "2012"}),
    "kitti_2015_testing": ("KITTI", "KITTI", {"split": "2015", "image_set": "testing"}),
    "eth3d": ("ETH3D", "ETH3D", {}),
    "booster": ("Booster", "Booster_dataset", {}),
    "middlebury": ("Middlebury", "Middlebury", {"resolution": "H"}),
}


def _same_sample(ours, theirs):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        pairs = [(ours[k], theirs[k], k) for k in theirs]
    else:
        pairs = [(a, b, i) for i, (a, b) in enumerate(zip(ours, theirs))]
    for a, b, k in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
        if k == "flow":
            assert np.abs(a - b).max() <= 1e-6 * max(1.0, float(np.abs(b).max())), k
        else:
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_training_dataset_matches_jax(trees, case):
    """The dataset's lists and its samples, augmented at seeded generators
    (and, for one index, without augmentation), equal the JAX dataset's.
    KITTI's testing image set lists a disparity file that is not in the
    tree (the reference's path), so only its lists are compared."""
    cls, sub, kw = DATASETS[case]
    root = str(trees / sub) if sub else str(trees)
    ours = getattr(datasets, cls)(dict(AUG), root=root, **kw)
    theirs = getattr(jds, cls)(dict(AUG), root=root, **kw)
    assert len(theirs) > 0
    assert ours.image_list == theirs.image_list and ours.disparity_list == theirs.disparity_list
    if kw.get("image_set") == "testing":
        return
    for i in range(len(theirs)):
        for seed in (0, 1):
            _same_sample(ours.get_sample(i, np.random.default_rng(seed)),
                         theirs.get_sample(i, np.random.default_rng(seed)))
    plain_ours = getattr(datasets, cls)(None, root=root, **kw)
    plain_theirs = getattr(jds, cls)(None, root=root, **kw)
    _same_sample(plain_ours.get_sample(0), plain_theirs.get_sample(0))


def test_fetch_dataset_and_concat_match_jax(trees):
    """``fetch_dataset``'s composition (replication factors, part order,
    lengths) for every name the port builds, ``__mul__`` / ``__add__`` /
    ``ConcatStereoDataset`` dispatch and ``img_pad``, against the JAX
    package; ``nerf_stereo`` raises naming ROADMAP.md Queue 1 item 10."""
    names = ["sceneflow", "sintel_stereo", "falling_things", "tartan_air_hospital", "kitti_mix",
             "kitti_2015", "eth3d", "booster", "middlebury_H"]
    kw = dict(image_size=(32, 48), data_root=str(trees))
    ours, theirs = datasets.fetch_dataset(names, **kw), jds.fetch_dataset(names, **kw)

    def parts(ds):
        return [(type(p).__name__, len(p), p.image_list) for p in getattr(ds, "parts", [ds])]

    assert type(ours).__name__ == type(theirs).__name__ == "ConcatStereoDataset"
    assert parts(ours) == parts(theirs) and len(ours) == len(theirs)
    for i in (0, 7, len(theirs) // 2, len(theirs) - 1):
        _same_sample(ours.get_sample(i, np.random.default_rng(i)),
                     theirs.get_sample(i, np.random.default_rng(i)))
    # __add__ merges lists of interchangeable datasets, else concatenates
    k = datasets.KITTI(dict(AUG), root=str(trees / "KITTI"), split="2015")
    k2 = datasets.KITTI(dict(AUG), root=str(trees / "KITTI"), split="2012")
    assert type(k + k2) is datasets.KITTI and len(k + k2) == 4
    other = datasets.KITTI({**AUG, "crop_size": (24, 40)}, root=str(trees / "KITTI"),
                           split="2012")
    assert type(k + other) is datasets.ConcatStereoDataset
    assert len((k + other) * 3) == 12 and len(k * 3) == 6
    # img_pad pads the four images, not the flow
    padded = datasets.KITTI({**AUG, "img_pad": (2, 3)}, root=str(trees / "KITTI"), split="2015")
    jpadded = jds.KITTI({**AUG, "img_pad": (2, 3)}, root=str(trees / "KITTI"), split="2015")
    s = padded.get_sample(0, np.random.default_rng(0))
    assert s["img1"].shape == (36, 54, 3) and s["img2_clean"].shape == (36, 54, 3)
    assert s["flow"].shape == (32, 48)
    _same_sample(s, jpadded.get_sample(0, np.random.default_rng(0)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        datasets.fetch_dataset(["nerf_stereo"], **kw)


# --- the loader --------------------------------------------------------------------------------


def _jax_batch(ds, indices, seed, epoch, b):
    jloader._proc_init(ds)
    return jloader._proc_batch((indices, (seed, epoch, 0, b)))


def test_loader_batches_match_jax_process_mode(trees):
    """Batch b of epochs 0 and 1 equals the JAX loader's ``_proc_batch`` of
    the same indices and seed tuple, bit for bit; ``len`` with and without
    ``drop_last``."""
    kw = dict(image_size=(32, 48), data_root=str(trees))
    ours = datasets.fetch_dataset(["kitti_mix", "eth3d"], **kw)
    theirs = jds.fetch_dataset(["kitti_mix", "eth3d"], **kw)
    loader = StereoLoader(ours, batch_size=2, num_workers=0, seed=7)
    assert len(loader) == 3 and len(StereoLoader(ours, 4, num_workers=0)) == 1
    assert len(StereoLoader(ours, 4, num_workers=0, drop_last=False)) == 2
    for epoch in (0, 1):
        idx = np.arange(len(theirs))
        np.random.RandomState(7 + epoch).shuffle(idx)
        batches = list(loader)
        assert loader.epoch == epoch + 1 and len(batches) == 3
        for b, batch in enumerate(batches):
            want = _jax_batch(theirs, idx[2 * b:2 * b + 2], 7, epoch, b)
            assert set(batch) == set(want)
            for k in want:
                assert isinstance(batch[k], torch.Tensor) and batch[k].dtype == torch.float32
                assert np.array_equal(batch[k].numpy(), want[k]), (epoch, b, k)


class _Corrupt:
    """``dataset`` whose sample ``bad`` fails, as a corrupt file does."""

    def __init__(self, dataset, bad):
        self.dataset, self.bad = dataset, bad

    def __len__(self):
        return len(self.dataset)

    def get_sample(self, index, rng):
        if index == self.bad:
            raise ValueError(f"corrupt sample {index}")
        return self.dataset.get_sample(index, rng)


def test_loader_workers(trees):
    """Two spawned workers give the batches the calling process gives, in
    order, until a worker's exception, which reaches the consumer; pinning
    is asked for whenever a CUDA device exists."""
    ds = datasets.fetch_dataset(["kitti_mix", "eth3d"], image_size=(32, 48),
                                data_root=str(trees))
    inline = list(StereoLoader(ds, batch_size=2, num_workers=0, seed=3, shuffle=False))
    loader = StereoLoader(_Corrupt(ds, bad=4), batch_size=2, num_workers=2, seed=3,
                          shuffle=False)
    try:
        assert loader._loader.pin_memory == torch.cuda.is_available()
        batches = iter(loader)
        for want in inline[:2]:
            got = next(batches)
            assert all(torch.equal(got[k], want[k]) for k in want)
        with pytest.raises(ValueError, match="corrupt sample 4"):
            next(batches)
    finally:
        loader.close()
    with pytest.raises(ValueError, match="corrupt sample 4"):
        list(StereoLoader(_Corrupt(ds, bad=4), batch_size=2, num_workers=0, shuffle=False))


# --- what the port imports ---------------------------------------------------------------------


def test_port_imports_neither_cv2_nor_pil_outside_the_jpeg_reader():
    """No module of the port imports cv2; PIL is imported only inside
    ``data/readers.py::_read_with_pil``."""
    found = []
    for f in sorted((ROOT / "dkt_stereo_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text())
        owners = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owners.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for m in names:
                top = (m or "").split(".")[0]
                if top == "cv2" or (top == "PIL" and (
                        f.name != "readers.py" or owners.get(id(node)) != "_read_with_pil")):
                    found.append((f.name, m, owners.get(id(node))))
    assert not found, found
