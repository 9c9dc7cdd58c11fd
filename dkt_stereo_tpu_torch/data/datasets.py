"""Stereo datasets: path indexing and sample assembly (host-side numpy,
NHWC), the port's copy of ``dkt_stereo_tpu/data/datasets.py`` (the
reference's core/stereo_datasets.py).

Each dataset indexes (left, right, disparity) file triplets; ``get_sample``
assembles the reference's sample: clean and augmented image pairs, the
disparity as negative flow-x and the validity mask
(core/stereo_datasets.py:59-141), or without augmentation the evaluation
sample. The datasets, their replication factors in :func:`fetch_dataset`
and the differences from the reference are the JAX package's: an explicit
``numpy.random.Generator`` instead of global random state, NHWC float32
arrays, a ``kitti_mix`` branch that builds the mix split, no
``KITTI_SubSet``. NeRF-Stereo's triplets are not ported yet (ROADMAP.md
Queue 1 item 10).
"""

from __future__ import annotations

import copy
import logging
import os
import os.path as osp
from glob import glob

import numpy as np

from dkt_stereo_tpu_torch.data import readers
from dkt_stereo_tpu_torch.data.augmentor import (
    FlowAugmentorRTClean,
    SparseFlowAugmentorRTClean,
)


class StereoDataset:
    """Base dataset (core/stereo_datasets.py:27-153)."""

    def __init__(self, aug_params=None, sparse=False, reader=None):
        self.augmentor = None
        self.sparse = sparse
        self.img_pad = aug_params.pop("img_pad", None) if aug_params is not None else None
        if aug_params is not None and "crop_size" in aug_params:
            cls = SparseFlowAugmentorRTClean if sparse else FlowAugmentorRTClean
            self.augmentor = cls(**aug_params)
        self.disparity_reader = reader or readers.read_gen
        self.image_list: list[list[str]] = []
        self.disparity_list: list[str] = []

    def get_sample(self, index, rng: np.random.Generator | None = None):
        """With an augmentor, a dict: ``img1``, ``img2`` (augmented) and
        ``img1_clean``, ``img2_clean`` (the spatial transform only), (H, W,
        3) float32 in [0, 255]; ``flow``, (H, W) float32 negative
        disparity; ``valid`` (H, W) float32. The augmentor draws from
        ``rng`` where one is given. Without one, ``(img1, img2, flow,
        valid)``, the evaluation sample."""
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = (disp < 512) & (disp > 0)

        img1 = readers.read_image_rgb(self.image_list[index][0])
        img2 = readers.read_image_rgb(self.image_list[index][1])
        disp = np.array(disp).astype(np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)

        if self.augmentor is not None:
            aug = self.augmentor
            if rng is not None:
                # bind the caller's generator onto a shallow per-call copy:
                # the dataset (and its augmentor) is SHARED across loader
                # worker threads, so mutating self.augmentor.rng would let
                # concurrent workers draw from each other's streams
                aug = copy.copy(aug)
                aug.rng = rng
            if self.sparse:
                img1_clean, img2_clean, img1, img2, flow, valid = aug(
                    img1, img2, flow, valid
                )
            else:
                img1_clean, img2_clean, img1, img2, flow = aug(
                    img1, img2, flow
                )

        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        flow = flow.astype(np.float32)

        if self.img_pad is not None:
            # reference semantics (core/stereo_datasets.py:125-132): zero-pad
            # the IMAGES symmetrically by (padH, padW); flow/valid untouched
            padH, padW = self.img_pad
            pad = ((padH, padH), (padW, padW), (0, 0))
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)
            if self.augmentor is not None:
                img1_clean = np.pad(img1_clean.astype(np.float32), pad)
                img2_clean = np.pad(img2_clean.astype(np.float32), pad)

        if self.sparse:
            valid = valid.astype(np.float32)
        else:
            # recomputed from the 2-channel flow (core/stereo_datasets.py:123)
            valid = (
                (np.abs(flow[..., 0]) < 512)
                & (np.abs(flow[..., 1]) < 512)
                & (np.abs(flow[..., 0]) > 0)
            ).astype(np.float32)

        flow_x = flow[..., 0]  # (H, W); stored negative below (:136)

        if self.augmentor is not None:
            return {
                "img1": img1,
                "img2": img2,
                "img1_clean": img1_clean.astype(np.float32),
                "img2_clean": img2_clean.astype(np.float32),
                "flow": -flow_x,
                "valid": valid,
            }
        return img1, img2, -flow_x, valid

    # torch-free replication/concat (core/stereo_datasets.py:144-150 + the
    # implicit torch ConcatDataset '+')
    def __mul__(self, v: int):
        out = copy.deepcopy(self)
        out.image_list = v * out.image_list
        out.disparity_list = v * out.disparity_list
        return out

    def __add__(self, other):
        # samples must keep their origin dataset's reader/sparse mode AND
        # augmentor config; merging the path lists is only sound when both
        # sides dispatch identically — otherwise per-index dispatch
        if isinstance(other, ConcatStereoDataset) or not isinstance(other, StereoDataset):
            return ConcatStereoDataset([self, other])
        if (
            (other.disparity_reader is not self.disparity_reader)
            or (other.sparse != self.sparse)
            or not _same_aug(self, other)
        ):
            return ConcatStereoDataset([self, other])
        out = copy.deepcopy(self)
        out.image_list = self.image_list + other.image_list
        out.disparity_list = self.disparity_list + other.disparity_list
        return out

    def __len__(self):
        return len(self.image_list)


def _same_aug(a: "StereoDataset", b: "StereoDataset") -> bool:
    """True when two datasets' augmentation behavior is interchangeable
    (same augmentor class + spatial/photometric config, same img_pad) so
    their sample lists can be merged into one dataset."""
    if getattr(a, "img_pad", None) != getattr(b, "img_pad", None):
        return False
    x, y = a.augmentor, b.augmentor
    if x is None or y is None:
        return x is y
    if type(x) is not type(y):
        return False
    keys = (
        "crop_size", "min_scale", "max_scale", "do_flip", "yjitter",
        "spatial_aug_prob", "stretch_prob", "asymmetric_color_aug_prob",
        "eraser_aug_prob",
    )
    return all(getattr(x, k, None) == getattr(y, k, None) for k in keys)


class ConcatStereoDataset:
    """Concatenation across heterogeneous datasets (different readers)."""

    def __init__(self, parts):
        self.parts = []
        for p in parts:
            if isinstance(p, ConcatStereoDataset):
                self.parts.extend(p.parts)
            else:
                self.parts.append(p)

    def get_sample(self, index, rng=None):
        for p in self.parts:
            if index < len(p):
                return p.get_sample(index, rng)
            index -= len(p)
        raise IndexError(index)

    def __add__(self, other):
        return ConcatStereoDataset(self.parts + [other])

    def __mul__(self, v: int):
        return ConcatStereoDataset([p * v for p in self.parts])

    def __len__(self):
        return sum(len(p) for p in self.parts)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (core/stereo_datasets.py:156-217),
    incl. the fixed seed-1000 400-image TEST carve-out (:179-182)."""

    def __init__(self, aug_params=None, root="data/sceneflow", dstype="frames_cleanpass", things_test=False):
        super().__init__(aug_params)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _add_things(self, split="TRAIN"):
        root = osp.join(self.root, "FlyingThings3D")
        left = sorted(glob(osp.join(root, self.dstype, split, "*/*/left/*.png")))
        right = [im.replace("left", "right") for im in left]
        disp = [im.replace(self.dstype, "disparity").replace(".png", ".pfm") for im in left]
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        for idx, (i1, i2, d) in enumerate(zip(left, right, disp)):
            if (split == "TEST" and idx in val_idxs) or split == "TRAIN":
                self.image_list.append([i1, i2])
                self.disparity_list.append(d)

    def _add_monkaa(self):
        root = osp.join(self.root, "Monkaa")
        left = sorted(glob(osp.join(root, self.dstype, "*/left/*.png")))
        for i1 in left:
            self.image_list.append([i1, i1.replace("left", "right")])
            self.disparity_list.append(
                i1.replace(self.dstype, "disparity").replace(".png", ".pfm")
            )

    def _add_driving(self):
        root = osp.join(self.root, "Driving")
        left = sorted(glob(osp.join(root, self.dstype, "*/*/*/left/*.png")))
        for i1 in left:
            self.image_list.append([i1, i1.replace("left", "right")])
            self.disparity_list.append(
                i1.replace(self.dstype, "disparity").replace(".png", ".pfm")
            )


class ETH3D(StereoDataset):
    """core/stereo_datasets.py:220-232."""

    def __init__(self, aug_params=None, root="data/ETH3D", split="training"):
        super().__init__(aug_params, sparse=True)
        image1 = sorted(glob(osp.join(root, f"two_view_{split}/*/im0.png")))
        image2 = sorted(glob(osp.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:
            disp = [osp.join(root, "two_view_training_gt/playground_1l/disp0GT.pfm")] * len(image1)
        for i1, i2, d in zip(image1, image2, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class SintelStereo(StereoDataset):
    """core/stereo_datasets.py:234-245."""

    def __init__(self, aug_params=None, root="data/SintelStereo"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispSintelStereo)
        image1 = sorted(glob(osp.join(root, "training/*_left/*/frame_*.png")))
        image2 = sorted(glob(osp.join(root, "training/*_right/*/frame_*.png")))
        disp = sorted(glob(osp.join(root, "training/disparities/*/frame_*.png"))) * 2
        for i1, i2, d in zip(image1, image2, disp):
            assert i1.split("/")[-2:] == d.split("/")[-2:]
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    """core/stereo_datasets.py:247-261."""

    def __init__(self, aug_params=None, root="data/FallingThings"):
        super().__init__(aug_params, reader=readers.readDispFallingThings)
        assert os.path.exists(root)
        with open(os.path.join(root, "filenames.txt")) as f:
            filenames = sorted(f.read().splitlines())
        for e in filenames:
            self.image_list.append(
                [osp.join(root, e), osp.join(root, e.replace("left.jpg", "right.jpg"))]
            )
            self.disparity_list.append(osp.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    """core/stereo_datasets.py:263-279."""

    def __init__(self, aug_params=None, root="datasets", keywords=()):
        super().__init__(aug_params, reader=readers.readDispTartanAir)
        assert os.path.exists(root)
        with open(os.path.join(root, "tartanair_filenames.txt")) as f:
            filenames = sorted(
                s for s in f.read().splitlines() if "seasonsforest_winter/Easy" not in s
            )
        for kw in keywords:
            filenames = sorted(s for s in filenames if kw in s.lower())
        for e in filenames:
            self.image_list.append([osp.join(root, e), osp.join(root, e.replace("_left", "_right"))])
            self.disparity_list.append(
                osp.join(
                    root,
                    e.replace("image_left", "depth_left").replace("left.png", "left_depth.npy"),
                )
            )


class KITTI(StereoDataset):
    """KITTI 2012/2015/mix (core/stereo_datasets.py:281-306)."""

    def __init__(self, aug_params=None, root="data/KITTI", split="mix", image_set="training"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispKITTI)
        assert os.path.exists(root)

        if split in ("mix", "2012"):
            r12 = os.path.join(root, "KITTI_2012")
            image1 = sorted(glob(os.path.join(r12, image_set, "colored_0/*_10.png")))
            image2 = sorted(glob(os.path.join(r12, image_set, "colored_1/*_10.png")))
            if image_set == "training":
                disp = sorted(glob(os.path.join(r12, "training", "disp_occ/*_10.png")))
            else:
                disp = [os.path.join(root, "training/disp_occ/000085_10.png")] * len(image1)
            for i1, i2, d in zip(image1, image2, disp):
                self.image_list.append([i1, i2])
                self.disparity_list.append(d)

        if split in ("mix", "2015"):
            r15 = os.path.join(root, "KITTI_2015")
            image1 = sorted(glob(os.path.join(r15, image_set, "image_2/*_10.png")))
            image2 = sorted(glob(os.path.join(r15, image_set, "image_3/*_10.png")))
            if image_set == "training":
                disp = sorted(glob(os.path.join(r15, "training", "disp_occ_0/*_10.png")))
            else:
                disp = [os.path.join(root, "training/disp_occ_0/000085_10.png")] * len(image1)
            for i1, i2, d in zip(image1, image2, disp):
                self.image_list.append([i1, i2])
                self.disparity_list.append(d)


class Middlebury(StereoDataset):
    """MiddEval3 F/H/Q (core/stereo_datasets.py:341-354); scene list taken
    from trainingH as in the reference (:346)."""

    def __init__(self, aug_params=None, root="data/Middlebury", resolution="H"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispMiddlebury)
        assert os.path.exists(root)
        assert resolution in "FHQ"
        names = sorted(map(osp.basename, glob(os.path.join(root, "MiddEval3/trainingH/*"))))
        for name in names:
            base = os.path.join(root, "MiddEval3", f"training{resolution}", name)
            self.image_list.append([osp.join(base, "im0.png"), osp.join(base, "im1.png")])
            self.disparity_list.append(osp.join(base, "disp0GT.pfm"))


class Booster(StereoDataset):
    """Booster balanced pairs, disp_00.npy GT (core/stereo_datasets.py:356-371)."""

    def __init__(self, aug_params=None, root="data/Booster_dataset", resolution="Q", split="train"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispBooster)
        assert resolution in "FHQ"
        sub = {"F": "full", "H": "half", "Q": "quarter"}[resolution]
        root = os.path.join(root, sub)
        image1 = sorted(glob(osp.join(root, f"{split}/balanced/*/camera_00/*.png")))
        image2 = sorted(glob(osp.join(root, f"{split}/balanced/*/camera_02/*.png")))
        for i1, i2 in zip(image1, image2):
            self.image_list.append([i1, i2])
            self.disparity_list.append("/".join(i1.split("/")[0:-2]) + "/disp_00.npy")


def fetch_dataset(train_datasets, image_size, spatial_scale=(-0.2, 0.4),
                  saturation_range=None, img_gamma=None, do_flip=False,
                  noyjitter=False, data_root="data"):
    """Dataset composition with the reference's replication factors
    (core/stereo_datasets.py:482-533), with the kitti_mix branch fixed."""
    aug_params = {
        "crop_size": image_size,
        "min_scale": spatial_scale[0],
        "max_scale": spatial_scale[1],
        "do_flip": do_flip or False,
        "yjitter": not noyjitter,
    }
    if saturation_range is not None:
        aug_params["saturation_range"] = saturation_range
    if img_gamma is not None:
        aug_params["gamma"] = img_gamma

    train_dataset = None
    for name in train_datasets:
        if name.startswith("middlebury_"):
            new = Middlebury(dict(aug_params), root=osp.join(data_root, "Middlebury"),
                             resolution=name.replace("middlebury_", ""))
        elif name == "sceneflow":
            clean = SceneFlowDatasets(dict(aug_params), root=osp.join(data_root, "sceneflow"), dstype="frames_cleanpass")
            final = SceneFlowDatasets(dict(aug_params), root=osp.join(data_root, "sceneflow"), dstype="frames_finalpass")
            new = (clean * 4) + (final * 4)
        elif "kitti" in name:
            split = "2012" if "2012" in name else "2015" if "2015" in name else "mix"
            new = KITTI(dict(aug_params), root=osp.join(data_root, "KITTI"), split=split)
        elif name == "eth3d":
            new = ETH3D(dict(aug_params), root=osp.join(data_root, "ETH3D"))
        elif name == "booster":
            new = Booster(dict(aug_params), root=osp.join(data_root, "Booster_dataset"), resolution="Q")
        elif name == "sintel_stereo":
            new = SintelStereo(dict(aug_params), root=osp.join(data_root, "SintelStereo")) * 140
        elif name == "falling_things":
            new = FallingThings(dict(aug_params), root=osp.join(data_root, "FallingThings")) * 5
        elif name.startswith("tartan_air"):
            new = TartanAir(dict(aug_params), root=data_root, keywords=name.split("_")[2:])
        elif name == "nerf_stereo":
            raise NotImplementedError(
                "nerf_stereo (NeRF-Stereo triplets) is not ported yet: ROADMAP.md Queue 1 "
                "item 10")
        else:
            raise ValueError(f"unknown dataset {name!r}")
        logging.info("Adding %d samples from %s", len(new), name)
        train_dataset = new if train_dataset is None else train_dataset + new
    return train_dataset
