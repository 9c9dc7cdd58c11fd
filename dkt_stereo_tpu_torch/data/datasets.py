"""Stereo datasets for evaluation: path indexing and sample assembly
(host-side numpy, NHWC), the port's copy of the evaluation part of
``dkt_stereo_tpu/data/datasets.py`` (the reference's
core/stereo_datasets.py).

Each dataset indexes (left, right, disparity) file triplets; ``get_sample``
returns the reference's evaluation sample: the image pair as float32, the
disparity as negative flow-x and the validity mask
(core/stereo_datasets.py:59-141). The five datasets the validators build are
here: ETH3D, KITTI, Middlebury, Booster and the FlyingThings3D TEST split of
Scene Flow. Augmentation, concatenation and the training datasets come
with the training data layer (ROADMAP.md Queue 1 item 6b): ``aug_params``
other than None raise.
"""

from __future__ import annotations

import os
import os.path as osp
from glob import glob

import numpy as np

from dkt_stereo_tpu_torch.data import readers


class StereoDataset:
    """Base dataset (core/stereo_datasets.py:27-153), evaluation samples
    only."""

    def __init__(self, aug_params=None, sparse=False, reader=None):
        if aug_params is not None:
            raise NotImplementedError(
                "augmented (training) samples are not ported yet: ROADMAP.md Queue 1 item 6b")
        self.sparse = sparse
        self.disparity_reader = reader or readers.read_gen
        self.image_list: list[list[str]] = []
        self.disparity_list: list[str] = []

    def get_sample(self, index):
        """``(img1, img2, flow, valid)``: (H, W, 3) float32 images in [0,
        255], (H, W) float32 negative disparity and float32 validity."""
        index = index % len(self.image_list)
        disp = self.disparity_reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = (disp < 512) & (disp > 0)

        img1 = readers.read_image_rgb(self.image_list[index][0]).astype(np.float32)
        img2 = readers.read_image_rgb(self.image_list[index][1]).astype(np.float32)
        disp = np.array(disp).astype(np.float32)
        flow = np.stack([disp, np.zeros_like(disp)], axis=-1)

        if self.sparse:
            valid = valid.astype(np.float32)
        else:
            # recomputed from the 2-channel flow (core/stereo_datasets.py:123)
            valid = ((np.abs(flow[..., 0]) < 512) & (np.abs(flow[..., 1]) < 512)
                     & (np.abs(flow[..., 0]) > 0)).astype(np.float32)
        return img1, img2, -flow[..., 0], valid

    def __len__(self):
        return len(self.image_list)


class SceneFlowDatasets(StereoDataset):
    """FlyingThings3D's TEST split with the reference's fixed seed-1000
    400-image carve-out (core/stereo_datasets.py:156-217, :179-182); the
    training splits (Things TRAIN, Monkaa, Driving) come with item 6b."""

    def __init__(self, aug_params=None, root="data/sceneflow", dstype="frames_cleanpass",
                 things_test=False):
        super().__init__(aug_params)
        if not things_test:
            raise NotImplementedError(
                "Scene Flow's training splits are not ported yet: ROADMAP.md Queue 1 item 6b")
        things = osp.join(root, "FlyingThings3D")
        left = sorted(glob(osp.join(things, dstype, "TEST", "*/*/left/*.png")))
        right = [im.replace("left", "right") for im in left]
        disp = [im.replace(dstype, "disparity").replace(".png", ".pfm") for im in left]
        val_idxs = set(np.random.RandomState(1000).permutation(len(left))[:400])
        for idx, (i1, i2, d) in enumerate(zip(left, right, disp)):
            if idx in val_idxs:
                self.image_list.append([i1, i2])
                self.disparity_list.append(d)


class ETH3D(StereoDataset):
    """core/stereo_datasets.py:220-232."""

    def __init__(self, aug_params=None, root="data/ETH3D"):
        super().__init__(aug_params, sparse=True)
        image1 = sorted(glob(osp.join(root, "two_view_training/*/im0.png")))
        image2 = sorted(glob(osp.join(root, "two_view_training/*/im1.png")))
        disp = sorted(glob(osp.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        for i1, i2, d in zip(image1, image2, disp):
            self.image_list.append([i1, i2])
            self.disparity_list.append(d)


class KITTI(StereoDataset):
    """KITTI 2012/2015/mix (core/stereo_datasets.py:281-306)."""

    def __init__(self, aug_params=None, root="data/KITTI", split="mix"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispKITTI)
        assert os.path.exists(root)
        for year, left, right, gt in (("2012", "colored_0", "colored_1", "disp_occ"),
                                      ("2015", "image_2", "image_3", "disp_occ_0")):
            if split not in ("mix", year):
                continue
            base = os.path.join(root, f"KITTI_{year}", "training")
            image1 = sorted(glob(os.path.join(base, left, "*_10.png")))
            image2 = sorted(glob(os.path.join(base, right, "*_10.png")))
            disp = sorted(glob(os.path.join(base, gt, "*_10.png")))
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

    def __init__(self, aug_params=None, root="data/Booster_dataset", resolution="Q"):
        super().__init__(aug_params, sparse=True, reader=readers.readDispBooster)
        assert resolution in "FHQ"
        sub = {"F": "full", "H": "half", "Q": "quarter"}[resolution]
        root = os.path.join(root, sub)
        image1 = sorted(glob(osp.join(root, "train/balanced/*/camera_00/*.png")))
        image2 = sorted(glob(osp.join(root, "train/balanced/*/camera_02/*.png")))
        for i1, i2 in zip(image1, image2):
            self.image_list.append([i1, i2])
            self.disparity_list.append("/".join(i1.split("/")[0:-2]) + "/disp_00.npy")
