"""NeRF-Stereo triplet augmentation and dataset
(``dkt_stereo_tpu/data/triplet.py``; the reference's
``TripletFlowAugmentor``, core/utils/augmentor.py:322-483, and
``NerfStereo``, core/stereo_datasets.py:374-480), in numpy.

Three views (left, centre, right), clean and photometrically augmented
stacks, a random rotation and vertical shift of the right view, grayscale
with p = 0.1, an eraser and a y-jittered crop of the right view. The draws
come from an explicit ``numpy.random.Generator`` in the JAX module's order.
OpenCV's operations are ``data/imgproc.py``'s and
``augmentor._resize_linear``, value for value; the 16-bit disparity and
confidence maps are read by ``data/png.py``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from dkt_stereo_tpu_torch.data import png, readers
from dkt_stereo_tpu_torch.data.augmentor import _resize_linear
from dkt_stereo_tpu_torch.data.imgproc import (
    bgr_to_gray,
    resize_nearest,
    rotation_matrix,
    warp_affine_linear,
)
from dkt_stereo_tpu_torch.data.photometric import PhotoAug


class TripletFlowAugmentor:
    def __init__(
        self,
        crop_size,
        min_scale=-0.2,
        max_scale=0.5,
        do_flip=True,
        yjitter=False,
        saturation_range=(0.6, 1.4),
        gamma=(1, 1, 1, 1),
        rng: np.random.Generator | None = None,
    ):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = PhotoAug(0.4, 0.4, tuple(saturation_range), 0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2
        self.eraser_aug_prob = 0.5
        self.grayscale_prob = 0.1
        self.rng = rng or np.random.default_rng()

    def color_transform(self, img0, img1, img2):
        rng = self.rng
        if rng.random() < self.asymmetric_color_aug_prob:
            return (
                self.photo_aug(img0, rng),
                self.photo_aug(img1, rng),
                self.photo_aug(img2, rng),
            )
        stack = self.photo_aug(np.concatenate([img0, img1, img2], axis=0), rng)
        return tuple(np.split(stack, 3, axis=0))

    def random_vertical_disp(self, inputs, angle, px):
        """:367-377: a random rotation and vertical shift of the right view."""
        rng = self.rng
        px2 = rng.uniform(-px, px)
        angle2 = rng.uniform(-angle, angle)
        center = (rng.uniform(0, inputs[1].shape[0]), rng.uniform(0, inputs[1].shape[1]))
        inputs[1] = warp_affine_linear(inputs[1], rotation_matrix(center, angle2, 1.0))
        trans = np.float32([[1, 0, 0], [0, 1, px2]])
        inputs[1] = warp_affine_linear(inputs[1], trans)
        return inputs

    def spatial_transform(self, im1, im2, im3, gt=None, conf=None):
        rng = self.rng
        ht, wd = im2.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 8) / float(ht), (self.crop_size[1] + 8) / float(wd)
        )
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = np.clip(scale_x, min_scale, None)
        scale_y = np.clip(scale_y, min_scale, None)

        if rng.random() < self.spatial_aug_prob:
            im1, im2, im3 = (_resize_linear(im, scale_x, scale_y) for im in (im1, im2, im3))
            if gt is not None:
                gt = resize_nearest(gt, fx=scale_x, fy=scale_y) * scale_x
                conf = resize_nearest(conf, fx=scale_x, fy=scale_y)

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                im1, im2, im3 = im3[:, ::-1], im2[:, ::-1], im1[:, ::-1]
                if gt is not None:
                    gt = gt[:, ::-1]
                    conf = conf[:, ::-1]
            if rng.random() < self.v_flip_prob:
                im1, im2, im3 = im1[::-1], im2[::-1], im3[::-1]
                if gt is not None:
                    gt = gt[::-1]
                    conf = conf[::-1]

        ch, cw = self.crop_size
        y0 = rng.integers(2, im2.shape[0] - ch - 2)
        x0 = rng.integers(2, im2.shape[1] - cw - 2)
        y1 = y0 + rng.integers(-2, 3)

        im1_o = im1[:, :, :3][y0 : y0 + ch, x0 : x0 + cw]
        im2_o = im2[:, :, :3][y0 : y0 + ch, x0 : x0 + cw]
        im3_o = im3[:, :, :3][y0 : y0 + ch, x0 : x0 + cw]
        im1_aug = im1[:, :, 3:6][y0 : y0 + ch, x0 : x0 + cw]
        im2_aug = im2[:, :, 3:6][y0 : y0 + ch, x0 : x0 + cw]
        im3_aug = im3[:, :, 3:6][y1 : y1 + ch, x0 : x0 + cw]

        im1 = np.concatenate((im1_o, im1_aug), -1)
        im2 = np.concatenate((im2_o, im2_aug), -1)
        im3 = np.concatenate((im3_o, im3_aug), -1)
        if gt is not None:
            gt = gt[y0 : y0 + ch, x0 : x0 + cw]
            conf = conf[y0 : y0 + ch, x0 : x0 + cw]

        angle, px = (0.1, 3) if rng.binomial(1, 0.5) else (0, 0)
        augmented = self.random_vertical_disp(
            [np.ascontiguousarray(im2[:, :, 3:6]), np.ascontiguousarray(im3[:, :, 3:6])],
            angle, px,
        )

        if rng.random() < self.eraser_aug_prob:
            sx = int(rng.uniform(50, 100))
            sy = int(rng.uniform(50, 100))
            if im3.shape[0] > 2 * sx and im3.shape[1] > 2 * sy:
                cx = int(rng.uniform(sx, im3.shape[0] - sx))
                cy = int(rng.uniform(sy, im3.shape[1] - sy))
                augmented[1][cx - sx : cx + sx, cy - sy : cy + sy] = np.mean(
                    np.mean(augmented[1], 0), 0
                )[np.newaxis, np.newaxis]

        im2 = np.concatenate((im2[:, :, :3], augmented[0]), -1)
        im3 = np.concatenate((im3[:, :, :3], augmented[1]), -1)
        return im1, im2, im3, gt, conf

    def __call__(self, im0, im1, im2, gt=None, conf=None):
        rng = self.rng
        im0c, im1c, im2c = self.color_transform(im0, im1, im2)
        im0, im1, im2, gt, conf = self.spatial_transform(
            np.concatenate((im0, im0c), -1),
            np.concatenate((im1, im1c), -1),
            np.concatenate((im2, im2c), -1),
            gt, conf,
        )
        if rng.random() < self.grayscale_prob:
            # cvtColor(BGR2GRAY) of RGB data: red takes blue's weight, as in
            # the reference
            im1 = im1.copy()
            im2 = im2.copy()
            im1[:, :, 3:6] = np.stack((bgr_to_gray(im1[:, :, 3:6]),) * 3, axis=-1)
            im2[:, :, 3:6] = np.stack((bgr_to_gray(im2[:, :, 3:6]),) * 3, axis=-1)
        return {
            "im0": im0[:, :, :3],
            "im1": im1[:, :, :3],
            "im2": im2[:, :, :3],
            "im0_aug": im0[:, :, 3:6],
            "im1_aug": im1[:, :, 3:6],
            "im2_aug": im2[:, :, 3:6],
            "disp": gt,
            "conf": conf,
        }


class NerfStereo:
    """core/stereo_datasets.py:374-447: the triplet file list, and the
    16-bit disparity (/ 64) and confidence (/ 65536) maps, infinite
    disparities zeroed."""

    def __init__(self, datapath="data/nerf-stereo/training_set",
                 training_file="filenames/nerf-stereo/trainingQ.txt",
                 conf_threshold=0.5, disp_threshold=512.0, aug_params=None, scale=1):
        self.augmentor = TripletFlowAugmentor(**(aug_params or {"crop_size": (320, 720)}))
        self.scale = scale
        self.conf_threshold = conf_threshold
        self.disp_threshold = disp_threshold
        self.image_list: list[list[str]] = []
        with open(training_file) as f:
            for line in f:
                left, center, right, disp, confidence = line.split()
                self.image_list.append(
                    [os.path.join(datapath, p) for p in (left, center, right, disp, confidence)]
                )

    def __len__(self):
        return len(self.image_list)

    def __mul__(self, v: int):
        out = copy.deepcopy(self)
        out.image_list = v * out.image_list
        return out

    def __add__(self, other):
        # triplet and binocular samples differ: always a concatenation, which
        # MixedStereoLoader splits again by modality
        from dkt_stereo_tpu_torch.data.datasets import ConcatStereoDataset

        return ConcatStereoDataset([self, other])

    def __radd__(self, other):
        from dkt_stereo_tpu_torch.data.datasets import ConcatStereoDataset

        return ConcatStereoDataset([other, self])

    def get_sample(self, index, rng: np.random.Generator | None = None):
        """``im1_forward``, ``im2_forward`` (the augmented left and centre
        views), ``im0``, ``im1``, ``im2`` (the clean triplet), (H, W, 3)
        float32 in [0, 255]; ``flow`` (H, W) negative disparity and
        ``conf`` (H, W) float32. The augmentor draws from ``rng`` where
        one is given."""
        index = index % len(self.image_list)
        paths = self.image_list[index]
        im0 = readers.read_image_rgb(paths[0])
        im1 = readers.read_image_rgb(paths[1])
        im2 = readers.read_image_rgb(paths[2])
        disp = np.squeeze(np.asarray(png.read(paths[3]) / 64.0, np.float32))
        conf = np.squeeze(np.asarray(png.read(paths[4]) / 65536.0, np.float32))
        disp[np.isinf(disp)] = 0

        if self.scale != 1:
            h, w = im2.shape[0] // self.scale, im2.shape[1] // self.scale
            im0, im1, im2, disp, conf = (resize_nearest(a, (w, h))
                                         for a in (im0, im1, im2, disp, conf))

        aug = self.augmentor
        if rng is not None:
            # a shallow copy a call: the dataset is shared by the loader's
            # batches (see datasets.StereoDataset.get_sample)
            aug = copy.copy(aug)
            aug.rng = rng
        data = aug(im0, im1, im2, disp, conf)
        return {
            "im1_forward": data["im1_aug"].astype(np.float32),
            "im2_forward": data["im2_aug"].astype(np.float32),
            "flow": -data["disp"].astype(np.float32),  # negative convention
            "conf": data["conf"].astype(np.float32),
            "im0": data["im0"].astype(np.float32),
            "im1": data["im1"].astype(np.float32),
            "im2": data["im2"].astype(np.float32),
        }


def split_modalities(dataset):
    """The binocular and the trinocular pools of a ``fetch_dataset``
    composition: ``(bi_dataset | None, tri_dataset | None)``, which
    ``data/loader.py::MixedStereoLoader`` draws from independently."""
    from dkt_stereo_tpu_torch.data.datasets import ConcatStereoDataset

    parts = dataset.parts if isinstance(dataset, ConcatStereoDataset) else [dataset]
    bi = [p for p in parts if not isinstance(p, NerfStereo)]
    tri = [p for p in parts if isinstance(p, NerfStereo)]

    def join(ps):
        if not ps:
            return None
        out = ps[0]
        for p in ps[1:]:
            out = out + p
        return out

    return join(bi), join(tri)


def collate_mixed(samples: list[dict]) -> tuple[dict, int, int]:
    """A binocular + trinocular batch (the reference's
    ``NerfStereo.collate_fn``, core/stereo_datasets.py:449-480): binocular
    samples carry ``img1`` (``StereoDataset``), trinocular ones
    ``im1_forward`` (:class:`NerfStereo`). Returns ``(data, n_bi, n_tri)``:
    ``im1_forward``/``im2_forward`` stacked, binocular rows first, and
    ``bi: {flow, valid}``, ``tri: {flow, conf, im0, im1, im2}``, as CPU
    tensors."""
    bi = [s for s in samples if "img1" in s]
    tri = [s for s in samples if "im1_forward" in s]
    assert len(bi) + len(tri) == len(samples)

    def stack(rows, key):
        return np.stack([s[key] for s in rows])

    forward = {"im1_forward": [], "im2_forward": []}
    data: dict = {"bi": {}, "tri": {}}
    if bi:
        forward["im1_forward"].append(stack(bi, "img1"))
        forward["im2_forward"].append(stack(bi, "img2"))
        data["bi"] = {k: torch.from_numpy(stack(bi, k)) for k in ("flow", "valid")}
    if tri:
        forward["im1_forward"].append(stack(tri, "im1_forward"))
        forward["im2_forward"].append(stack(tri, "im2_forward"))
        data["tri"] = {k: torch.from_numpy(stack(tri, k))
                       for k in ("flow", "conf", "im0", "im1", "im2")}
    for k, parts in forward.items():
        data[k] = torch.from_numpy(np.concatenate(parts))
    return data, len(bi), len(tri)
