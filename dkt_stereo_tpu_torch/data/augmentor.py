"""DKT dense and sparse augmentors producing (clean, augmented) image
pairs: the port's copy of ``dkt_stereo_tpu/data/augmentor.py`` (the
reference's core/utils/augmentor.py: RTClean dense :543-682, sparse
:837-1007, the plain CropAugmentor :490-536), in numpy.

The probabilities, the order of the generator's draws in every branch, the
crop margins, the min-scale guards (with the JAX package's forced resize of
a source smaller than the crop) and the scatter-based sparse flow rescale
are the JAX module's. The clean pair gets only the spatial transform; the
photometric and eraser transforms apply to the augmented pair only.

``cv2.resize(INTER_LINEAR)`` is :func:`_resize_linear`, which computes
OpenCV's arithmetic in numpy: uint8 images bit for bit, float32 flow up to
the order of float additions.
"""

from __future__ import annotations

import numpy as np

from dkt_stereo_tpu_torch.data.photometric import PhotoAug

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE, 1 << INTER_RESIZE_COEF_BITS (11)


def _axis_taps(src: int, dst: int, inv_scale: float, reset_border: bool):
    """OpenCV's source taps of one axis (imgproc/src/resize.cpp,
    ``resize``): ``fx = (float)((dx + 0.5) * scale_x - 0.5); sx =
    cvFloor(fx); fx -= sx;`` with ``scale_x = 1. / inv_scale_x`` in double.
    Along x, a tap left of the image (sx < 0) becomes ``fx = 0, sx = 0`` and
    one at or past the last column ``fx = 0, sx = width - 1``; along y the
    weight stands and only the two rows' indices are clamped. Returns the
    two (clamped) indices and the float32 weight of the second."""
    scale = 1.0 / inv_scale
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if reset_border:
        out = (s < 0) | (s >= src - 1)
        f = np.where(out, np.float32(0), f)
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)``
    for a uint8 or float32 (H, W) or (H, W, C) array. The output is
    ``round(W * fx)`` x ``round(H * fy)`` (``saturate_cast<int>``, halves to
    even). uint8: the horizontal pass weights two pixels by
    ``saturate_cast<short>((1 - fx) * 2048)`` and ``(fx * 2048)`` (cvRound)
    into ints; the vertical pass combines two such rows as OpenCV's SIMD
    path ``VResizeLinearVec_32s8u`` does: ``(mulhi(b0, r0 >> 4) + mulhi(b1,
    r1 >> 4) + 2) >> 2``, saturated to uint8. float32: the same taps with
    float32 weights ``1.f - fx`` and ``fx``. OpenCV turns an exact 2x
    downscale on both axes into INTER_AREA; that case raises."""
    a = np.asarray(img)
    H, W = a.shape[:2]
    if abs(1.0 / fx - 2.0) < np.finfo(np.float64).eps and abs(1.0 / fy - 2.0) < np.finfo(
            np.float64).eps:
        raise NotImplementedError(
            "an exact 2x downscale is INTER_AREA in cv2.resize, which the port does not "
            "reproduce; the augmentors' scale ranges do not reach it")
    x0, x1, wx = _axis_taps(W, int(round(W * fx)), fx, reset_border=True)
    y0, y1, wy = _axis_taps(H, int(round(H * fy)), fy, reset_border=False)
    src = a.reshape(H, W, -1)
    if a.dtype == np.uint8:
        ax0 = np.rint((np.float32(1) - wx) * np.float32(_COEF_SCALE)).astype(np.int32)
        ax1 = np.rint(wx * np.float32(_COEF_SCALE)).astype(np.int32)
        by0 = np.rint((np.float32(1) - wy) * np.float32(_COEF_SCALE)).astype(np.int32)
        by1 = np.rint(wy * np.float32(_COEF_SCALE)).astype(np.int32)
        s = src.astype(np.int32)
        rows = s[:, x0] * ax0[None, :, None] + s[:, x1] * ax1[None, :, None]
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        out = (((by0[:, None, None] * r0) >> 16) + ((by1[:, None, None] * r1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    elif a.dtype == np.float32:
        s = src
        rows = s[:, x0] * (np.float32(1) - wx)[None, :, None] + s[:, x1] * wx[None, :, None]
        out = (rows[y0] * (np.float32(1) - wy)[:, None, None] + rows[y1] * wy[:, None, None])
    else:
        raise TypeError(f"_resize_linear takes uint8 or float32, got {a.dtype}")
    return out.reshape(out.shape[:2] + a.shape[2:])


class FlowAugmentorRTClean:
    """Dense-GT augmentor (core/utils/augmentor.py:543-682)."""

    def __init__(
        self,
        crop_size,
        min_scale=-0.2,
        max_scale=0.5,
        do_flip=False,
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
        self.rng = rng or np.random.default_rng()

    def color_transform(self, img1, img2):
        rng = self.rng
        if rng.random() < self.asymmetric_color_aug_prob:
            img1 = self.photo_aug(img1, rng)
            img2 = self.photo_aug(img2, rng)
        else:
            stack = np.concatenate([img1, img2], axis=0)
            stack = self.photo_aug(stack, rng)
            img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def eraser_transform(self, img1, img2, bounds=(50, 100)):
        rng = self.rng
        ht, wd = img1.shape[:2]
        img2 = img2.copy()
        if rng.random() < self.eraser_aug_prob:
            mean_color = np.mean(img2.reshape(-1, 3), axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    def spatial_transform(self, img1_clean, img2_clean, img1, img2, flow):
        rng = self.rng
        ht, wd = img1.shape[:2]
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
            rs = lambda im: _resize_linear(im, scale_x, scale_y)
            img1_clean, img2_clean = rs(img1_clean), rs(img2_clean)
            img1, img2 = rs(img1), rs(img2)
            flow = rs(flow) * [scale_x, scale_y]

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1_clean, img2_clean = img1_clean[:, ::-1], img2_clean[:, ::-1]
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                img1_clean, img2_clean = img2_clean[:, ::-1], img1_clean[:, ::-1]
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1_clean, img2_clean = img1_clean[::-1, :], img2_clean[::-1, :]
                img1, img2 = img1[::-1, :], img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        ch, cw = self.crop_size
        # Robustness fix over the reference (core/utils/augmentor.py:620-668):
        # when the spatial-aug branch is skipped and the source is smaller
        # than the crop, the reference's crop draw degenerates (empty randint
        # range / sliver crops). Force the min_scale resize instead; consumes
        # no RNG draws and never engages when the image already fits, so the
        # augmentation distribution on real-size datasets is unchanged.
        pad = 5 if self.yjitter else 1
        if img1.shape[0] < ch + pad or img1.shape[1] < cw + pad:
            rs = lambda im: _resize_linear(im, min_scale, min_scale)
            img1_clean, img2_clean = rs(img1_clean), rs(img2_clean)
            img1, img2 = rs(img1), rs(img2)
            flow = rs(flow) * [min_scale, min_scale]
        if self.yjitter:
            y0 = rng.integers(2, img1.shape[0] - ch - 2)
            x0 = rng.integers(2, img1.shape[1] - cw - 2)
            y1 = y0 + rng.integers(-2, 3)
            img1_clean = img1_clean[y0 : y0 + ch, x0 : x0 + cw]
            img2_clean = img2_clean[y1 : y1 + ch, x0 : x0 + cw]
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y1 : y1 + ch, x0 : x0 + cw]
            flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        else:
            y0 = rng.integers(0, img1.shape[0] - ch)
            x0 = rng.integers(0, img1.shape[1] - cw)
            img1_clean = img1_clean[y0 : y0 + ch, x0 : x0 + cw]
            img2_clean = img2_clean[y0 : y0 + ch, x0 : x0 + cw]
            img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
            img2 = img2[y0 : y0 + ch, x0 : x0 + cw]
            flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        return img1_clean, img2_clean, img1, img2, flow

    def __call__(self, img1, img2, flow):
        img1_clean = np.array(img1)
        img2_clean = np.array(img2)
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1_clean, img2_clean, img1, img2, flow = self.spatial_transform(
            img1_clean, img2_clean, img1, img2, flow
        )
        return tuple(
            np.ascontiguousarray(x) for x in (img1_clean, img2_clean, img1, img2, flow)
        )


def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
    """Validity-aware sparse rescale via scatter of valid points
    (core/utils/augmentor.py:892-924). NB keeps the reference's strict
    ``> 0`` bound (drops column/row 0 after scaling)."""
    ht, wd = flow.shape[:2]
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)), axis=-1)
    coords = coords.reshape(-1, 2).astype(np.float32)
    flow = flow.reshape(-1, 2).astype(np.float32)
    valid = valid.reshape(-1).astype(np.float32)

    coords0 = coords[valid >= 1]
    flow0 = flow[valid >= 1]

    ht1 = int(round(ht * fy))
    wd1 = int(round(wd * fx))
    coords1 = coords0 * [fx, fy]
    flow1 = flow0 * [fx, fy]

    xx = np.round(coords1[:, 0]).astype(np.int32)
    yy = np.round(coords1[:, 1]).astype(np.int32)
    v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
    xx, yy, flow1 = xx[v], yy[v], flow1[v]

    flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
    valid_img = np.zeros([ht1, wd1], dtype=np.int32)
    flow_img[yy, xx] = flow1
    valid_img[yy, xx] = 1
    return flow_img, valid_img


class SparseFlowAugmentorRTClean:
    """Sparse-GT augmentor (core/utils/augmentor.py:837-1007): asymmetric
    color p=1.0, spatial p=0.8 without stretch, crop margins y20/x50."""

    def __init__(
        self,
        crop_size,
        min_scale=-0.2,
        max_scale=0.5,
        do_flip=False,
        yjitter=False,
        saturation_range=(0.7, 1.3),
        gamma=(1, 1, 1, 1),
        rng: np.random.Generator | None = None,
    ):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.stretch_prob = 0.8  # unused in the sparse spatial path (:934-936)
        self.max_stretch = 0.2
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo_aug = PhotoAug(0.3, 0.3, tuple(saturation_range), 0.3 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 1.0
        self.eraser_aug_prob = 0.5
        self.rng = rng or np.random.default_rng()

    color_transform = FlowAugmentorRTClean.color_transform
    eraser_transform = FlowAugmentorRTClean.eraser_transform

    def spatial_transform(self, img1_clean, img2_clean, img1, img2, flow, valid):
        rng = self.rng
        ht, wd = img1.shape[:2]
        min_scale = np.maximum(
            (self.crop_size[0] + 1) / float(ht), (self.crop_size[1] + 1) / float(wd)
        )
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = np.clip(scale, min_scale, None)
        scale_y = np.clip(scale, min_scale, None)

        if rng.random() < self.spatial_aug_prob:
            rs = lambda im: _resize_linear(im, scale_x, scale_y)
            img1_clean, img2_clean = rs(img1_clean), rs(img2_clean)
            img1, img2 = rs(img1), rs(img2)
            flow, valid = resize_sparse_flow_map(flow, valid, fx=scale_x, fy=scale_y)

        if self.do_flip:
            if rng.random() < self.h_flip_prob and self.do_flip == "hf":
                img1_clean, img2_clean = img1_clean[:, ::-1], img2_clean[:, ::-1]
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.h_flip_prob and self.do_flip == "h":
                img1_clean, img2_clean = img2_clean[:, ::-1], img1_clean[:, ::-1]
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if rng.random() < self.v_flip_prob and self.do_flip == "v":
                img1_clean, img2_clean = img1_clean[::-1, :], img2_clean[::-1, :]
                img1, img2 = img1[::-1, :], img2[::-1, :]
                flow = flow[::-1, :] * [1.0, -1.0]

        ch, cw = self.crop_size
        # Same robustness fix as the dense augmentor: a source smaller than
        # the crop (only possible when the 0.8-prob resize branch was
        # skipped) would make the clip below collapse the crop to a sliver.
        # Forcing the min_scale resize consumes no RNG draws.
        if img1.shape[0] < ch or img1.shape[1] < cw:
            rs = lambda im: _resize_linear(im, min_scale, min_scale)
            img1_clean, img2_clean = rs(img1_clean), rs(img2_clean)
            img1, img2 = rs(img1), rs(img2)
            flow, valid = resize_sparse_flow_map(flow, valid, fx=min_scale, fy=min_scale)
        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - ch + margin_y)
        x0 = rng.integers(-margin_x, img1.shape[1] - cw + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))

        out = []
        for a in (img1_clean, img2_clean, img1, img2, flow, valid):
            out.append(a[y0 : y0 + ch, x0 : x0 + cw])
        return tuple(out)

    def __call__(self, img1, img2, flow, valid):
        img1_clean = np.array(img1)
        img2_clean = np.array(img2)
        img1, img2 = self.color_transform(img1, img2)
        img1, img2 = self.eraser_transform(img1, img2)
        img1_clean, img2_clean, img1, img2, flow, valid = self.spatial_transform(
            img1_clean, img2_clean, img1, img2, flow, valid
        )
        return tuple(
            np.ascontiguousarray(x)
            for x in (img1_clean, img2_clean, img1, img2, flow, valid)
        )


class FlowAugmentor(FlowAugmentorRTClean):
    """Upstream RAFT-Stereo dense augmentor (core/utils/augmentor.py:61-183):
    identical pipeline to the RTClean variant but without the clean outputs.
    Returns (img1, img2, flow)."""

    def __call__(self, img1, img2, flow):
        _, _, img1, img2, flow = super().__call__(img1, img2, flow)
        return img1, img2, flow


class SparseFlowAugmentor(SparseFlowAugmentorRTClean):
    """Upstream sparse augmentor (core/utils/augmentor.py:185-318): like the
    RTClean sparse variant but with asymmetric color p=0.2 (vs 1.0, :202) and
    no clean outputs. Returns (img1, img2, flow, valid)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.asymmetric_color_aug_prob = 0.2

    def __call__(self, img1, img2, flow, valid):
        _, _, img1, img2, flow, valid = super().__call__(img1, img2, flow, valid)
        return img1, img2, flow, valid


class CropAugmentor:
    """Crop-only augmentor (core/utils/augmentor.py:490-536)."""

    def __init__(self, crop_size, rng: np.random.Generator | None = None, **_):
        self.crop_size = crop_size
        self.rng = rng or np.random.default_rng()

    def __call__(self, img1, img2, flow):
        rng = self.rng
        ch, cw = self.crop_size
        y0 = rng.integers(0, img1.shape[0] - ch)
        x0 = rng.integers(0, img1.shape[1] - cw)
        return tuple(
            np.ascontiguousarray(a[y0 : y0 + ch, x0 : x0 + cw])
            for a in (img1, img2, flow)
        )
