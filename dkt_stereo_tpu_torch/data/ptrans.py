"""PTrans, the self-supervised patch transform (``dkt_stereo_tpu/data/ptrans.py``;
the reference's core/utils/augmentor.py:724-832), in numpy without PIL.

It samples N disparity-matched left/right patch pairs and makes
``num_view`` augmented views of each patch, SimCLR's pipeline: a random
resized crop, a horizontal flip (p 0.5), colour jitter (p 0.8), grayscale
(p 0.2), a Gaussian blur (p 0.1) and solarization (p 0.1). GWCNet's
``ptrans`` head reads the views (``models/gwcnet.py``).

The JAX module runs the pipeline on PIL images; every step here computes
Pillow's uint8 arithmetic to the bit, with the C source it follows named
beside it, and draws from the generator in the same order, so the same
``np.random.Generator`` state gives the same arrays.
"""

from __future__ import annotations

import math

import numpy as np

from dkt_stereo_tpu_torch.data.photometric import ColorJitter
from dkt_stereo_tpu_torch.data.readers import luma

_PRECISION_BITS = 32 - 8 - 2  # libImaging/Resample.c


def _bilinear_coeffs(in_size: int, in0: float, in1: float, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` of
    libImaging/Resample.c for the bilinear filter (support 1): per output
    sample its first input index, its tap count and 22-bit fixed-point
    weights (B, K) int64, zero past the count. ``in0``/``in1`` arrive as C
    floats (the box)."""
    in0, in1 = float(np.float32(in0)), float(np.float32(in1))
    scale = float(np.float32(in1 - in0)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)])
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        bounds[xx] = xmin, xmax
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + kk * (1 << _PRECISION_BITS))).astype(np.int64)
    return bounds, fixed


def _resample_axis(img: np.ndarray, axis: int, bounds, fixed) -> np.ndarray:
    """One pass of ``ImagingResampleHorizontal_8bpc`` / ``Vertical``:
    ``clip8(2^21 + sum(in * k))``, ``clip8`` shifting 22 bits down and
    clamping to [0, 255]."""
    src = np.moveaxis(img.astype(np.int64), axis, 0)
    n = src.shape[0]
    acc = np.full((len(bounds),) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(fixed.shape[1]):
        idx = np.minimum(bounds[:, 0] + k, n - 1)
        w = np.where(k < bounds[:, 1], fixed[:, k], 0)
        acc += src[idx] * w.reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size, box=None) -> np.ndarray:
    """Pillow's ``Image.resize(size, BILINEAR, box)`` of a uint8 (H, W, C)
    array (libImaging/Resample.c, ``ImagingResampleInner``): the box's
    region resampled to ``size`` (W, H) by a horizontal pass over the rows
    the vertical pass needs, rounded to uint8, then a vertical pass. A
    downscale widens the triangle filter by the scale (antialiasing)."""
    H, W = img.shape[:2]
    out_w, out_h = size
    x0, y0, x1, y1 = (0, 0, W, H) if box is None else box
    if (out_w, out_h) == (W, H) and (x0, y0, x1, y1) == (0, 0, W, H):
        return img.copy()
    bh, kh = _bilinear_coeffs(W, x0, x1, out_w)
    bv, kv = _bilinear_coeffs(H, y0, y1, out_h)
    if out_w != W or x0 or x1 != out_w:
        first, last = bv[0, 0], bv[-1, 0] + bv[-1, 1]
        img = _resample_axis(img[first:last], 1, bh, kh)
        bv = bv - np.array([first, 0])
    if out_h != H or y0 or y1 != out_h:
        img = _resample_axis(img, 0, bv, kv)
    return img


def _box_blur_line(a: np.ndarray, axis: int, radius_f: np.float32) -> np.ndarray:
    """``ImagingHorizontalBoxBlur`` along ``axis`` (libImaging/BoxBlur.c):
    a window of ``2 r + 1`` edge-replicated samples at weight ``ww`` and the
    next sample on each side at weight ``fw`` (the fractional radius), in
    24-bit fixed point, rounded to uint8. ``ww`` is the C float quotient
    ``(1 << 24) / (2 radius + 1)`` truncated to an integer."""
    r = int(radius_f)
    ww = int(np.float32(1 << 24) / (radius_f * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    src = np.moveaxis(a.astype(np.int64), axis, 0)
    n = src.shape[0]
    idx = np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)
    pad = src[idx]  # pad[j] = src[clamp(j - r - 1)]
    csum = np.concatenate([np.zeros((1,) + src.shape[1:], np.int64), np.cumsum(pad, axis=0)])
    x = np.arange(n)
    acc = csum[x + 2 * r + 2] - csum[x + 1]  # samples x - r .. x + r
    bulk = acc * ww + (pad[x] + pad[x + 2 * r + 2]) * fw
    out = ((bulk + (1 << 23)) >> 24).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _gaussian_blur_radius(radius: float, passes: int = 3) -> np.float32:
    """``_gaussian_blur_radius`` of libImaging/BoxBlur.c in C float
    arithmetic: the extended box radius whose ``passes`` box blurs have the
    Gaussian's variance (Gwosdek et al., SSVM 2011)."""
    f = np.float32
    sigma2 = f(radius) * f(radius) / f(passes)
    L = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l_ = f(math.floor((float(L) - 1.0) / 2.0))
    a = (f(2) * l_ + f(1)) * (l_ * (l_ + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (l_ + f(1)) * (l_ + f(1))))
    return l_ + a


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``img.filter(ImageFilter.GaussianBlur(radius))`` of a uint8 (H, W, C)
    array: three extended box blurs along the rows, then three along the
    columns (``ImagingGaussianBlur``, ``ImagingBoxBlur``)."""
    if radius == 0:
        return img.copy()
    r = _gaussian_blur_radius(radius)
    if r == 0:
        return img.copy()
    for axis in (1, 0):
        for _ in range(3):
            img = _box_blur_line(img, axis, r)
    return img


def hflip(img: np.ndarray) -> np.ndarray:
    """``img.transpose(FLIP_LEFT_RIGHT)``."""
    return img[:, ::-1]


def solarize(img: np.ndarray, threshold: int = 128) -> np.ndarray:
    """``ImageOps.solarize``: values at or above ``threshold`` inverted."""
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def grayscale_rgb(img: np.ndarray) -> np.ndarray:
    """``img.convert("L").convert("RGB")``: Pillow's integer luma in every
    channel."""
    return np.repeat(luma(img)[..., None], 3, axis=-1)


def _random_resized_crop(img: np.ndarray, out_size: int, rng, scale=(0.08, 1.0),
                         ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """The JAX module's random resized crop, its draws in its order: ten
    tries at a box of the sampled area and aspect, else the whole image."""
    H, W = img.shape[:2]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            x0 = int(rng.integers(0, W - w + 1))
            y0 = int(rng.integers(0, H - h + 1))
            return resize_bilinear(img, (out_size, out_size), (x0, y0, x0 + w, y0 + h))
    return resize_bilinear(img, (out_size, out_size))


class PTrans:
    """``PTrans(num_patch, patch_r, num_view, cropscale, rng)(img1, img2,
    disp)`` with img1/img2 (H, W, 3) uint8 and disp (H, W) positive
    disparity returns (left_patches, right_patches (N, P, P, 3), augp1,
    augp2 (N, V, cropscale, cropscale, 3)) float32, P = 2 patch_r + 1."""

    def __init__(self, num_patch=32, patch_r=32, num_view=4, cropscale=64,
                 rng: np.random.Generator | None = None):
        self.num_patch = num_patch
        self.patch_r = patch_r
        self.num_view = num_view
        self.cropscale = cropscale
        self.jitter = ColorJitter(0.4, 0.4, 0.4, 0.2)
        self.rng = rng or np.random.default_rng()

    def _view_transform(self, arr: np.ndarray) -> np.ndarray:
        rng = self.rng
        img = _random_resized_crop(arr, self.cropscale, rng)
        if rng.random() < 0.5:
            img = hflip(img)
        if rng.random() < 0.8:
            img = self.jitter(np.ascontiguousarray(img), rng)
        if rng.random() < 0.2:
            img = grayscale_rgb(img)
        if rng.random() < 0.1:
            img = gaussian_blur(img, rng.random() * 1.9 + 0.1)
        if rng.random() < 0.1:
            img = solarize(img)
        return np.ascontiguousarray(img, dtype=np.uint8)

    def __call__(self, img1: np.ndarray, img2: np.ndarray, disp: np.ndarray):
        rng = self.rng
        H, W = disp.shape
        r = self.patch_r
        P = 2 * r + 1
        N = self.num_patch

        ys = rng.integers(P // 2 + 1, H - 1 - P // 2, N)
        xs = rng.integers(P // 2 + 1, W - 1 - P // 2, N)

        def extract(img, cy, cx):
            out = np.zeros((P, P, 3), img.dtype)
            y0, y1 = cy - r, cy + r + 1
            x0, x1 = cx - r, cx + r + 1
            sy0, sx0 = max(0, y0), max(0, x0)
            sy1, sx1 = min(H, y1), min(W, x1)
            out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
            return out

        left_patches, right_patches, augp1, augp2 = [], [], [], []
        for cy, cx in zip(ys, xs):
            d = int(round(float(disp[cy, cx])))
            cx2 = int(np.clip(cx - d, 0, W - 1))
            p1 = extract(img1, int(cy), int(cx))
            p2 = extract(img2, int(cy), cx2)
            left_patches.append(p1)
            right_patches.append(p2)
            augp1.append(np.stack([self._view_transform(p1) for _ in range(self.num_view)]))
            augp2.append(np.stack([self._view_transform(p2) for _ in range(self.num_view)]))

        return (np.stack(left_patches).astype(np.float32),
                np.stack(right_patches).astype(np.float32),
                np.stack(augp1).astype(np.float32),
                np.stack(augp2).astype(np.float32))
