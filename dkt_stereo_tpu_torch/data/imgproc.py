"""The OpenCV operations of the NeRF-Stereo triplet augmentor in numpy
(the card machine has no OpenCV), each one the arithmetic of OpenCV 5.0 on
x86 (its AVX2 dispatch), value for value:

  - :func:`rotation_matrix` is ``cv2.getRotationMatrix2D``;
  - :func:`warp_affine_linear` is ``cv2.warpAffine(img, M, (W, H),
    flags=INTER_LINEAR)`` of a uint8 image with ``BORDER_CONSTANT`` 0;
  - :func:`resize_nearest` is ``cv2.resize(..., INTER_NEAREST)`` in both its
    ``fx``/``fy`` and its ``dsize`` form;
  - :func:`bgr_to_gray` is ``cv2.cvtColor(img, COLOR_BGR2GRAY)`` of uint8.

``cv2.resize(INTER_LINEAR)`` is ``augmentor._resize_linear``.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_F64 = np.float64
# OpenCV's warp kernels run the vector loop over 2 x 8 float32 lanes (AVX2)
# and finish a row's last ``W % 16`` pixels with scalar code
_WARP_LANES = 16


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the (2, 3) float64
    matrix of a rotation by ``angle`` degrees about ``center`` (x, y),
    which OpenCV takes as float32."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, _F64) * np.asarray(b, _F64) + np.asarray(c, _F64)).astype(_F32)


def _invert_affine(m) -> np.ndarray:
    """warpAffine's inverse of a forward (2, 3) map, in double, in its
    order of operations; returned as the float32 matrix the kernels use."""
    m = [float(v) for v in np.asarray(m, _F64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.asarray(m, _F32)


def warp_affine_linear(img: np.ndarray, m) -> np.ndarray:
    """``cv2.warpAffine(img, m, (W, H), flags=cv2.INTER_LINEAR)`` of a uint8
    (H, W) or (H, W, C) image, the border constant 0.

    The map is inverted in double and cast to float32. A destination
    pixel's source coordinate is ``fma(M0, x, y*M1 + M2)`` in the vector
    loop and ``fma(x, M0, y*M1) + M2`` in the scalar tail of the row
    (float32). Each of the four taps outside the image reads 0; the taps
    are lerped along x, then along y, each lerp ``fma(t, b - a, a)`` in
    float32, and rounded half to even."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise TypeError(f"warp_affine_linear takes uint8, got {a.dtype}")
    H, W = a.shape[:2]
    mi = _invert_affine(m)
    ys, xs = np.mgrid[0:H, 0:W].astype(_F32)
    row_x = (ys * mi[1]) + mi[2]
    row_y = (ys * mi[4]) + mi[5]
    sx = _fma32(mi[0], xs, row_x)
    sy = _fma32(mi[3], xs, row_y)
    tail = W - W % _WARP_LANES
    if tail < W:
        xt, yt = xs[:, tail:], ys[:, tail:]
        sx[:, tail:] = _fma32(xt, mi[0], yt * mi[1]) + mi[2]
        sy[:, tail:] = _fma32(xt, mi[3], yt * mi[4]) + mi[5]
    fx, fy = np.floor(sx), np.floor(sy)
    alpha, beta = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    src = a.reshape(H, W, -1).astype(_F32)

    def tap(x, y):
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        v = src[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]
        return np.where(inside[..., None], v, _F32(0))

    p00, p01 = tap(ix, iy), tap(ix + 1, iy)
    p10, p11 = tap(ix, iy + 1), tap(ix + 1, iy + 1)
    v0 = _fma32(alpha, p01 - p00, p00)
    v1 = _fma32(alpha, p11 - p10, p10)
    v = _fma32(beta, v1 - v0, v0)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out.reshape(a.shape)


def resize_nearest(img: np.ndarray, dsize=None, fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=INTER_NEAREST)``
    of any dtype: ``dsize`` (width, height), or None and the output
    ``round(W * fx)`` x ``round(H * fy)`` (halves to even). Destination
    index ``i`` reads ``min(floor(i * (1 / f)), size - 1)`` in double, with
    ``f = fx`` or ``dsize[0] / W`` (and so for y)."""
    a = np.asarray(img)
    H, W = a.shape[:2]
    if dsize is None:
        wo, ho = int(round(W * fx)), int(round(H * fy))
    else:
        wo, ho = int(dsize[0]), int(dsize[1])
        fx, fy = wo / W, ho / H
    sx = np.minimum(np.floor(np.arange(wo) * (1.0 / fx)).astype(np.int64), W - 1)
    sy = np.minimum(np.floor(np.arange(ho) * (1.0 / fy)).astype(np.int64), H - 1)
    return a[sy][:, sx]


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` of a uint8 (H, W, 3)
    image: ``(3735 c0 + 19235 c1 + 9798 c2 + 2^14) >> 15`` with channel 0
    taking blue's weight."""
    c = np.asarray(img).astype(np.int32)
    gray = (3735 * c[..., 0] + 19235 * c[..., 1] + 9798 * c[..., 2] + (1 << 14)) >> 15
    return gray.astype(np.uint8)
