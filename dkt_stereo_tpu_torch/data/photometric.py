"""Photometric augmentation on uint8 (H, W, 3) arrays, in numpy: the port's
copy of ``dkt_stereo_tpu/data/photometric.py`` without PIL.

The reference composes torchvision's ``ColorJitter(brightness=.4,
contrast=.4, saturation=<range>, hue=0.5/3.14)`` and ``AdjustGamma`` over PIL
images (core/utils/augmentor.py:561, :853; AdjustGamma at :48-59). The JAX
package rebuilds them on PIL's ``ImageEnhance`` and PIL's HSV conversion;
this module computes the same functions on arrays, to the bit, with each
expression of Pillow's C source (``libImaging/Blend.c``,
``libImaging/Convert.c``) beside its numpy form. The generator draws are
those of the JAX module, in the same order.
"""

from __future__ import annotations

import functools

import numpy as np

from dkt_stereo_tpu_torch.data.readers import luma

_F32, _F64 = np.float32, np.float64


def _rand_factor(rng, bound_or_range):
    """torchvision ColorJitter factor sampling: scalar b -> U[max(0, 1 - b),
    1 + b]; an explicit [lo, hi] range as it is."""
    if bound_or_range is None:
        return None
    if np.isscalar(bound_or_range):
        lo, hi = max(0.0, 1.0 - bound_or_range), 1.0 + bound_or_range
    else:
        lo, hi = bound_or_range
    return float(rng.uniform(lo, hi))


def blend(degenerate: np.ndarray, image: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(degenerate, image, alpha)`` on uint8 arrays, which every
    ``ImageEnhance`` class's ``enhance`` is (libImaging/Blend.c,
    ``ImagingBlend``; alpha reaches it as a C ``float``)::

        out = (UINT8)((int)in1 + alpha * ((int)in2 - (int)in1))   /* 0 <= alpha <= 1 */
        temp = (float)(...same...); out = temp <= 0 ? 0 : temp >= 255 ? 255 : (UINT8)temp

    in float32 arithmetic, truncated; the clip is a no-op inside [0, 1]."""
    a = degenerate.astype(_F32)
    d = image.astype(np.int32) - degenerate.astype(np.int32)
    out = a + _F32(alpha) * d.astype(_F32)
    return np.clip(out, 0, 255).astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness``: blend with a black image."""
    return blend(np.zeros_like(img), img, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast``: blend with a flat image at
    ``int(mean of the L histogram + 0.5)`` (``ImageStat.Stat(img.convert("L"))``;
    the mean is a Python float over the integer luma)."""
    hist = np.bincount(luma(img).ravel(), minlength=256)
    mean = int(float((hist * np.arange(256)).sum()) / float(hist.sum()) + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color``: blend with ``img.convert("L").convert("RGB")``."""
    gray = luma(img)
    return blend(np.repeat(gray[..., None], img.shape[-1], axis=-1), img, factor)


@functools.cache
def _hsv_tables():
    """Lookup tables of PIL's HSV conversions (libImaging/Convert.c), each
    entry computed with C's mix of precisions: the locals are ``float``
    (stored to float32 here), the literals ``double`` (float64), and a
    product of two floats is a float.

    ``rgb2hsv_row`` (maxc = max(r, g, b), minc = min, cr = maxc - minc)::

        cr = (float)(maxc - minc); s = cr / (float)maxc;
        rc = ((float)(maxc - r)) / cr;  gc, bc likewise
        r == maxc: h = bc - gc;  g == maxc: h = 2.0 + rc - bc;  else: h = 4.0 + gc - rc;
        h = fmod((h / 6.0 + 1.0), 1.0);
        uh = (UINT8)CLIP8((int)(h * 255.0)); us = (UINT8)CLIP8((int)(s * 255.0));

    ``h`` is a function of the two distances to ``maxc`` of the other
    channels (their larger one is ``cr``), so each branch is a 256 x 256
    table of ``uh``, indexed [first, second] in the order the branch's
    expression reads them: (dg, db), (dr, db), (dr, dg); ``us`` is a table
    over (cr, maxc).

    ``hsv2rgb``::

        i = floor((float)h * 6.0 / 255.0);
        f = (float)h * 6.0 / 255.0 - (float)i;  fs = ((float)s) / 255.0;
        p = round((float)v * (1.0 - fs)); q = round((float)v * (1.0 - fs * f));
        t = round((float)v * (1.0 - fs * (1.0 - f)));

    so ``i``, and the double factors ``1.0 - fs``, ``1.0 - fs * f`` and
    ``1.0 - fs * (1.0 - f)`` that multiply ``v``, are tables over h and
    (s, h)."""
    d = np.arange(256)
    d1, d2 = np.meshgrid(d, d, indexing="ij")
    cr = np.maximum(np.maximum(d1, d2), 1).astype(_F32)
    x1, x2 = d1.astype(_F32) / cr, d2.astype(_F32) / cr

    def to_uh(h):
        h = np.fmod(h.astype(_F64) / 6.0 + 1.0, 1.0).astype(_F32)
        return np.clip(np.trunc(h.astype(_F64) * 255.0), 0, 255).astype(np.uint8)

    uh_r = to_uh(x2 - x1)  # (dg, db): bc - gc
    uh_g = to_uh((2.0 + x1.astype(_F64) - x2).astype(_F32))  # (dr, db): 2.0 + rc - bc
    uh_b = to_uh((4.0 + x2.astype(_F64) - x1).astype(_F32))  # (dr, dg): 4.0 + gc - rc
    sat = d1.astype(_F32) / np.maximum(d2, 1).astype(_F32)  # (cr, maxc)
    us = np.clip(np.trunc(sat.astype(_F64) * 255.0), 0, 255).astype(np.uint8)

    hd = d.astype(_F64)
    i = np.floor(hd * 6.0 / 255.0).astype(np.int32)
    f = (hd * 6.0 / 255.0 - i).astype(_F32)
    fs = (d.astype(_F64) / 255.0).astype(_F32)
    w_p = 1.0 - fs.astype(_F64)
    w_q = 1.0 - (fs[:, None] * f[None, :]).astype(_F64)  # (s, h)
    w_t = 1.0 - fs.astype(_F64)[:, None] * (1.0 - f.astype(_F64))[None, :]
    return (uh_r.ravel(), uh_g.ravel(), uh_b.ravel(), us.ravel(), i % 6, w_p, w_q.ravel(),
            w_t.ravel())


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` of a uint8 RGB array (libImaging/Convert.c,
    ``rgb2hsv_row``; see :func:`_hsv_tables`): uh and us from tables, uv =
    maxc; uh = us = 0 where maxc == minc."""
    uh_r, uh_g, uh_b, us_t, *_ = _hsv_tables()
    rgb = img.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    dr, dg, db = maxc - r, maxc - g, maxc - b
    cr = np.maximum(np.maximum(dr, dg), db)
    uh = np.where(r == maxc, uh_r.take(dg * 256 + db),
                  np.where(g == maxc, uh_g.take(dr * 256 + db), uh_b.take(dr * 256 + dg)))
    # cr == 0 (maxc == minc) reads row 0 of each table, which holds 0
    return np.stack([uh, us_t.take(cr * 256 + maxc), maxc.astype(np.uint8)], axis=-1)


# hsv2rgb's (r, g, b) for i % 6, as positions in the stack (v, p, q, t)
_SECTORS = np.array([(0, 3, 1), (2, 0, 1), (1, 0, 3), (1, 2, 0), (3, 1, 0), (0, 1, 2)])


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a uint8 HSV array (libImaging/Convert.c,
    ``hsv2rgb``; see :func:`_hsv_tables`): ``round`` rounds halves away from
    zero (the products lie in [0, 255], so CLIP8 changes nothing), ``i %
    6`` picks (v,t,p) (q,v,p) (p,v,t) (p,q,v) (t,p,v) (v,p,q), and s == 0
    gives (v, v, v), which the tables give too (fs = 0)."""
    *_, sector, w_p, w_q, w_t = _hsv_tables()
    hsv = img.astype(np.int32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    vd, sh = v.astype(_F64), s * 256 + h
    out = np.empty(h.shape + (4,), np.uint8)
    out[..., 0] = v
    for j, w in ((1, w_p.take(s)), (2, w_q.take(sh)), (3, w_t.take(sh))):
        out[..., j] = np.floor(vd * w + 0.5)
    return np.take_along_axis(out, _SECTORS[sector.take(h)], axis=-1)


def adjust_hue(img: np.ndarray, hue_factor: float) -> np.ndarray:
    """torchvision's ``F_pil.adjust_hue`` as the JAX package runs it: the
    HSV round trip with the H channel rolled by ``int(hue_factor * 255)``
    modulo 256 (the round trip is not the identity, so it runs even when
    the roll is 0)."""
    hsv = rgb_to_hsv(img)
    shift = int(hue_factor * 255) % 256
    hsv[..., 0] = ((hsv[..., 0].astype(np.int16) + shift) % 256).astype(np.uint8)
    return hsv_to_rgb(hsv)


def adjust_gamma(arr: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    """torchvision adjust_gamma on uint8: 255 * gain * (x / 255)^gamma,
    clipped."""
    out = 255.0 * gain * np.power(arr.astype(np.float32) / 255.0, gamma)
    return np.clip(out, 0, 255).astype(np.uint8)


class ColorJitter:
    """torchvision ColorJitter (PIL backend) with an explicit numpy
    Generator: brightness, contrast, saturation and hue in a random order,
    each with a freshly drawn factor."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        order = rng.permutation(4)
        for idx in order:
            if idx == 0 and self.brightness:
                img = adjust_brightness(img, _rand_factor(rng, self.brightness))
            elif idx == 1 and self.contrast:
                img = adjust_contrast(img, _rand_factor(rng, self.contrast))
            elif idx == 2 and self.saturation:
                img = adjust_saturation(img, _rand_factor(rng, self.saturation))
            elif idx == 3 and self.hue:
                h = self.hue if np.isscalar(self.hue) else max(abs(self.hue[0]), abs(self.hue[1]))
                img = adjust_hue(img, float(rng.uniform(-h, h)))
        return img


class AdjustGamma:
    """core/utils/augmentor.py:48-59: a uniform gamma and gain a call."""

    def __init__(self, gamma_min=1.0, gamma_max=1.0, gain_min=1.0, gain_max=1.0):
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.gain_min, self.gain_max = gain_min, gain_max

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        gain = float(rng.uniform(self.gain_min, self.gain_max))
        gamma = float(rng.uniform(self.gamma_min, self.gamma_max))
        if gamma == 1.0 and gain == 1.0:
            return img
        return adjust_gamma(img, gamma, gain)


class PhotoAug:
    """ColorJitter, then AdjustGamma, over a uint8 (H, W, 3) array."""

    def __init__(self, brightness, contrast, saturation, hue, gamma=(1, 1, 1, 1)):
        self.jitter = ColorJitter(brightness, contrast, saturation, hue)
        self.gamma = AdjustGamma(*gamma)

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = self.jitter(np.ascontiguousarray(arr, dtype=np.uint8), rng)
        return np.array(self.gamma(img, rng), dtype=np.uint8)
