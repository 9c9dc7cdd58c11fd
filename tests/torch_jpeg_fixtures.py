"""Writes the JPEG fixtures of ``tests/data/torch_jpeg/`` with Pillow, from
seeded numpy textures, and the SHA-256 of what Pillow decodes from each.

The port decodes JPEG without PIL (``dkt_stereo_tpu_torch/data/jpeg.py``);
a machine without PIL checks its decoder against these hashes
(``chip_smoke.py``), and ``tests/test_torch_jpeg.py`` re-derives them with
Pillow, so the committed expectations cannot drift from Pillow's. Run from
the repository's root:

    python -m tests.torch_jpeg_fixtures

The files:

  - ``ft_{0,1}_{left,right}.jpg``: two FallingThings-shaped stereo pairs,
    540x960, baseline 4:2:0 at quality 90 (the dataset's own form), the
    right view the left one shifted by a smooth disparity;
  - ``progressive_444.jpg``: progressive, 4:4:4, optimized tables;
  - ``gray.jpg``: one component.

``hashes.json`` maps each name to its decoded shape, dtype and SHA-256.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent / "data" / "torch_jpeg"
PAIRS = [("ft_0_left.jpg", "ft_0_right.jpg"), ("ft_1_left.jpg", "ft_1_right.jpg")]


def texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth seeded RGB scene: a few low-frequency waves, soft blobs and
    faint noise, uint8 (H, W, 3)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for _ in range(6):
        fy, fx = rng.uniform(0.5, 6, 2) * 2 * np.pi / np.array([h, w])
        img += rng.uniform(10, 30, 3) * np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))[..., None]
    for _ in range(24):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        img += rng.uniform(-60, 60, 3) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[
            ..., None]
    img += 128 + rng.normal(0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def stereo_pair(rng: np.random.Generator, h: int, w: int):
    """A left view and the right view that sees it shifted left by a smooth
    disparity of 8-40 px."""
    pad = 48
    left = texture(rng, h, w + pad)
    disp = 24 + 16 * np.sin(np.linspace(0, np.pi, h))[:, None] * np.ones((1, w))
    cols = np.clip(np.arange(w)[None, :] + np.rint(disp).astype(int), 0, w + pad - 1)
    right = left[np.arange(h)[:, None], cols]
    return left[:, :w], right


def decoded_record(path: Path) -> dict:
    from PIL import Image

    a = np.array(Image.open(path))
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}


def write_all(out: Path = HERE) -> dict:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2024)
    for names in PAIRS:
        for name, img in zip(names, stereo_pair(rng, 540, 960)):
            Image.fromarray(img).save(out / name, "JPEG", quality=90, subsampling=2)
    Image.fromarray(texture(rng, 96, 136)).save(out / "progressive_444.jpg", "JPEG", quality=95,
                                                subsampling=0, progressive=True, optimize=True)
    Image.fromarray(texture(rng, 72, 104)[..., 1]).save(out / "gray.jpg", "JPEG", quality=75)
    names = [n for pair in PAIRS for n in pair] + ["progressive_444.jpg", "gray.jpg"]
    hashes = {n: decoded_record(out / n) for n in names}
    (out / "hashes.json").write_text(json.dumps(hashes, indent=1, sort_keys=True) + "\n")
    return hashes


if __name__ == "__main__":
    for name, rec in write_all().items():
        print(name, (HERE / name).stat().st_size, rec["shape"])
