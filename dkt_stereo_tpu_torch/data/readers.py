"""Stereo dataset file readers (host-side, numpy): the port's copy of
``dkt_stereo_tpu/data/readers.py`` with the same decoding math (the
reference's core/utils/frame_utils.py, file:line cited per function).

PNG files go through :mod:`dkt_stereo_tpu_torch.data.png`, JPEG files
through :mod:`dkt_stereo_tpu_torch.data.jpeg` and binary PPM/PGM files
through :func:`readPPM` on every machine, so no image library is needed:
each gives the bytes ``np.array(PIL.Image.open(path))`` gives.
:func:`read_gen` returns numpy arrays where the JAX reader returns a
``PIL.Image``.

The training readers (KITTI flow, Sintel, FallingThings, TartanAir) read
their PNG files the same way: :func:`png.read` gives 16-bit RGB in RGB order,
where the JAX package's ``cv2.imread`` gives BGR and flips it.
"""

from __future__ import annotations

import json
import re
from os.path import basename, exists, splitext

import numpy as np

from dkt_stereo_tpu_torch.data import jpeg, png


def readPFM(path: str) -> np.ndarray:
    """Middlebury PFM (frame_utils.py:62-97): header, endian scale, flipud."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape))


def writePFM(path: str, array: np.ndarray) -> None:
    """Grayscale little-endian PFM (frame_utils.py:99-109)."""
    assert array.ndim == 2 and splitext(path)[1] == ".pfm"
    H, W = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{W} {H}\n".encode())
        f.write(b"-1\n")
        f.write(np.flip(array, axis=0).astype("<f4").tobytes())


def readFlow(path: str) -> np.ndarray:
    """.flo Middlebury optical flow (frame_utils.py:41-60)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError(f"{path}: bad .flo magic")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def readFlowKITTI(path: str):
    """16-bit KITTI flow png: (v - 2^15) / 64 and the validity channel
    (frame_utils.py:145-150)."""
    flow = png.read(path)[:, :, :3].astype(np.float32)
    flow, valid = flow[:, :, :2], flow[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def writeFlowKITTI(path: str, uv: np.ndarray) -> None:
    """frame_utils.py:198-202: (64 uv + 2^15, 1) as a 16-bit RGB png."""
    uv = 64.0 * uv + 2**15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    png.write(path, np.concatenate([uv, valid], axis=-1).astype(np.uint16))


def readDispKITTI(path: str):
    """16-bit disparity png / 256 (frame_utils.py:152-155)."""
    disp = png.read(path) / 256.0
    return disp, disp > 0.0


def readDispSintelStereo(path: str):
    """RGB-packed disparity and the occlusion mask beside it
    (frame_utils.py:158-164). The reference computes ``d_r * 4`` on the raw
    uint8 channel, which wraps modulo 256 for disparities of 256 px and more
    (70 * 4 -> 24); decoded in float here, as in the JAX package."""
    a = png.read(path).astype(np.float32)
    d_r, d_g, d_b = np.split(a, axis=2, indices_or_sections=3)
    disp = (d_r * 4 + d_g / (2**6) + d_b / (2**14))[..., 0]
    mask = png.read(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def readDispFallingThings(path: str):
    """fx * baseline (6 cm, x 100) / depth, the depth a 16-bit png and fx
    from the camera json beside it (frame_utils.py:167-174)."""
    a = png.read(path)
    with open("/".join(path.split("/")[:-1] + ["_camera_settings.json"])) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a.astype(np.float32)
    return disp, disp > 0


def readDispTartanAir(path: str):
    """80 / depth from the .npy depth (frame_utils.py:177-181)."""
    depth = np.load(path)
    disp = 80.0 / depth
    return disp, disp > 0


def readDispMiddlebury(path: str):
    """GT pfm + mask0nocc==255, or estimate pfm with <1e3 validity
    (frame_utils.py:184-196)."""
    if basename(path) == "disp0GT.pfm":
        disp = readPFM(path).astype(np.float32)
        assert disp.ndim == 2
        nocc = path.replace("disp0GT.pfm", "mask0nocc.png")
        assert exists(nocc), nocc
        nocc_pix = png.read(nocc) == 255
        assert np.any(nocc_pix)
        return disp, nocc_pix
    if basename(path) == "disp0.pfm":
        disp = readPFM(path).astype(np.float32)
        return disp, disp < 1e3
    raise ValueError(f"unrecognized Middlebury disparity file {path!r}")


def readDispBooster(path: str):
    """Booster disp_00.npy GT. The reference loads it via read_gen and the
    dataset base class masks 0 < disp < 512 (core/stereo_datasets.py:83);
    the same bounds are applied here."""
    disp = np.load(path)
    return disp, (disp > 0) & (disp < 512)


_PNM_SPACE = b" \t\n\x0b\x0c\r"


def readPPM(path: str) -> np.ndarray:
    """Binary PGM (P5) and PPM (P6), as Pillow's ``PpmImagePlugin`` reads
    them: the header's width, height and maxval (1-65535) are whitespace-
    separated tokens, ``#`` starts a comment to the end of its line, and the
    samples start after the one whitespace byte that ends maxval. Samples
    are one byte below maxval 256, else two, big-endian. P5 at maxval 255
    gives (H, W) uint8; above 255 (H, W) int32 (Pillow's ``I``), scaled to
    0-65535 as ``min(65535, round(v / maxval * 65535))`` unless maxval is
    65535. P6 gives (H, W, 3) uint8, scaled to 0-255 the same way unless
    maxval is 255; so is P5 below 255. Other magic numbers raise
    ``NotImplementedError``."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P5", b"P6") or (len(data) > 2 and data[2] not in _PNM_SPACE):
        raise NotImplementedError(f"{path}: only binary PGM (P5) and PPM (P6) are supported")
    pos, tokens = 3, []
    while len(tokens) < 3:
        token = b""
        while pos < len(data):
            c = data[pos:pos + 1]
            pos += 1
            if c in _PNM_SPACE:
                if token:
                    break
            elif c == b"#":
                while pos < len(data) and data[pos] not in b"\r\n":
                    pos += 1
                pos += 1
            else:
                token += c
        if not token:
            raise ValueError(f"{path}: reached the end of the file in the PPM header")
        tokens.append(int(token))
    width, height, maxval = tokens
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PPM maxval must be in 1-65535, got {maxval}")
    bands = 1 if magic == b"P5" else 3
    n = width * height * bands
    raw = np.frombuffer(data, np.uint8 if maxval < 256 else ">u2", n, pos).astype(np.int64)
    shape = (height, width) if bands == 1 else (height, width, 3)
    if bands == 1 and maxval > 255:
        out_max, dtype = 65535, np.int32
    else:
        out_max, dtype = 255, np.uint8
    if maxval != out_max:
        raw = np.minimum(out_max, np.rint(raw / maxval * out_max))
    return raw.astype(dtype).reshape(shape)


def read_gen(path: str):
    """Generic reader (frame_utils.py:205-224): images as numpy arrays (PNG
    by :mod:`png`, JPEG by :mod:`jpeg`, PPM by :func:`readPPM`), ``.npy`` /
    ``.bin`` / ``.raw``
    arrays, ``.flo`` flow, ``.pfm`` maps; ``[]`` for other extensions."""
    ext = splitext(path)[-1]
    if ext == ".png":
        return png.read(path)
    if ext in (".jpeg", ".jpg"):
        return jpeg.read(path)
    if ext == ".ppm":
        return readPPM(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return readFlow(path).astype(np.float32)
    if ext == ".pfm":
        flow = readPFM(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []


def read_image_rgb(path: str) -> np.ndarray:
    """uint8 H×W×3 image; grayscale tiled to 3 channels (the dataset layer's
    convention, core/stereo_datasets.py:96-104)."""
    img = np.array(read_gen(path)).astype(np.uint8)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    else:
        img = img[..., :3]
    return img


def luma(image: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` as integers: ``(R*19595 + G*38470 + B*7471 +
    0x8000) >> 16`` of a (H, W, 3) or (H, W, 4) uint8 image (alpha ignored);
    a (H, W) image is returned as it is."""
    a = np.asarray(image)
    if a.ndim == 2:
        return a
    rgb = a[..., :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
