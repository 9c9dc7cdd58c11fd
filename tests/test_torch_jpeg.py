"""The port's JPEG and PPM reading (``data/jpeg.py``, ``data/readers.py``)
against Pillow: every decoded byte equal to the JAX package's
``np.array(readers.read_gen(path))``, which opens the file with PIL.

The JPEG files are written here by Pillow (subsampling 4:4:4, 4:2:2,
4:2:0; qualities 5-100; optimized, progressive, restart markers,
grayscale, 16-bit quantisation tables) and by OpenCV where Pillow cannot
write the sampling (4:4:0, 4:1:1), at widths and heights 1-17, 33 and up to
64x96. A few are patched byte by byte: an Adobe marker that says RGB,
quantisation tables that overflow the 16-bit IDCT, and the frame markers
the decoder refuses. The committed fixtures of ``tests/data/torch_jpeg/``
are checked against Pillow's decode of them.
"""

import hashlib
import io
import json
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from dkt_stereo_tpu.data import readers as jreaders
from dkt_stereo_tpu_torch.data import jpeg, readers
from tests import torch_jpeg_fixtures as fixtures

SIZES = [(h, w) for w, h in zip(range(1, 18), [5, 1, 17, 2, 9, 16, 3, 8, 13, 1, 11, 4, 17, 7,
                                                 10, 15, 6])] + [(33, 33), (17, 33), (64, 96)]


def _texture(rng, h, w, c=3):
    """Smooth waves with noise of a seeded strength, uint8."""
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(xx / rng.uniform(1.5, 9)) * 60 + np.cos(yy / rng.uniform(1.5, 9)) * 60 + 128
    img = base[..., None] + rng.normal(0, rng.uniform(4, 50), (h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., 0]


def _write(tmp_path, name, data: bytes):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _same(path):
    """The port's ``read_gen`` equals the JAX package's PIL read."""
    got = readers.read_gen(path)
    want = np.array(jreaders.read_gen(path))
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.shape, want.shape)
    assert np.array_equal(got, want), (path, int(np.sum(got != want)))


@pytest.mark.parametrize("quality", [5, 50, 90, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_sampling_and_quality_match_pil(tmp_path, subsampling, quality):
    """4:4:4, 4:2:2 and 4:2:0 at each quality and size: the fancy
    upsamplers' edge columns and rows, the replication of components at
    most two samples wide, the partial MCUs."""
    rng = np.random.default_rng(100 * subsampling + quality)
    for h, w in SIZES:
        data = _pil_jpeg(_texture(rng, h, w), quality=quality, subsampling=subsampling)
        _same(_write(tmp_path, f"s{h}x{w}.jpg", data))


@pytest.mark.parametrize("factor", ["440", "411", "422", "420"])
def test_jpeg_cv2_sampling_factors_match_pil(tmp_path, factor):
    """Sampling Pillow cannot write, written by OpenCV: 4:4:0 (h1v2 fancy
    upsampling) and 4:1:1 (replication), with 4:2:2 and 4:2:0 beside them."""
    rng = np.random.default_rng(int(factor))
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    for h, w in SIZES:
        ok, enc = cv2.imencode(".jpg", _texture(rng, h, w), [
            cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(40, 101)),
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        assert ok
        _same(_write(tmp_path, f"c{h}x{w}.jpg", enc.tobytes()))


OPTIONS = {
    "optimize": dict(optimize=True, subsampling=2),
    "progressive": dict(progressive=True, subsampling=2),
    "progressive_optimize_444": dict(progressive=True, optimize=True, subsampling=0),
    "progressive_422": dict(progressive=True, subsampling=1),
    "restart_blocks": dict(restart_marker_blocks=3, subsampling=2),
    "restart_rows": dict(restart_marker_rows=1, subsampling=1),
    "restart_progressive": dict(restart_marker_blocks=2, progressive=True, subsampling=2),
    "qtables_16bit": dict(qtables=[[300 + i for i in range(64)], [1 + 4 * i for i in range(64)]],
                          subsampling=2),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_jpeg_options_match_pil(tmp_path, option):
    """Optimized Huffman tables, progressive scan scripts (spectral
    selection, successive approximation, EOB runs), restart intervals,
    16-bit quantisation tables; colour and grayscale."""
    rng = np.random.default_rng(len(option))
    for h, w in SIZES[::2]:
        for c in (3, 1):
            kw = dict(OPTIONS[option], quality=int(rng.integers(30, 101)))
            if c == 1:
                kw.pop("subsampling")
            data = _pil_jpeg(_texture(rng, h, w, c), **kw)
            _same(_write(tmp_path, f"o{h}x{w}_{c}.jpg", data))


def _replace_app0(data: bytes, segment: bytes) -> bytes:
    """``data`` with its JFIF APP0 segment replaced by ``segment``."""
    assert data[2:4] == b"\xff\xe0"
    n = int.from_bytes(data[4:6], "big")
    return data[:2] + segment + data[4 + n:]


def test_jpeg_colour_space_markers_match_pil(tmp_path):
    """libjpeg's choice of colour space without JFIF: an Adobe marker with
    transform 0 means RGB (no conversion), 1 means YCbCr; component ids
    'R', 'G', 'B' mean RGB; JFIF wins over Adobe."""
    rng = np.random.default_rng(7)
    data = _pil_jpeg(_texture(rng, 21, 30), quality=85, subsampling=0)
    adobe = lambda t: b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([t])  # noqa: E731
    variants = {"adobe0": _replace_app0(data, adobe(0)), "adobe1": _replace_app0(data, adobe(1)),
                "jfif_adobe0": data[:2] + adobe(0) + data[2:]}
    sof = data.index(b"\xff\xc0")
    rgb_ids = bytearray(_replace_app0(data, b""))
    s = rgb_ids.index(b"\xff\xc0")
    for k, cid in enumerate(b"RGB"):
        rgb_ids[s + 10 + 3 * k] = cid
    sos = rgb_ids.index(b"\xff\xda")
    for k, cid in enumerate(b"RGB"):
        rgb_ids[sos + 5 + 2 * k] = cid
    variants["rgb_ids"] = bytes(rgb_ids)
    assert sof > 0
    for name, v in variants.items():
        _same(_write(tmp_path, f"{name}.jpg", v))
    assert not np.array_equal(readers.read_gen(str(tmp_path / "adobe0.jpg")),
                              readers.read_gen(str(tmp_path / "adobe1.jpg")))


@pytest.mark.parametrize("q", [40, 90, 180, 255])
def test_jpeg_idct_overflow_matches_pil(tmp_path, q):
    """Quality-100 blocks requantised by a large table: the samples leave
    the range by hundreds, and dequantised coefficients overflow 16 bits.
    libjpeg-turbo's SIMD IDCT saturates and wraps where its 16-bit lanes do
    (neither a plain clip nor the C code's range-limit table gives Pillow's
    bytes here)."""
    rng = np.random.default_rng(q)
    for k, img in enumerate([rng.integers(0, 256, (16, 24), dtype=np.uint8),
                             (np.indices((16, 24)).sum(0) % 2 * 255).astype(np.uint8),
                             _texture(rng, 16, 24)]):
        data = bytearray(_pil_jpeg(img, quality=100, subsampling=2))
        i = data.find(b"\xff\xdb")
        while i >= 0:  # every 8-bit table of every DQT segment
            end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
            for t in range(i + 4, end, 65):
                data[t + 1:t + 65] = bytes([q]) * 64
            i = data.find(b"\xff\xdb", end)
        _same(_write(tmp_path, f"q{q}_{k}.jpg", bytes(data)))


def test_jpeg_unsupported_forms_raise(tmp_path):
    """Lossless, arithmetic-coded and 12-bit frames and four components
    raise NotImplementedError naming what they use; a cut file raises a
    ValueError naming itself."""
    data = _pil_jpeg(_texture(np.random.default_rng(3), 16, 16), quality=80)
    s = data.index(b"\xff\xc0")
    for marker, match in ((0xC3, "SOF3"), (0xC9, "SOF9"), (0xCA, "SOF10")):
        bad = data[:s + 1] + bytes([marker]) + data[s + 2:]
        with pytest.raises(NotImplementedError, match=match):
            readers.read_gen(_write(tmp_path, f"sof{marker:x}.jpg", bad))
    bad = data[:s + 4] + b"\x0c" + data[s + 5:]
    with pytest.raises(NotImplementedError, match="12-bit"):
        readers.read_gen(_write(tmp_path, "p12.jpg", bad))
    buf = io.BytesIO()
    Image.fromarray(_texture(np.random.default_rng(4), 16, 16)).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="4 components"):
        readers.read_gen(_write(tmp_path, "cmyk.jpg", buf.getvalue()))
    with pytest.raises(ValueError, match="cut.jpg"):
        readers.read_gen(_write(tmp_path, "cut.jpg", data[:60]))


def _pnm(magic: bytes, w: int, h: int, maxval: int, samples: np.ndarray, header=None) -> bytes:
    head = header or b"%s\n# a comment\n%d %d\n%d\n" % (magic, w, h, maxval)
    dtype = np.uint8 if maxval < 256 else ">u2"
    return head + samples.astype(dtype).tobytes()


@pytest.mark.parametrize("maxval", [255, 65535, 1000, 100, 1])
def test_ppm_matches_pil(tmp_path, maxval):
    """Binary P5 and P6 at 8 and 16 bits, full range and scaled, with a
    header comment and a token split by one: Pillow's modes ``L``, ``I``
    and ``RGB`` and its rounding."""
    rng = np.random.default_rng(maxval)
    for magic, c in ((b"P5", 1), (b"P6", 3)):
        h, w = 7, 11
        samples = rng.integers(0, maxval + 1, (h, w, c))
        path = _write(tmp_path, f"{magic.decode()}_{maxval}.ppm", _pnm(magic, w, h, maxval, samples))
        _same(path)
    odd = _pnm(b"P6", 3, 2, 255, rng.integers(0, 256, (2, 3, 3)),
               header=b"P6 3#c\n 2\t255\r")
    _same(_write(tmp_path, "odd_header.ppm", odd))
    with pytest.raises(NotImplementedError, match="P5"):
        readers.read_gen(_write(tmp_path, "plain.ppm", b"P3\n1 1\n255\n1 2 3\n"))


def test_jpeg_fixtures_match_pil_and_read_without_pil(monkeypatch):
    """The committed fixtures' hashes are Pillow's decode of the committed
    files today, and the port, with PIL unimportable, reads every fixture
    to those bytes (the check ``chip_smoke.py`` makes on a machine without
    PIL)."""
    recorded = json.loads((fixtures.HERE / "hashes.json").read_text())
    assert sorted(recorded) == sorted([n for p in fixtures.PAIRS for n in p]
                                      + ["progressive_444.jpg", "gray.jpg"])
    for name, rec in recorded.items():
        assert fixtures.decoded_record(fixtures.HERE / name) == rec, name
    monkeypatch.setitem(sys.modules, "PIL", None)
    for name, rec in recorded.items():
        a = jpeg.read(fixtures.HERE / name)
        assert [list(a.shape), str(a.dtype)] == [rec["shape"], rec["dtype"]], name
        assert hashlib.sha256(a.tobytes()).hexdigest() == rec["sha256"], name
