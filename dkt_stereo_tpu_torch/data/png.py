"""PNG decoding and encoding with the standard library's ``zlib`` and numpy.

The evaluation datasets (KITTI, Middlebury, ETH3D, Booster, Scene Flow)
store their images and disparity maps as PNG files, and a machine may lack
PIL and OpenCV, so the port reads and writes PNG itself:

  - :func:`decode` (or :func:`read`) takes 8-bit gray, gray + alpha, RGB and
    RGBA images, the same colour types at 16 bits (KITTI's ``disp_occ``
    maps are 16-bit gray), and palette images at 1, 2, 4 or 8 bits,
    expanded through ``PLTE`` to RGB. It undoes all five row filters, reads
    ``IHDR``, ``PLTE`` and ``IDAT``, checks every chunk's CRC and skips the
    ancillary chunks. Interlaced (Adam7) files and bit depths below 8
    outside palette images raise ``ValueError``.
  - :func:`encode` (or :func:`write`) writes gray, RGB and RGBA at 8 and
    16 bits (KITTI's flow maps are 16-bit RGB), every row with filter 0, or
    with ``adaptive=True`` each row with the filter libpng's heuristic
    picks (the least sum of the filtered bytes read as signed), as image
    files in the wild are written.

Samples come back as (H, W) for gray and (H, W, C) otherwise, uint8 or
uint16 (big-endian in the file, native in the array): what
``cv2.imread(path, IMREAD_UNCHANGED)`` gives with its channels in RGB order,
and what ``np.array(PIL.Image.open(path))`` gives for every type but palette
images, whose indices PIL keeps.

Filters 1-4 make each byte depend on its left, upper and upper-left
neighbours. The decoder reconstructs all rows at once along anti-diagonals
of (row, pixel) — every neighbour of a cell on diagonal t lies on diagonal
t - 1 or t - 2 — so it takes H + W vectorized steps instead of H * W scalar
ones, reading each diagonal's neighbours as slices of a skewed copy of the
image. Rows that all use filter 0 skip that walk.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["decode", "encode", "read", "write"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends without an IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters: ``raw`` holds ``height`` rows of a filter-type
    byte and ``row_bytes`` filtered bytes. Returns (height, row_bytes)
    uint8."""
    rows = raw.reshape(height, row_bytes + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one of 0-4")
    if not ftype.any():
        return np.ascontiguousarray(filt)
    # cells are pixels of bpp bytes (bytes when bpp is 1), held along
    # anti-diagonals: diag[t + 2, r + 1] is cell (r, x = t - r), so a cell's
    # left neighbour is diag[t + 1, r + 1], the one above diag[t + 1, r] and
    # the upper-left diag[t, r], all slices. Positions no cell maps to (x < 0,
    # the row above the image, diagonals -1 and -2) stay 0, the bytes PNG
    # puts outside the image.
    ncols = row_bytes // bpp
    rr, xx = np.mgrid[:height, :ncols]
    f = np.zeros((height + ncols - 1, height, bpp), np.int16)
    f[rr + xx, rr] = filt.reshape(height, ncols, bpp)
    diag = np.zeros((height + ncols + 1, height + 1, bpp), np.int16)
    kind = ftype[:, None].astype(np.int16)
    kinds = set(np.unique(ftype).tolist())
    for t in range(height + ncols - 1):
        r0, r1 = max(0, t - ncols + 1), min(height - 1, t) + 1
        a, b, c = diag[t + 1, r0 + 1:r1 + 1], diag[t + 1, r0:r1], diag[t, r0:r1]
        k = kind[r0:r1]
        pred = np.where(k == 1, a, 0)
        if 2 in kinds:
            pred = np.where(k == 2, b, pred)
        if 3 in kinds:
            pred = np.where(k == 3, (a + b) >> 1, pred)
        if 4 in kinds:
            pred = np.where(k == 4, _paeth(a, b, c), pred)
        diag[t + 2, r0 + 1:r1 + 1] = (f[t, r0:r1] + pred) & 0xFF
    return diag[rr + xx + 2, rr + 1].reshape(height, row_bytes).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """The samples of a PNG file's bytes: (H, W) for gray, (H, W, C)
    otherwise, uint8 or uint16; palette images expanded to RGB."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif not kind[:1].islower() and kind != b"IEND":
            raise ValueError(f"PNG critical chunk {kind!r} is not supported")
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    width, height, depth, ctype, method, fmethod, interlace = header
    if ctype not in _CHANNELS or method != 0 or fmethod != 0:
        raise ValueError(f"PNG colour type {ctype} / compression {method} / filter method "
                         f"{fmethod} is not valid")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported; re-save the file "
                         "without interlacing")
    if ctype == 3:
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"palette PNG bit depth {depth} is not 1, 2, 4 or 8")
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
    elif depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} (colour type {ctype}) is not supported: only "
                         "8 and 16 bits, and 1-8 bits for palette images")
    ch = _CHANNELS[ctype]
    row_bytes = (width * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = _unfilter(raw[:height * (row_bytes + 1)], height, row_bytes,
                     max(1, ch * depth // 8))
    if depth == 16:
        out = rows.view(">u2").astype(np.uint16).reshape(height, width, ch)
    elif depth == 8:
        out = rows.reshape(height, width, ch)
    else:  # palette indices packed several to a byte, most significant first
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        idx = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        out = idx.reshape(height, -1)[:, :width, None]
    if ctype == 3:
        idx = out[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError("palette PNG index past its PLTE entries")
        return palette[idx]
    return out[..., 0] if ch == 1 else out


def read(path) -> np.ndarray:
    """:func:`decode` of the file at ``path``."""
    return decode(Path(path).read_bytes())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Each row of ``rows`` (height, row_bytes) filtered with the type that
    gives the least sum of its bytes read as signed, ties to the lower
    type; returns (height, 1 + row_bytes) with the type byte first."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)]) & 0xFF
    cost = np.abs(cand.astype(np.uint8).view(np.int8).astype(np.int32)).sum(axis=2)
    kind = cost.argmin(axis=0)
    out = cand[kind, np.arange(len(x))].astype(np.uint8)
    return np.concatenate([kind.astype(np.uint8)[:, None], out], axis=1)


def encode(image: np.ndarray, adaptive: bool = False) -> bytes:
    """PNG bytes of a uint8 or uint16 (H, W), (H, W, 3) or (H, W, 4) image
    (gray, RGB, RGBA at 8 or 16 bits), every row with filter 0, or with
    ``adaptive`` each row with the filter that suits it best (see
    :func:`_filter_rows`)."""
    a = np.asarray(image)
    if a.dtype not in (np.uint8, np.uint16) or not (
            a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))):
        raise ValueError(f"encode takes uint8 or uint16 gray/RGB/RGBA, got {a.dtype} "
                         f"{a.shape}")
    depth = 8 * a.dtype.itemsize
    ctype = 0 if a.ndim == 2 else {3: 2, 4: 6}[a.shape[2]]
    height, width = a.shape[:2]
    rows = a.astype(a.dtype.newbyteorder(">")).view(np.uint8).reshape(height, -1)
    if adaptive:
        raw = _filter_rows(rows, _CHANNELS[ctype] * depth // 8)
    else:
        raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes()))
            + _chunk(b"IEND", b""))


def write(path, image: np.ndarray, adaptive: bool = False) -> None:
    """Write :func:`encode` of ``image`` to ``path``."""
    Path(path).write_bytes(encode(image, adaptive))
