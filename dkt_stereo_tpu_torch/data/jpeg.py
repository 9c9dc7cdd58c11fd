"""JPEG decoding with numpy and the standard library, to the byte of what
``np.array(PIL.Image.open(path))`` gives with Pillow on libjpeg-turbo.

FallingThings stores its images as JPEG and a machine may lack PIL, so the
port reads JPEG itself. :func:`decode` (or :func:`read`) takes 8-bit
Huffman-coded files: baseline and extended sequential (SOF0, SOF1) and
progressive (SOF2), with one component (returned as (H, W) uint8, PIL's
``L``) or three (returned as (H, W, 3) uint8 RGB), any integral sampling
factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), restart intervals,
interleaved and non-interleaved scans, 8- and 16-bit quantisation tables.
Lossless (SOF3), hierarchical (SOF5-7) and arithmetic-coded (SOF9-15)
files, 12-bit samples, four components, and progressive files whose scans
leave low AC coefficients unrefined (libjpeg would smooth their blocks)
raise ``NotImplementedError`` naming what they use. EXIF orientation is not
applied, as ``Image.open`` does not apply it.

The steps are libjpeg-turbo's, where bit equality depends on them:

  - the entropy-coded data is decoded in Python with 16-bit lookahead
    tables (libjpeg's ``HUFF_LOOKAHEAD`` idea, widened so that a code and
    its value bits resolve in one lookup), over a list of the 32-bit
    big-endian words at every byte of the unstuffed data;
  - dequantisation and the inverse DCT run over all blocks at once in
    integer numpy: ``jidctint.c::jpeg_idct_islow`` (``CONST_BITS`` 13,
    ``PASS1_BITS`` 2, its ``FIX_*`` constants and ``DESCALE`` rounding) in
    the form of libjpeg-turbo's x86 SIMD code, which Pillow runs there: its
    16-bit lanes wrap some sums and saturate each pass's output, and the
    samples are clamped, not looked up in ``jdmaster.c``'s range-limit
    table. The two forms differ only on blocks whose dequantised values
    overflow 16 bits, which no encoder writes;
  - chroma is upsampled by ``jdsample.c``'s fancy (triangle) filters,
    ``h2v1``, ``h2v2`` and ``h1v2``, with the image's edge rows as context,
    and by plain replication where libjpeg-turbo takes it (a component at
    most two samples wide, and factors other than 2);
  - YCbCr becomes RGB through ``jdcolor.c``'s 16-bit fixed-point tables.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

__all__ = ["decode", "read"]

# zigzag position -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZZ = ZIGZAG.tolist()

_SOF_UNSUPPORTED = {
    0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)", 0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)"}

# an EOB in the lookahead tables: a run that ends the block's loop
_EOB = 64
_TABLES: dict = {}


def _lookahead(bits: bytes, vals: bytes, kind: str):
    """The 65536-entry lookahead table of one Huffman table, cached by its
    DHT bytes. ``kind`` "raw" maps a 16-bit window to ``(code length,
    symbol)`` (the progressive scans' use). "dc" and "ac" map it to ``(n,
    run, value, size)``: where the code and its ``size`` value bits fit in
    the window, ``n`` is their total length and ``value`` the extended
    coefficient (an AC table's EOB has run ``_EOB``, ZRL run 15 and value
    0); else ``n`` is the code's length and ``value`` is None, and the
    caller reads ``size`` more bits. A window that starts no code gives
    length 0."""
    key = (bits, vals, kind)
    if key in _TABLES:
        return _TABLES[key]
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            if code >= 1 << n:
                raise ValueError("bad Huffman table")
            lo = code << (16 - n)
            hi = (code + 1) << (16 - n)
            length[lo:hi] = n
            symbol[lo:hi] = vals[k]
            code, k = code + 1, k + 1
        code <<= 1
    if kind == "raw":
        table = list(zip(length.tolist(), symbol.tolist()))
    else:
        dc = kind == "dc"
        peek = np.arange(65536, dtype=np.int64)
        size = symbol if dc else symbol & 15
        run = np.zeros_like(symbol) if dc else symbol >> 4
        fits = (length > 0) & (length + size <= 16)
        shift = np.clip(16 - length - size, 0, 16)
        extra = (peek >> shift) & ((1 << size) - 1)
        value = np.where(extra >= (1 << np.maximum(size - 1, 0)), extra,
                         extra - (1 << size) + 1)
        value = np.where(size == 0, 0, value)
        total = np.where(fits, length + size, length)
        if not dc:
            run = np.where((size == 0) & (run != 15), _EOB, run)
        table = [(n, r, v if f else None, s) for n, r, v, s, f in zip(
            total.tolist(), run.tolist(), value.tolist(), size.tolist(), fits.tolist())]
    _TABLES[key] = table
    return table


def _words(data: bytes) -> list:
    """The 32-bit big-endian word at every byte offset of ``data`` (zeros
    past its end, as libjpeg feeds zeros past a segment's end)."""
    b = np.frombuffer(data + b"\0" * 8, np.uint8).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


def _unstuff(raw: bytes) -> bytes:
    return raw.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan, as libjpeg does


def _bad_window(pos):
    raise ValueError(f"corrupt JPEG data: no Huffman code at bit {pos}")


def _read_bits(words, pos, n):
    return (words[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _extend(x, s):
    return x if x >= 1 << (s - 1) else x - (1 << s) + 1


def _seq_segment(words, blocks, dc_tabs, ac_tabs, coefs, ncomp):
    """Baseline/extended sequential decoding of one restart segment:
    ``blocks`` lists (component, coefficient offset) in scan order."""
    pos = 0
    pred = [0] * ncomp
    zz = _ZZ
    for ci, base in blocks:
        dc, ac, co = dc_tabs[ci], ac_tabs[ci], coefs[ci]
        w = words[pos >> 3]
        n, _, v, s = dc[(w >> (16 - (pos & 7))) & 0xFFFF]
        if n == 0:
            _bad_window(pos)
        pos += n
        if v is None:
            v = _extend(_read_bits(words, pos, s), s)
            pos += s
        pred[ci] += v
        co[base] = pred[ci]
        k = 1
        while k < 64:
            w = words[pos >> 3]
            n, r, v, s = ac[(w >> (16 - (pos & 7))) & 0xFFFF]
            if n == 0:
                _bad_window(pos)
            pos += n
            if r == _EOB:
                break
            if v is None:
                v = _extend(_read_bits(words, pos, s), s)
                pos += s
            k += r
            if k > 63:
                break
            co[base + zz[k]] = v
            k += 1


def _decode_raw(raw, words, pos):
    n, sym = raw[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if n == 0:
        _bad_window(pos)
    return pos + n, sym


def _prog_segment(words, blocks, dc_raw, ac_raw, coefs, ncomp, ss, se, ah, al):
    """One restart segment of a progressive scan (``jdphuff.c``'s
    ``decode_mcu_DC_first``, ``DC_refine``, ``AC_first``, ``AC_refine``)."""
    pos = 0
    zz = _ZZ
    if ss == 0:
        pred = [0] * ncomp
        for ci, base in blocks:
            co = coefs[ci]
            if ah == 0:
                pos, s = _decode_raw(dc_raw[ci], words, pos)
                d = 0
                if s:
                    d = _extend(_read_bits(words, pos, s), s)
                    pos += s
                pred[ci] += d
                co[base] = pred[ci] << al
            else:
                if _read_bits(words, pos, 1):
                    co[base] |= 1 << al
                pos += 1
        return
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for ci, base in blocks:
        co, raw = coefs[ci], ac_raw[ci]
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                pos, sym = _decode_raw(raw, words, pos)
                r, s = sym >> 4, sym & 15
                if s:
                    k += r
                    v = _extend(_read_bits(words, pos, s), s)
                    pos += s
                    if k <= 63:
                        co[base + zz[k]] = v * p1
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(words, pos, r)
                        pos += r
                    eobrun -= 1
                    break
                k += 1
            continue
        k = ss
        if eobrun == 0:
            while k <= se:
                pos, sym = _decode_raw(raw, words, pos)
                r, s = sym >> 4, sym & 15
                if s:
                    s = p1 if _read_bits(words, pos, 1) else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(words, pos, r)
                        pos += r
                    break
                while k <= se:
                    i = base + zz[k]
                    c = co[i]
                    if c:
                        if _read_bits(words, pos, 1) and not c & p1:
                            co[i] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= 63:
                    co[base + zz[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                i = base + zz[k]
                c = co[i]
                if c:
                    if _read_bits(words, pos, 1) and not c & p1:
                        co[i] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1


# jidctint.c's constants, FIX(x) = round(x * 2^13)
F029, F039, F054, F076, F089, F117, F150, F184, F196, F205, F256, F307 = (
    int(x * 8192 + 0.5) for x in (
        0.298631336, 0.390180644, 0.541196100, 0.765366865, 0.899976223, 1.175875602,
        1.501321110, 1.847759065, 1.961570560, 2.053119869, 2.562915447, 3.072711026))


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_pass(x, shift):
    """One 1-D pass of ``jpeg_idct_islow`` along axis 1 of (N, 8, ...)
    int64 input, in the form of libjpeg-turbo's SIMD (``jidctint-avx2``):
    the same products, with the sums that it takes in 16-bit lanes
    (``x0 +- x4``, ``x7 + x3``, ``x5 + x1``) wrapped to 16 bits, and each
    output ``DESCALE(v, shift) = (v + 2^(shift-1)) >> shift`` saturated to
    16 bits. Where nothing overflows this is the C code's arithmetic."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, i] for i in range(8))
    tmp0 = _wrap16(x0 + x4) << 13
    tmp1 = _wrap16(x0 - x4) << 13
    tmp2 = x2 * F054 + x6 * (F054 - F184)
    tmp3 = x2 * (F054 + F076) + x6 * F054
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3, z4 = _wrap16(x7 + x3), _wrap16(x5 + x1)
    z3, z4 = z3 * (F117 - F196) + z4 * F117, z3 * F117 + z4 * (F117 - F039)
    t0 = x7 * (F029 - F089) - x1 * F089 + z3
    t1 = x5 * (F205 - F256) - x3 * F256 + z4
    t2 = -x5 * F256 + x3 * (F307 - F256) + z3
    t3 = -x7 * F089 + x1 * (F150 - F089) + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([np.clip((o + half) >> shift, -32768, 32767) for o in out], axis=1)


def _idct(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients and their (64,) table -> (N, 8, 8)
    uint8 samples: dequantised in 16 bits, columns, then rows, then
    saturated to -128..127 and centred on 128. A block whose rows 1-7 are
    all zero takes the SIMD's shortcut, ``DC * q << 2`` in 16 bits, for its
    first pass."""
    coef = _wrap16(coef.astype(np.int64)).reshape(-1, 8, 8)
    x = _wrap16(coef * _wrap16(quant.astype(np.int64)).reshape(8, 8))
    ws = _idct_pass(x, 13 - 2)  # columns: x[:, u, col] -> ws[:, row, col]
    flat = ~coef[:, 1:].any(axis=(1, 2))
    ws[flat] = _wrap16(x[flat, :1] << 2)
    out = _idct_pass(ws.transpose(0, 2, 1), 13 + 2 + 3)  # rows, as (N, col, row)
    return (np.clip(out.transpose(0, 2, 1), -128, 127) + 128).astype(np.uint8)


def _edge_rows(p: np.ndarray, dh: int) -> np.ndarray:
    """The component's rows with one context row above and below: row 0
    again above the image and its last real row (``dh - 1``) below it and
    in place of the padding rows (``jdmainct.c``'s context pointers)."""
    idx = np.clip(np.arange(-1, p.shape[0] + 1), 0, dh - 1)
    return p[idx].astype(np.int32)


def _upsample(p: np.ndarray, dw: int, dh: int, hr: int, vr: int, out_w: int, out_h: int):
    """``jdsample.c``'s choice for one component plane ``p`` (padded IDCT
    output, ``dw`` x ``dh`` real samples) expanded ``hr`` x ``vr`` times."""
    if hr == 1 and vr == 1:
        return p[:out_h, :out_w]
    if hr == 2 and vr == 1 and dw > 2:  # h2v1_fancy_upsample
        a = p[:, :dw].astype(np.int32)
        left = np.concatenate([a[:, :1], a[:, :-1]], 1)
        right = np.concatenate([a[:, 1:], a[:, -1:]], 1)
        even = (3 * a + left + 1) >> 2
        odd = (3 * a + right + 2) >> 2
        even[:, 0], odd[:, -1] = a[:, 0], a[:, -1]
        out = np.stack([even, odd], 2).reshape(a.shape[0], 2 * dw)
        return out[:out_h, :out_w].astype(np.uint8)
    if hr == 1 and vr == 2:  # h1v2_fancy_upsample
        e = _edge_rows(p[:, :dw], dh)
        top = (3 * e[1:-1] + e[:-2] + 1) >> 2
        bottom = (3 * e[1:-1] + e[2:] + 2) >> 2
        out = np.stack([top, bottom], 1).reshape(2 * p.shape[0], dw)
        return out[:out_h, :out_w].astype(np.uint8)
    if hr == 2 and vr == 2 and dw > 2:  # h2v2_fancy_upsample
        e = _edge_rows(p[:, :dw], dh)
        rows = []
        for near in (e[:-2], e[2:]):  # the row above, then the row below
            s = 3 * e[1:-1] + near
            last = np.concatenate([s[:, :1], s[:, :-1]], 1)
            nxt = np.concatenate([s[:, 1:], s[:, -1:]], 1)
            even = (3 * s + last + 8) >> 4
            odd = (3 * s + nxt + 7) >> 4
            even[:, 0] = (4 * s[:, 0] + 8) >> 4
            odd[:, -1] = (4 * s[:, -1] + 7) >> 4
            rows.append(np.stack([even, odd], 2).reshape(s.shape[0], 2 * dw))
        out = np.stack(rows, 1).reshape(2 * p.shape[0], 2 * dw)
        return out[:out_h, :out_w].astype(np.uint8)
    # h2v1_upsample, h2v2_upsample and int_upsample: replication
    return np.repeat(np.repeat(p, vr, 0), hr, 1)[:out_h, :out_w]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c::ycc_rgb_convert``: SCALEBITS 16, ONE_HALF rounding in
    the Cr->R, Cb->B and Cb->G tables, then a clamp to 0-255."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (91881 * x + 32768) >> 16    # FIX(1.40200)
    cb_b = (116130 * x + 32768) >> 16   # FIX(1.77200)
    cr_g = -46802 * x                   # FIX(0.71414)
    cb_g = -22554 * x + 32768           # FIX(0.34414), with ONE_HALF
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _segment_bytes(data: bytes, pos: int):
    """The entropy-coded bytes of a scan starting at ``pos``, split at its
    restart markers, and the offset of the marker that ends it."""
    segments, start, i = [], pos, pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            segments.append(data[start:])
            return segments, len(data)
        m = data[i + 1]
        if m == 0 or m == 0xFF:
            i += 1
            continue
        if 0xD0 <= m <= 0xD7:
            segments.append(data[start:i])
            start = i = i + 2
            continue
        segments.append(data[start:i])
        return segments, i


def decode(data: bytes) -> np.ndarray:
    """The samples of a JPEG file's bytes: (H, W) uint8 for one component,
    (H, W, 3) uint8 RGB for three."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qt = {}
    dc_def, ac_def = {}, {}
    comps, frame, restart = [], None, 0
    jfif = adobe = False
    adobe_transform = None
    progressive = False
    coefs = None
    coef_bits = None
    pos = 2
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(f"JPEG {_SOF_UNSUPPORTED[marker]} is not supported")
        if marker == 0xCC:
            raise NotImplementedError("JPEG arithmetic coding (DAC marker) is not supported")
        if marker == 0xDC:
            raise NotImplementedError("JPEG DNL marker is not supported")
        if marker == 0xE0:
            jfif = jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif marker == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe":
                adobe, adobe_transform = True, body[11]
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                qt[tq] = q
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = body[i + 1:i + 17]
                n = sum(bits)
                vals = body[i + 17:i + 17 + n]
                (dc_def if tc == 0 else ac_def)[th] = (bytes(bits), bytes(vals))
                i += 17 + n
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG samples are not supported")
            if nf not in (1, 3):
                raise NotImplementedError(f"JPEG with {nf} components is not supported")
            if height == 0:
                raise NotImplementedError("JPEG with its height in a DNL marker is not supported")
            progressive = marker == 0xC2
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                                body[8 + 3 * k]) for k in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.dw = -(-width * c.h // hmax)
                c.dh = -(-height * c.v // vmax)
                c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)  # the component's own grid
                c.pw, c.ph = mcux * c.h, mcuy * c.v  # the interleaved (MCU) grid
            frame = (width, height, hmax, vmax, mcux, mcuy)
            coefs = [[0] * (c.pw * c.ph * 64) for c in comps]
            coef_bits = [[-1] * 64 for _ in comps]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            sel = []
            for k in range(ns):
                cid, tabs = body[1 + 2 * k], body[2 + 2 * k]
                ci = next(j for j, c in enumerate(comps) if c.id == cid)
                sel.append((ci, tabs >> 4, tabs & 15))
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            ah, al = a >> 4, a & 15
            for ci, _, _ in sel:
                c = comps[ci]
                if c.quant is None:
                    c.quant = qt[c.tq].copy()
                for k in range(ss, se + 1):
                    coef_bits[ci][k] = al
            segments, pos = _segment_bytes(data, pos)
            _decode_scan(comps, frame, sel, segments, restart, dc_def, ac_def, coefs,
                         progressive, ss, se, ah, al)
    if frame is None:
        raise ValueError("JPEG file has no frame header")
    if progressive and any(b != 0 for bits in coef_bits for b in bits[1:10]):
        raise NotImplementedError(
            "progressive JPEG whose scans leave AC coefficients 1-9 unrefined "
            "(libjpeg smooths such blocks) is not supported")
    width, height, hmax, vmax, _, _ = frame
    planes = []
    for c, co in zip(comps, coefs):
        if c.quant is None:
            raise ValueError("JPEG component with no scan")
        blocks = _idct(np.asarray(co, np.int64).reshape(-1, 64), c.quant)
        p = blocks.reshape(c.ph, c.pw, 8, 8).transpose(0, 2, 1, 3).reshape(c.ph * 8, c.pw * 8)
        planes.append(_upsample(p, c.dw, c.dh, hmax // c.h, vmax // c.v, width, height))
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0])
    # libjpeg's default colour space: JFIF means YCbCr, else an Adobe
    # marker's transform, else component ids 'R', 'G', 'B' mean RGB
    ids = [c.id for c in comps]
    if jfif:
        rgb = False
    elif adobe:
        rgb = adobe_transform == 0
    else:
        rgb = ids == [82, 71, 66]
    if rgb:
        return np.stack(planes, -1)
    return _ycc_to_rgb(*planes)


def _decode_scan(comps, frame, sel, segments, restart, dc_def, ac_def, coefs, progressive,
                 ss, se, ah, al):
    width, height, hmax, vmax, mcux, mcuy = frame
    if len(sel) == 1:
        c = comps[sel[0][0]]
        # a non-interleaved scan walks the component's own grid, a block an MCU
        mcus = [[(sel[0][0], (by * c.pw + bx) * 64)] for by in range(c.bh) for bx in range(c.bw)]
    else:
        mcus = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for ci, _, _ in sel:
                    c = comps[ci]
                    for v in range(c.v):
                        for h in range(c.h):
                            mcu.append((ci, ((my * c.v + v) * c.pw + mx * c.h + h) * 64))
                mcus.append(mcu)
    per = restart or len(mcus)
    ncomp = len(comps)
    dc_tabs, ac_tabs, dc_raw, ac_raw = [None] * ncomp, [None] * ncomp, [None] * ncomp, [None] * ncomp
    for ci, td, ta in sel:
        if not progressive:
            dc_tabs[ci] = _lookahead(*dc_def[td], "dc")
            ac_tabs[ci] = _lookahead(*ac_def[ta], "ac")
        elif ss == 0 and ah == 0:
            dc_raw[ci] = _lookahead(*dc_def[td], "raw")
        elif ss > 0:
            ac_raw[ci] = _lookahead(*ac_def[ta], "raw")
    for s, start in enumerate(range(0, len(mcus), per)):
        blocks = [b for mcu in mcus[start:start + per] for b in mcu]
        words = _words(_unstuff(segments[s]) if s < len(segments) else b"")
        if progressive:
            _prog_segment(words, blocks, dc_raw, ac_raw, coefs, ncomp, ss, se, ah, al)
        else:
            _seq_segment(words, blocks, dc_tabs, ac_tabs, coefs, ncomp)


def read(path) -> np.ndarray:
    """:func:`decode` of a file's bytes; its errors name the file."""
    try:
        return decode(Path(path).read_bytes())
    except NotImplementedError as e:
        raise NotImplementedError(f"{path}: {e}") from None
    except (ValueError, IndexError, KeyError, StopIteration, struct.error) as e:
        raise ValueError(f"{path}: not a readable JPEG file ({e!r})") from e
