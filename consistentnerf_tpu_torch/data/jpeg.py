"""JPEG decoding on numpy and the standard library: libjpeg's default
decode, as `imageio.v2.imread` gives it through Pillow on libjpeg-turbo
(the 6.2 API), bit for bit.

What it reads: baseline and extended sequential Huffman frames (SOF0 /
SOF1) and progressive Huffman frames (SOF2, spectral selection and
successive approximation); 8-bit samples with 1 or 3 components; the
sampling factors the frame declares (4:4:4, 4:2:2, 4:2:0, 4:4:0 and any
other integer ratio); restart intervals (DRI / RSTn), fill bytes before
markers and `FF 00` stuffing; sizes that are not whole MCUs. APPn and COM
segments are skipped by their length, so an EXIF thumbnail (a JPEG with
its own SOI / EOI inside APP1) is never seen. No EXIF orientation is
applied (imageio.v2 applies none).

What raises, naming the kind: arithmetic coding (SOF9-11, DAC),
lossless (SOF3), hierarchical frames (SOF5-7, SOF13-15), 12-bit samples,
2- and 4-component frames (Adobe CMYK / YCCK), and progressive files
whose scans leave a low AC coefficient incomplete (libjpeg smooths such
blocks; that is not ported).

How, after the entropy decode, each stage follows libjpeg-turbo:

* Huffman decoding reads 16-bit lookahead tables (one list index a
  symbol) from a 56-bit window a byte, in plain Python: this is the only
  per-symbol loop.
* Dequantisation and the integer "islow" IDCT (`jidctint.c`: 13-bit
  constants, 2 extra bits between the passes) run in numpy over every
  block of a component at once.
* Chroma is upsampled by libjpeg's fancy (triangle) filters (`jdsample.c`:
  h2v1 and h2v2 for widths over 2, h1v2) with their alternating rounding
  biases and edge rows duplicated as its context rows are; other integer
  ratios replicate samples.
* YCbCr -> RGB uses the fixed-point tables of `jdcolor.c` (16 fraction
  bits).
"""

from __future__ import annotations

import struct
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np

# Markers.
SOI, EOI, SOS, DHT, DQT, DRI, DAC = 0xD8, 0xD9, 0xDA, 0xC4, 0xDB, 0xDD, 0xCC
SOF_SEQUENTIAL = (0xC0, 0xC1)
SOF_PROGRESSIVE = 0xC2
_UNSUPPORTED_SOF = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "hierarchical arithmetic-coded (SOF13)",
    0xCE: "hierarchical arithmetic-coded (SOF14)",
    0xCF: "hierarchical arithmetic-coded lossless (SOF15)",
}

# The zigzag scan: row-major (natural) index of the coefficient at each
# position, with libjpeg's 16 guard entries for a run past position 63.
ZIGZAG = sorted(range(64), key=lambda i: (
    i // 8 + i % 8, i // 8 if (i // 8 + i % 8) % 2 else -(i // 8)))
_NATURAL = ZIGZAG + [63] * 16

# jidctint.c's constants: FIX(x) = round(x * 2^13).
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298631336, _F0_390180644, _F0_541196100 = 2446, 3196, 4433
_F0_765366865, _F0_899976223, _F1_175875602 = 6270, 7373, 9633
_F1_501321110, _F1_847759065, _F1_961570560 = 12299, 15137, 16069
_F2_053119869, _F2_562915447, _F3_072711026 = 16819, 20995, 25172


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "bw", "bh", "dw", "dh",
                 "offset", "coef_bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None  # latched at the component's first scan


class _Frame:
    def __init__(self, kind, height, width, comps):
        self.kind, self.height, self.width = kind, height, width
        self.comps = comps
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        total = 0
        for c in comps:
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.dw = -(-width * c.h // self.hmax)
            c.dh = -(-height * c.v // self.vmax)
            c.offset = total
            c.coef_bits = [-1] * 64
            total += c.bw * c.bh * 64
        # Every component's coefficients, natural order, block-row-major.
        self.coef = array("i", bytes(4 * total))


def _huffman_table(payload: memoryview, pos: int, name: str):
    """One table of a DHT segment: (class, id, lookahead list, end).
    The list maps the next 16 bits to (symbol << 8) | code length, and to
    0 where no code of the table starts with those bits."""
    tc_th = payload[pos]
    bits = list(payload[pos + 1: pos + 17])
    n = sum(bits)
    vals = list(payload[pos + 17: pos + 17 + n])
    if len(vals) != n:
        raise ValueError(f"{name}: truncated JPEG Huffman table")
    table = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            if code >= (1 << length):
                raise ValueError(f"{name}: bad JPEG Huffman table")
            lo = code << (16 - length)
            table[lo: lo + (1 << (16 - length))] = (vals[k] << 8) | length
            code, k = code + 1, k + 1
        code <<= 1
    return tc_th >> 4, tc_th & 15, table.tolist(), pos + 17 + n


def _windows(chunk: bytes) -> List[int]:
    """A 56-bit big-endian window at every byte of an unstuffed entropy
    segment, zeros past its end (libjpeg feeds zeros at a marker)."""
    a = np.frombuffer(chunk + bytes(72), np.uint8).astype(np.uint64)
    n = len(chunk) + 64
    w = np.zeros(n, np.uint64)
    for i in range(7):
        w = (w << np.uint64(8)) | a[i: i + n]
    return w.tolist()


def _entropy_chunks(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data of one scan from `pos`: its restart
    intervals, each unstuffed (FF 00 -> FF), and the position of the
    marker that ends the scan."""
    chunks, start, n = [], pos, len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            chunks.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return chunks, n
        j = i + 1
        while j < n and data[j] == 0xFF:  # fill bytes
            j += 1
        if j >= n:
            chunks.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return chunks, n
        m = data[j]
        if m == 0x00 and j == i + 1:
            pos = j + 1
            continue
        chunks.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:  # RSTn: the next interval
            start = pos = j + 1
            continue
        return chunks, i


def _scan_blocks(frame: _Frame, comps: List[_Component]):
    """The flat coefficient offset of each block of a scan, MCU by MCU
    ([n_mcu][blocks]), and each block's component index in the scan."""
    if len(comps) == 1:
        c = comps[0]
        nbx, nby = -(-c.dw // 8), -(-c.dh // 8)
        by, bx = np.mgrid[:nby, :nbx]
        base = c.offset + (by * c.bw + bx).reshape(-1, 1) * 64
        return base.tolist(), [0]
    my, mx = np.mgrid[:frame.mcuy, :frame.mcux]
    my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
    cols, which = [], []
    for k, c in enumerate(comps):
        for i in range(c.v):
            for j in range(c.h):
                cols.append(c.offset + ((my * c.v + i) * c.bw
                                        + mx * c.h + j) * 64)
                which.append(k)
    return np.concatenate(cols, 1).tolist(), which


def _bad_code(name):
    return ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")


def _decode_sequential(coef, chunks, mcus, which, dcs, acs, ri, name):
    """Baseline / extended sequential Huffman scan: DC difference, then
    run-length AC symbols to the end of each block."""
    nat = _NATURAL
    per = ri or len(mcus)
    for c_i, chunk in enumerate(chunks):
        first = c_i * per
        if first >= len(mcus):
            break
        w = _windows(chunk)
        p = 0
        pred = [0] * len(dcs)
        blocks = list(zip(which, [dcs[k] for k in which],
                          [acs[k] for k in which]))
        try:
            for bases in mcus[first: first + per]:
                for (k, dct, act), base in zip(blocks, bases):
                    x = (w[p >> 3] >> (24 - (p & 7))) & 0xFFFFFFFF
                    e = dct[x >> 16]
                    ln = e & 31
                    if not ln:
                        raise _bad_code(name)
                    s = e >> 8
                    if s:
                        v = (x >> (32 - ln - s)) & ((1 << s) - 1)
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        pred[k] += v
                        p += ln + s
                    else:
                        p += ln
                    coef[base] = pred[k]
                    i = 1
                    while i < 64:
                        x = (w[p >> 3] >> (24 - (p & 7))) & 0xFFFFFFFF
                        e = act[x >> 16]
                        ln = e & 31
                        if not ln:
                            raise _bad_code(name)
                        s = (e >> 8) & 15
                        if s:
                            i += e >> 12
                            v = (x >> (32 - ln - s)) & ((1 << s) - 1)
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            coef[base + nat[i]] = v
                            p += ln + s
                            i += 1
                        else:
                            p += ln
                            if e >> 12 != 15:
                                break
                            i += 16
        except IndexError:
            raise ValueError(f"{name}: JPEG data ends inside a scan") \
                from None


class _Bits:
    """A bit reader over one restart interval (the progressive scans)."""

    __slots__ = ("w", "p")

    def __init__(self, chunk: bytes):
        self.w, self.p = _windows(chunk), 0

    def get(self, n: int) -> int:
        p = self.p
        self.p = p + n
        return (self.w[p >> 3] >> (56 - (p & 7) - n)) & ((1 << n) - 1)

    def huff(self, table, name) -> int:
        p = self.p
        e = table[(self.w[p >> 3] >> (40 - (p & 7))) & 0xFFFF]
        if not e & 31:
            raise _bad_code(name)
        self.p = p + (e & 31)
        return e >> 8


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _decode_progressive(coef, chunks, mcus, which, dcs, acs, ri, ss, se,
                        ah, al, name):
    """One progressive scan (jdphuff.c): DC first / refine over all blocks
    of its components, AC first / refine over one component's band."""
    nat = _NATURAL
    per = ri or len(mcus)
    p1, m1 = 1 << al, -1 << al
    for c_i, chunk in enumerate(chunks):
        first = c_i * per
        if first >= len(mcus):
            break
        bits = _Bits(chunk)
        pred = [0] * len(dcs)
        eobrun = 0
        try:
            for bases in mcus[first: first + per]:
                if ss == 0:  # DC scan
                    for k, base in zip(which, bases):
                        if ah == 0:
                            s = bits.huff(dcs[k], name)
                            if s:
                                pred[k] += _extend(bits.get(s), s)
                            coef[base] = pred[k] << al
                        elif bits.get(1):
                            coef[base] |= p1
                    continue
                base = bases[0]
                act = acs[which[0]]
                if ah == 0:  # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    i = ss
                    while i <= se:
                        rs = bits.huff(act, name)
                        r, s = rs >> 4, rs & 15
                        if s:
                            i += r
                            coef[base + nat[i]] = _extend(bits.get(s), s) << al
                        elif r == 15:
                            i += 15
                        else:
                            eobrun = (1 << r) - 1
                            if r:
                                eobrun += bits.get(r)
                            break
                        i += 1
                    continue
                # AC refine
                i = ss
                if not eobrun:
                    while i <= se:
                        rs = bits.huff(act, name)
                        r, s = rs >> 4, rs & 15
                        if s:
                            s = p1 if bits.get(1) else m1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += bits.get(r)
                            break
                        while i <= se:
                            pos = base + nat[i]
                            c = coef[pos]
                            if c:
                                if bits.get(1) and not c & p1:
                                    coef[pos] = c + (p1 if c >= 0 else m1)
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            i += 1
                        if s:
                            coef[base + nat[i]] = s
                        i += 1
                if eobrun:
                    while i <= se:
                        pos = base + nat[i]
                        c = coef[pos]
                        if c and bits.get(1) and not c & p1:
                            coef[pos] = c + (p1 if c >= 0 else m1)
                        i += 1
                    eobrun -= 1
        except IndexError:
            raise ValueError(f"{name}: JPEG data ends inside a scan") \
                from None


def _idct_1d(z0, z1, z2, z3, z4, z5, z6, z7):
    """jidctint.c's 8-point integer IDCT on columns of int64 arrays:
    the eight outputs before the final descale, in order."""
    t = (z2 + z6) * _F0_541196100
    tmp2 = t - z6 * _F1_847759065
    tmp3 = t + z2 * _F0_765366865
    tmp0 = (z0 + z4) << _CONST_BITS
    tmp1 = (z0 - z4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    # The odd part: i0..i3 are y7, y5, y3, y1.
    o0, o1, o2, o3 = z7, z5, z3, z1
    a1, a2, a3, a4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    a5 = (a3 + a4) * _F1_175875602
    o0 = o0 * _F0_298631336
    o1 = o1 * _F2_053119869
    o2 = o2 * _F3_072711026
    o3 = o3 * _F1_501321110
    a1 = a1 * -_F0_899976223
    a2 = a2 * -_F2_562915447
    a3 = a3 * -_F1_961570560 + a5
    a4 = a4 * -_F0_390180644 + a5
    o0 += a1 + a3
    o1 += a2 + a4
    o2 += a2 + a3
    o3 += a1 + a4
    return (tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
            tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """[N, 64] natural-order quantised coefficients and the component's
    [64] table -> [N, 8, 8] uint8 samples (libjpeg's jpeg_idct_islow,
    whose output clamps to 0..255)."""
    x = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    d1 = _CONST_BITS - _PASS1_BITS
    cols = _idct_1d(*(x[:, k, :] for k in range(8)))  # down the columns
    ws = np.stack([(c + (1 << (d1 - 1))) >> d1 for c in cols], 1)
    d2 = _CONST_BITS + _PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)))  # along the rows
    out = np.stack([(r + (1 << (d2 - 1))) >> d2 for r in rows], 2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _clamped(n: int, step: int) -> np.ndarray:
    return np.clip(np.arange(n) + step, 0, n - 1)


def _upsample(c: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's [dh, dw] samples upsampled by (fh, fv), as
    jdsample.c does it with fancy upsampling on (libjpeg's default)."""
    x = c.astype(np.int32)
    dh, dw = x.shape
    if (fh, fv) == (1, 1):
        return c
    if (fh, fv) == (2, 1) and dw > 2:
        left, right = x[:, _clamped(dw, -1)], x[:, _clamped(dw, 1)]
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (1, 2):
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + x[_clamped(dh, -1)] + 1) >> 2
        out[1::2] = (3 * x + x[_clamped(dh, 1)] + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (2, 2) and dw > 2:
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for v, step, rows in ((0, -1, slice(0, None, 2)),
                              (1, 1, slice(1, None, 2))):
            cs = 3 * x + x[_clamped(dh, step)]  # the column sums
            left, right = cs[:, _clamped(dw, -1)], cs[:, _clamped(dw, 1)]
            out[rows, 0::2] = (3 * cs + left + 8) >> 4
            out[rows, 1::2] = (3 * cs + right + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(c, fv, 0), fh, 1)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
               ) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (16 fraction bits)."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _frame_header(marker, payload, name) -> _Frame:
    precision, height, width, nc = struct.unpack(">BHHB", payload[:6])
    kind = "progressive" if marker == SOF_PROGRESSIVE else "sequential"
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG samples are not "
                         "read (only 8-bit)")
    if nc == 4:
        raise ValueError(f"{name}: 4-component (Adobe CMYK / YCCK) JPEGs "
                         "are not read")
    if nc not in (1, 3):
        raise ValueError(f"{name}: {nc}-component JPEGs are not read "
                         "(only 1 or 3)")
    if height == 0:
        raise ValueError(f"{name}: JPEG height 0 (a DNL marker) is not "
                         "read")
    comps = []
    for i in range(nc):
        cid, hv, tq = payload[6 + 3 * i: 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"{name}: bad JPEG sampling factors {h}x{v}")
        comps.append(_Component(cid, h, v, tq))
    frame = _Frame(kind, height, width, comps)
    for c in comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise ValueError(f"{name}: JPEG sampling factors that are not "
                             "integer ratios are not read")
    return frame


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] (3 components) or [H, W] (one)."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    frame: Optional[_Frame] = None
    qts: Dict[int, np.ndarray] = {}
    tables: Tuple[Dict, Dict] = ({}, {})
    restart = 0
    jfif, adobe = False, None
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:  # garbage before a marker: libjpeg skips it
            nxt = data.find(b"\xff", pos)
            if nxt < 0:
                break
            pos = nxt
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == EOI:
            break
        if marker in (0x01, SOI) or 0xD0 <= marker <= 0xD7:
            continue  # no payload
        if pos + 2 > n:
            break
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        payload = memoryview(data)[pos + 2: pos + length]
        if len(payload) != length - 2:
            raise ValueError(f"{name}: JPEG segment 0x{marker:02X} is "
                             "truncated")
        end = pos + length
        if marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{name}: {_UNSUPPORTED_SOF[marker]} JPEGs "
                             "are not read")
        if marker == DAC:
            raise ValueError(f"{name}: arithmetic-coded JPEGs are not read")
        if marker in SOF_SEQUENTIAL or marker == SOF_PROGRESSIVE:
            if frame is not None:
                raise ValueError(f"{name}: JPEG with more than one frame")
            frame = _frame_header(marker, payload, name)
        elif marker == DHT:
            p = 0
            while p < len(payload):
                tc, th, table, p = _huffman_table(payload, p, name)
                tables[tc][th] = table
        elif marker == DQT:
            p = 0
            while p < len(payload):
                pq, tq = payload[p] >> 4, payload[p] & 15
                size = 2 if pq else 1
                raw = np.frombuffer(payload[p + 1: p + 1 + 64 * size],
                                    ">u2" if pq else np.uint8)
                if raw.size != 64:
                    raise ValueError(f"{name}: truncated JPEG "
                                     "quantisation table")
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = raw
                qts[tq] = qt
                p += 1 + 64 * size
        elif marker == DRI:
            (restart,) = struct.unpack(">H", payload[:2])
        elif marker == 0xE0 and bytes(payload[:5]) == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and bytes(payload[:5]) == b"Adobe" \
                and len(payload) >= 12:
            adobe = payload[11]
        elif marker == SOS:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame")
            end = _scan(frame, payload, data, end, qts, tables, restart,
                        name)
        pos = end
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame")
    return _reconstruct(frame, jfif, adobe, name)


def _scan(frame, payload, data, pos, qts, tables, restart, name) -> int:
    """Decode one scan whose header is `payload` and whose data starts at
    `pos`; return the position of the marker after it."""
    ns = payload[0]
    by_id = {c.cid: c for c in frame.comps}
    comps, dcs, acs = [], [], []
    for i in range(ns):
        cid, tdta = payload[1 + 2 * i: 3 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: JPEG scan names component {cid}, "
                             "which the frame lacks")
        comps.append(by_id[cid])
        dcs.append(tables[0].get(tdta >> 4))
        acs.append(tables[1].get(tdta & 15))
    ss, se, ahal = payload[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    for c in comps:
        if c.qt is None:
            if c.tq not in qts:
                raise ValueError(f"{name}: JPEG quantisation table {c.tq} "
                                 "is not defined")
            c.qt = qts[c.tq]
    progressive = frame.kind == "progressive"
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss and ns != 1):
        raise ValueError(f"{name}: bad progressive JPEG scan "
                         f"(Ss {ss}, Se {se}, {ns} components)")
    need_dc = ss == 0 and ah == 0
    need_ac = se > 0 and not (progressive and ss == 0)
    for k in range(ns):
        if (need_dc and dcs[k] is None) or (need_ac and acs[k] is None):
            raise ValueError(f"{name}: JPEG scan uses an undefined Huffman "
                             "table")
    chunks, end = _entropy_chunks(data, pos)
    mcus, which = _scan_blocks(frame, comps)
    if progressive:
        _decode_progressive(frame.coef, chunks, mcus, which, dcs, acs,
                            restart, ss, se, ah, al, name)
    else:
        _decode_sequential(frame.coef, chunks, mcus, which, dcs, acs,
                           restart, name)
    for c in comps:
        for k in range(ss, se + 1):
            c.coef_bits[k] = al
    return end


def _reconstruct(frame: _Frame, jfif: bool, adobe, name: str) -> np.ndarray:
    coef = np.frombuffer(frame.coef, np.int32)
    planes = []
    for c in frame.comps:
        if frame.kind == "progressive" and any(
                b != 0 for b in c.coef_bits[1:10]) and c.coef_bits[0] >= 0:
            raise ValueError(
                f"{name}: a progressive JPEG whose scans leave low AC "
                "coefficients incomplete (libjpeg smooths its blocks, "
                "which is not ported)")
        if c.qt is None:
            c.qt = np.zeros(64, np.int64)  # never scanned: mid-grey
        blocks = coef[c.offset: c.offset + c.bw * c.bh * 64].reshape(-1, 64)
        px = idct_islow(blocks, c.qt).reshape(c.bh, c.bw, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        plane = plane[: c.dh, : c.dw]
        up = _upsample(plane, frame.hmax // c.h, frame.vmax // c.v)
        planes.append(up[: frame.height, : frame.width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    ids = tuple(c.cid for c in frame.comps)
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == (82, 71, 66)  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
