"""Image files and resizes on numpy and the standard library alone.

The machine the port runs on has no imaging package, so the loaders read
their images here:

* `read_png` / `decode_png`: every PNG kind (grey, grey + alpha, RGB,
  RGBA and palette, at each bit depth the standard allows, with or
  without Adam7 interlace), as the array `imageio.v2.imread` gives for it
  through Pillow (dtype and channels: `decode_png`). Rows filtered with
  None, Sub or Up are undone a row at a time; an image with an Average or
  Paeth row (each byte depends on the decoded byte to its left) is undone
  along anti-diagonals, all rows at once.
* `write_png` / `encode_png`: 8-bit grey, grey + alpha, RGB and RGBA,
  not interlaced, with a chosen filter.
* `write_jpeg` / `encode_jpeg`: 8-bit greyscale baseline JPEGs (JFIF,
  sequential DCT, the Annex K luminance tables at libjpeg's quality 75),
  the producers' mask JPGs.
* `read_jpeg` / `decode_jpeg` (`data/jpeg.py`): sequential and
  progressive Huffman JPEGs, 1 or 3 components, libjpeg's default decode
  bit for bit (LLFF's raw `images/`).
* `imread`: dispatches on the file's signature: a PNG to `read_png`, a
  JPEG to `read_jpeg`; any other format raises, naming it.
* `resize`: OpenCV's `cv2.resize` for `INTER_AREA`, `INTER_LINEAR` and
  `INTER_NEAREST`, on [H, W] or [H, W, C] uint8 or float32 images, with
  OpenCV's weights and, for uint8, its rounding (`_minify` writes resized
  uint8 images back to disk, so a pixel one off would change every later
  run). `INTER_AREA` enlarging either axis and boxes cut by the image's
  edge give OpenCV's bits in float32 too.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

# The JPEG decoder lives in its own module; this one is the loaders' API.
from consistentnerf_tpu_torch.data.jpeg import decode_jpeg, read_jpeg  # noqa: F401

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples a pixel (grey, RGB, palette, grey + alpha,
# RGBA), and the bit depths the standard allows for it.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# The colour type `encode_png` writes for 1-4 channels of 8 bits.
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# Adam7: (row start, column start, row step, column step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))

INTER_NEAREST = "nearest"
INTER_LINEAR = "linear"
INTER_AREA = "area"


# --- PNG -------------------------------------------------------------------


def _chunks(data: bytes, name: str):
    """(tag, payload) of each chunk, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        tag = data[pos + 4: pos + 8]
        payload = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if len(payload) != length or zlib.crc32(tag + payload) != crc:
            raise ValueError(f"{name}: corrupt PNG chunk {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without an IEND chunk")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> the array `imageio.v2.imread` gives for them (through
    Pillow): uint8 [H, W] grey, [H, W, 2] grey + alpha, [H, W, 3] RGB,
    [H, W, 4] RGBA, with these exceptions of Pillow's: 1-bit grey is bool;
    2- and 4-bit grey are scaled to 0-255; 16-bit grey stays uint16;
    other 16-bit samples keep their high byte, grey + alpha as RGBA; a
    palette image is its colours, RGB (a `tRNS` chunk is not read, as
    Pillow's RGB conversion does not). Adam7 interlace is read for every
    kind."""
    header, palette, idat = None, None, []
    for tag, payload in _chunks(data, name):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = payload
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _DEPTHS:
        raise ValueError(f"{name}: unknown PNG colour type {colour}")
    if depth not in _DEPTHS[colour]:
        raise ValueError(f"{name}: PNG colour type {colour} has no bit "
                         f"depth {depth}")
    if interlace > 1:
        raise ValueError(f"{name}: unknown PNG interlace method {interlace} "
                         "(0: not interlaced, 1: Adam7)")
    if colour == 3 and (palette is None or not palette
                        or len(palette) % 3):
        raise ValueError(f"{name}: a PNG of colour type 3 (palette) without "
                         "a valid PLTE chunk")
    c = _CHANNELS[colour]
    bpp = max(1, c * depth // 8)  # the filters' byte distance to the left
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    sizes = [(len(range(r0, h, dr)), len(range(c0, w, dc)))
             for r0, c0, dr, dc in passes]
    row_bytes = [(pw * c * depth + 7) // 8 for _, pw in sizes]
    expected = sum(ph * (1 + n) for (ph, pw), n in zip(sizes, row_bytes)
                   if ph and pw)
    if raw.size != expected:
        raise ValueError(f"{name}: PNG image data has {raw.size} bytes, "
                         f"expected {expected}")
    samples = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for (r0, c0, dr, dc), (ph, pw), n in zip(passes, sizes, row_bytes):
        if not (ph and pw):
            continue
        block = raw[pos: pos + ph * (1 + n)].reshape(ph, 1 + n)
        pos += ph * (1 + n)
        kinds = block[:, 0]
        if kinds.max() > 4:
            raise ValueError(f"{name}: unknown PNG row filter {kinds.max()}")
        rows = block[:, 1:].reshape(ph, n // bpp, bpp)
        if kinds.max() <= 2:
            rows = _unfilter_rows(rows, kinds)
        else:
            rows = _unfilter_diagonals(rows, kinds)
        samples[r0::dr, c0::dc] = _unpack_samples(rows.reshape(ph, n), pw, c,
                                                  depth)
    return _as_pillow_reads(samples, colour, depth, palette)


def _unpack_samples(rows: np.ndarray, w: int, c: int,
                    depth: int) -> np.ndarray:
    """Unfiltered byte rows [h, n] -> sample values [h, w, c]: 16-bit
    samples big-endian, sub-byte samples packed from the high bit."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows.reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, : w * c * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, w * c, depth) @ weights).astype(
        np.uint8).reshape(h, w, c)


def _as_pillow_reads(samples: np.ndarray, colour: int, depth: int,
                     palette: Optional[bytes]) -> np.ndarray:
    """Sample values [H, W, C] as `imageio.v2.imread` returns them (the
    rules of `decode_png`)."""
    if colour == 3:
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
        lut[: len(pal)] = pal
        return lut[samples[..., 0]]
    if colour == 0:
        grey = samples[..., 0]
        if depth == 1:
            return grey != 0
        if depth < 8:
            return grey * np.uint8(255 // ((1 << depth) - 1))
        return grey
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if colour == 4:  # Pillow reads 16-bit grey + alpha as RGBA
            samples = samples[..., [0, 0, 0, 1]]
    return samples


def _unfilter_rows(rows: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo None / Sub / Up a row at a time (uint8 sums wrap mod 256)."""
    out = np.empty_like(rows)
    prev = np.zeros_like(rows[0])
    for r, kind in enumerate(kinds):
        if kind == 0:
            out[r] = rows[r]
        elif kind == 1:
            np.cumsum(rows[r], axis=0, dtype=np.uint8, out=out[r])
        else:
            np.add(rows[r], prev, out=out[r])
        prev = out[r]
    return out


def _unfilter_diagonals(rows: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """Undo any mix of the five filters. Pixel (r, x) needs its decoded
    left, upper and upper-left neighbours, so every pixel of one
    anti-diagonal r + x = k decodes at once, channels and rows together.
    The rows are skewed so that a diagonal is one contiguous slice:
    pixel (r, x) lives at sk[r + x + 2, r + 1] (a zero row above the
    image, two zero diagonals before it)."""
    h, w, c = rows.shape
    r_idx = np.arange(h)[:, None]
    diag = r_idx + np.arange(w)[None, :]
    src = np.zeros((h + w + 1, h, c), np.int16)
    src[diag, np.broadcast_to(r_idx, (h, w))] = rows
    sk = np.zeros((h + w + 1, h + 1, c), np.int16)
    f = kinds.astype(np.int16)[:, None]
    sub, up, avg, paeth = (f == 1), (f == 2), (f == 3), (f == 4)
    for k in range(h + w - 1):
        lo, hi = max(0, k - w + 1), min(k, h - 1) + 1  # rows on diagonal k
        a, b = sk[k + 1, lo + 1: hi + 1], sk[k + 1, lo:hi]
        d = sk[k, lo:hi]
        # Paeth: the neighbour closest to a + b - d, ties to a, then b.
        pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
        pae = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
        pred = np.where(sub[lo:hi], a, np.where(up[lo:hi], b, np.where(
            avg[lo:hi], (a + b) >> 1, np.where(paeth[lo:hi], pae, 0))))
        sk[k + 2, lo + 1: hi + 1] = (src[k, lo:hi] + pred) & 255
    return sk[diag + 2, np.broadcast_to(r_idx + 1, (h, w))].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _filter_rows(img: np.ndarray, kinds: np.ndarray) -> np.ndarray:
    """The filtered bytes of each row under its filter (an encoder's
    side: every predictor reads unfiltered neighbours, so all rows at
    once)."""
    if not kinds.any():
        return img
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    f = kinds.astype(np.int16)[:, None, None]
    pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
        f == 3, (a + b) >> 1, 0)))
    if (kinds == 4).any():
        d = np.zeros_like(x)
        d[1:, 1:] = x[:-1, :-1]
        pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, d))
        pred = np.where(f == 4, paeth, pred)
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(img: np.ndarray,
               filter_type: Union[int, Sequence[int]] = 0,
               level: int = 6) -> bytes:
    """uint8 [H, W] or [H, W, C] (C = 1-4) -> PNG bytes. `filter_type`:
    one of the five row filters (0 None ... 4 Paeth) for every row, or
    one per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"encode_png takes 1-4 channels, got {c}")
    kinds = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    if kinds.size and kinds.max() > 4:
        raise ValueError(f"unknown PNG row filter {kinds.max()}")
    rows = np.concatenate([kinds[:, None],
                           _filter_rows(img, kinds).reshape(h, w * c)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOUR_TYPE[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filter_type: Union[int, Sequence[int]] = 0,
              level: int = 6) -> None:
    data = encode_png(img, filter_type, level)
    with open(path, "wb") as f:
        f.write(data)


# --- JPEG (baseline, greyscale) --------------------------------------------

# ITU-T T.81 Annex K, table K.1: the luminance quantisation table.
_JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
# Tables K.3 and K.5: the luminance DC and AC Huffman tables, as the code
# counts of lengths 1-16 and the symbols in code order.
_JPEG_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_JPEG_DC_VALS = bytes(range(12))
_JPEG_AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_JPEG_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
# The zigzag scan: row-major index of the coefficient at each position.
_JPEG_ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              i // 8 if (i // 8 + i % 8) % 2 else -(i // 8))))
# The orthonormal 8-point DCT-II matrix (T.81's FDCT scaling).
_JPEG_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5
                       * np.cos((2 * x + 1) * u * np.pi / 16)
                       for x in range(8)] for u in range(8)])


# libjpeg's scaling of the table at quality 75 (Pillow's default, which
# imageio writes with): scale 200 - 2 * 75 percent, clamped to the
# baseline range 1-255.
JPEG_QUALITY = 75
_JPEG_QUANT = np.clip((_JPEG_LUMA_Q * (200 - 2 * JPEG_QUALITY) + 50) // 100,
                      1, 255)


def _huffman_codes(bits, vals) -> dict:
    """symbol -> (code, length) of a JPEG Huffman table (T.81 Annex C)."""
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, 1):
        for _ in range(count):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _amplitude(v: int):
    """(size, bits) of a DC difference or AC value: its bit length and
    the value, negatives in one's complement."""
    size = abs(v).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def _pack_bits(codes, lengths) -> bytes:
    """Concatenate variable-length codes MSB first, pad the last byte with
    ones and stuff a zero byte after every 0xFF."""
    codes = np.asarray(codes, np.int64)
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    owner = np.repeat(np.arange(len(codes)), lengths)
    pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    bits = (codes[owner] >> (lengths[owner] - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones((-total) % 8, np.int64)])
    data = np.packbits(bits.astype(np.uint8)).tobytes()
    return data.replace(b"\xff", b"\xff\x00")


def encode_jpeg(img: np.ndarray) -> bytes:
    """uint8 [H, W] (or [H, W, 1]) -> a baseline greyscale JFIF file:
    sequential DCT, one component, the Annex K luminance quantisation
    table at libjpeg's quality 75 and the Annex K luminance Huffman
    tables. The image is padded to whole 8x8 blocks by repeating
    its last row and column."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"encode_jpeg takes uint8 [H, W] images, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a baseline JPEG cannot hold {h}x{w}")
    x = np.pad(img, ((0, (-h) % 8), (0, (-w) % 8)), mode="edge")
    blocks = (x.astype(np.float64) - 128.0).reshape(
        x.shape[0] // 8, 8, x.shape[1] // 8, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,bcxy,vy->bcuv", _JPEG_DCT, blocks, _JPEG_DCT)
    zz = np.round(coef / _JPEG_QUANT).astype(np.int64).reshape(-1, 64)[
        :, _JPEG_ZIGZAG]

    dc_codes = _huffman_codes(_JPEG_DC_BITS, _JPEG_DC_VALS)
    ac_codes = _huffman_codes(_JPEG_AC_BITS, _JPEG_AC_VALS)
    codes, lengths = [], []

    def emit(code, length):
        codes.append(code)
        lengths.append(length)

    prev_dc = 0
    for block in zz.tolist():
        size, amp = _amplitude(block[0] - prev_dc)
        prev_dc = block[0]
        emit(*dc_codes[size])
        if size:
            emit(amp, size)
        run = 0
        for k in range(1, 64):
            v = block[k]
            if v == 0:
                run += 1
                continue
            while run > 15:
                emit(*ac_codes[0xF0])  # sixteen zeros
                run -= 16
            size, amp = _amplitude(v)
            emit(*ac_codes[(run << 4) | size])
            emit(amp, size)
            run = 0
        if run:
            emit(*ac_codes[0x00])  # end of block

    def segment(marker: int, payload: bytes) -> bytes:
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    dht = b"".join(bytes([tc]) + bytes(bits) + vals for tc, bits, vals in (
        (0x00, _JPEG_DC_BITS, _JPEG_DC_VALS),
        (0x10, _JPEG_AC_BITS, _JPEG_AC_VALS)))
    return (b"\xff\xd8"
            + segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + segment(0xFFDB, b"\x00" + bytes(
                _JPEG_QUANT.reshape(-1)[_JPEG_ZIGZAG].astype(np.uint8).tolist()))
            + segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00")
            + segment(0xFFC4, dht)
            + segment(0xFFDA, b"\x01\x01\x00\x00\x3f\x00")
            + _pack_bits(codes, lengths) + b"\xff\xd9")


def write_jpeg(path: str, img_u8: np.ndarray) -> None:
    """Write a uint8 greyscale image [H, W] as a baseline JPEG (the mask
    JPGs of the producers; `encode_jpeg`)."""
    data = encode_jpeg(img_u8)
    with open(path, "wb") as f:
        f.write(data)


# The leading bytes of formats `imread` names when it refuses them.
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"),
                  (b"MM\x00*", "TIFF"), (b"RIFF", "RIFF (WebP)"),
                  (b"\x00\x00\x00\x0cjP", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000 codestream"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"\x76\x2f\x31\x01", "EXR"),
                  (b"PF", "PFM"), (b"Pf", "PFM"))


def imread(path: str) -> np.ndarray:
    """An image file as `imageio.v2.imread` gives it, by its signature: a
    PNG (`read_png`: uint8 but for 1-bit grey, bool, and 16-bit grey,
    uint16) or a JPEG (`read_jpeg`, uint8 [H, W] or [H, W, 3]); any other
    format raises a ValueError that names it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(PNG_SIGNATURE)] == PNG_SIGNATURE:
        return decode_png(data, path)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, path)
    kind = next((k for sig, k in _OTHER_FORMATS if data.startswith(sig)),
                f"an unknown format (leading bytes {data[:8].hex()})")
    raise ValueError(f"{path}: {kind} files are not read (only PNG and "
                     "JPEG)")


# --- resizes (cv2.resize) --------------------------------------------------


def _target(shape, dsize, fx, fy) -> Tuple[int, int, float, float]:
    """cv2's output size and inverse scales: from `dsize` (width,
    height), else the size rounded from fx / fy."""
    sh, sw = shape[:2]
    if dsize is not None:
        dw, dh = int(dsize[0]), int(dsize[1])
        return dh, dw, dw / sw, dh / sh
    if not fx or not fy:
        raise ValueError("resize needs dsize or both fx and fy")
    return round(sh * fy), round(sw * fx), float(fx), float(fy)


def resize(img: np.ndarray, dsize: Optional[Tuple[int, int]] = None,
           fx: Optional[float] = None, fy: Optional[float] = None,
           interpolation: str = INTER_LINEAR) -> np.ndarray:
    """`cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=...)` on uint8
    or float32 [H, W] / [H, W, C] images; `dsize` is (width, height)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize takes uint8 or float32, got {img.dtype}")
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes [H, W] or [H, W, C], got {img.shape}")
    dh, dw, inv_x, inv_y = _target(img.shape, dsize, fx, fy)
    if dh <= 0 or dw <= 0:
        raise ValueError(f"resize to an empty image ({dw} x {dh})")
    x = img if img.ndim == 3 else img[..., None]
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if interpolation == INTER_NEAREST:
        out = _nearest(x, dh, dw, sx, sy)
    elif interpolation in (INTER_AREA, INTER_LINEAR):
        area_fast = (sx >= 1 and sy >= 1 and abs(sx - round(sx)) < 2.3e-16
                     and abs(sy - round(sy)) < 2.3e-16)
        if interpolation == INTER_AREA and area_fast:
            out = _area_fast(x, dh, dw, round(sx), round(sy))
        elif (interpolation == INTER_LINEAR and area_fast
              and round(sx) == 2 and round(sy) == 2):
            # cv2 takes its fast area path for a linear halving too.
            out = _area_fast(x, dh, dw, 2, 2)
        elif interpolation == INTER_AREA and sx >= 1 and sy >= 1:
            out = _area(x, dh, dw, sx, sy)
        else:
            # INTER_AREA that enlarges an axis runs cv2's linear resize
            # with area coefficients on both axes.
            out = _linear(x, dh, dw, sx, sy, (inv_x, inv_y)
                          if interpolation == INTER_AREA else (None, None))
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return out if img.ndim == 3 else out[..., 0]


def _nearest(x, dh, dw, sx, sy):
    """cv2's INTER_NEAREST: source index floor(d * scale), clamped."""
    h, w = x.shape[:2]
    ys = np.minimum(np.floor(np.arange(dh) * sy).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(dw) * sx).astype(np.int64), w - 1)
    return x[ys][:, xs]


def _box_sum_f32(vals: np.ndarray) -> np.ndarray:
    """cv2's float sum of each box [..., area] (the box row by row): the
    elements four at a time, ((a + b) + c) + d added to the total, then
    the rest one at a time."""
    area = vals.shape[-1]
    total = np.zeros(vals.shape[:-1], np.float32)
    for k in range(0, area - 3, 4):
        total += ((vals[..., k] + vals[..., k + 1]) + vals[..., k + 2]) \
            + vals[..., k + 3]
    for k in range(area - area % 4, area):
        total += vals[..., k]
    return total


def _area_fast(x, dh, dw, kx, ky):
    """cv2's INTER_AREA at integer factors: box means of the boxes that
    lie inside the image, then the boxes cut by its edge (a size rounded
    up from fx / fy), the mean of what they hold (sum / count, float32,
    the sum row by row). uint8: 2x2 boxes round half up ((sum + 2) >> 2),
    others take sum * (1 / area) in float32, rounded half to even. float32:
    2x2 boxes of 1- or 4-channel images go by cv2's vector code,
    ((a + b) + (c + d)) * 0.25 (1 channel: in groups of four output
    pixels, the rest as other boxes); other boxes `_box_sum_f32` * (1 /
    area)."""
    h, w, c = x.shape
    hf, wf = min(dh, h // ky), min(dw, w // kx)  # whole boxes
    out = np.zeros((dh, dw, c), x.dtype)
    boxes = x[: hf * ky, : wf * kx].reshape(hf, ky, wf, kx, c)
    if x.dtype == np.uint8:
        total = boxes.astype(np.int32).sum((1, 3))
        if kx == 2 and ky == 2:
            out[:hf, :wf] = (total + 2) >> 2
        else:
            scaled = total.astype(np.float32) * np.float32(1.0 / (kx * ky))
            out[:hf, :wf] = np.clip(np.rint(scaled), 0, 255)
    else:
        vals = boxes.transpose(0, 2, 4, 1, 3).reshape(hf, wf, c, kx * ky)
        out[:hf, :wf] = _box_sum_f32(vals) * np.float32(1.0 / (kx * ky))
        if kx == 2 and ky == 2 and c in (1, 4):
            nv = wf - wf % 4 if c == 1 else wf
            v = vals[:, :nv]
            out[:hf, :nv] = ((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3])
                             ) * np.float32(0.25)
    for dy in range(dh):
        for dx in range(wf if dy < hf else 0, dw):
            box = x[dy * ky: (dy + 1) * ky, dx * kx: (dx + 1) * kx]
            if box.size == 0:
                continue
            count = np.float32(box.shape[0] * box.shape[1])
            if x.dtype == np.uint8:
                mean = box.astype(np.int32).sum((0, 1)).astype(
                    np.float32) / count
                out[dy, dx] = np.clip(np.rint(mean), 0, 255)
            else:
                total = np.zeros(c, np.float32)
                for px in box.reshape(-1, c):
                    total += px
                out[dy, dx] = total / count
    return out


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: per output index, the source indices
    and weights that cover [d * scale, (d + 1) * scale), padded to one
    width with zero weights."""
    entries = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            row.append((s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            row.append((s2, np.float32(min(min(fs2 - s2, 1.0), cell) / cell)))
        entries.append(row)
    n = max(len(r) for r in entries)
    idx = np.zeros((dsize, n), np.int64)
    wt = np.zeros((dsize, n), np.float32)
    for d, row in enumerate(entries):
        for k, (s, a) in enumerate(row):
            idx[d, k], wt[d, k] = s, a
    return idx, wt


def _area(x, dh, dw, sx, sy):
    """cv2's INTER_AREA at other ratios: weighted boxes, summed in
    float32 in cv2's order (across a source row, then down the rows)."""
    xi, xw = _area_tab(x.shape[1], dw, sx)
    yi, yw = _area_tab(x.shape[0], dh, sy)
    src = x.astype(np.float32)
    rows = np.zeros((x.shape[0], dw, x.shape[2]), np.float32)
    for k in range(xi.shape[1]):
        rows += src[:, xi[:, k]] * xw[:, k][None, :, None]
    out = np.zeros((dh, dw, x.shape[2]), np.float32)
    for k in range(yi.shape[1]):
        out += yw[:, k][:, None, None] * rows[yi[:, k]]
    if x.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _linear_tab(ssize: int, dsize: int, scale: float, clamp: bool,
                area_inv: Optional[float] = None):
    """cv2's INTER_LINEAR source index and fraction per output index
    (half-pixel centres); `clamp`: the horizontal pass's border rule.
    `area_inv` (the inverse scale): INTER_AREA's coefficients where it
    enlarges, index floor(d * scale) and as fraction the part of output
    pixel d that lies past source pixel index + 1's start."""
    d = np.arange(dsize)
    if area_inv is None:
        f = (d + 0.5) * scale - 0.5
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(np.float32)
    else:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * area_inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f))
    if clamp:
        low, high = s < 0, s >= ssize - 1
        f[low | high] = 0
        s[low] = 0
        s[high] = ssize - 1
    return s, f


def _linear(x, dh, dw, sx, sy, area_inv=(None, None)):
    """cv2's INTER_LINEAR: a horizontal then a vertical pass. float32 in
    float32; uint8 in cv2's fixed point (weights in 1/2048, rows of int
    sums, the vertical pass in 16-bit halves rounded at 2^22).
    `area_inv`: the inverse scales (x, y) for INTER_AREA's coefficients
    (`_linear_tab`)."""
    h, w = x.shape[:2]
    xs, fxs = _linear_tab(w, dw, sx, True, area_inv[0])
    ys, fys = _linear_tab(h, dh, sy, False, area_inv[1])
    x1 = np.minimum(xs + 1, w - 1)
    y0, y1 = np.clip(ys, 0, h - 1), np.clip(ys + 1, 0, h - 1)
    if x.dtype == np.float32:
        a0, a1 = (np.float32(1) - fxs)[:, None], fxs[:, None]
        rows = x[:, xs] * a0 + x[:, x1] * a1
        b0, b1 = (np.float32(1) - fys)[:, None, None], fys[:, None, None]
        return rows[y0] * b0 + rows[y1] * b1
    one = 2048
    a0 = np.rint((np.float32(1) - fxs) * np.float32(one)).astype(np.int64)
    a1 = np.rint(fxs * np.float32(one)).astype(np.int64)
    src = x.astype(np.int64)
    rows = src[:, xs] * a0[:, None] + src[:, x1] * a1[:, None]
    b0 = np.rint((np.float32(1) - fys) * np.float32(one)).astype(np.int64)
    b1 = np.rint(fys * np.float32(one)).astype(np.int64)
    # The vertical pass as cv2's vector code runs it: 16-bit products of
    # the sums shifted by 4, each kept to its high half, then rounded.
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    acc = (((s0 * b0[:, None, None]) >> 16)
           + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(acc, 0, 255).astype(np.uint8)
