"""PNG files of every kind the PNG standard defines, written with zlib and
numpy alone, and the digests of imageio's decode of the chip smoke's
Blender scene written in those kinds.

`encode_png_kind` writes grey, grey + alpha, RGB, RGBA and palette
images at every bit depth the standard allows for them (1, 2, 4, 8 and
16), with a `tRNS` chunk, per-row filters and Adam7 interlace. Pillow and
cv2 write no Adam7 file, so the tests of the port's decoder
(`consistentnerf_tpu_torch/data/images.py::decode_png`) build their files
here and hold the port's decode to `imageio.v2.imread` of the same
bytes. `chip_smoke.py` writes a Blender-layout scene in these kinds on
the card's machine (`scene_files`), which has no imaging package,
and holds the port's decode there to the digests that

    python tools/png_kinds.py

records in `tests/png_kinds.json` from imageio on a machine that has it.
The content is made from fixed seeds, so a rerun writes the same file.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_JSON = os.path.join(ROOT, "tests", "png_kinds.json")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, and the bit depths the standard allows.
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: (row start, column start, row step, column step) of each pass.
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] sample values -> [h, row bytes] uint8: 16-bit samples
    big-endian, sub-byte samples packed MSB first, each row padded."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = np.unpackbits(samples.astype(np.uint8).reshape(h, w * c, 1),
                         axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=-1)


def _filter(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Filter each byte row under its filter type (0 None ... 4 Paeth);
    `bpp` bytes a pixel, at least 1."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    d = np.zeros_like(x)
    d[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
    f = kinds.astype(np.int16)[:, None]
    pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
        f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
    out = ((x - pred) & 255).astype(np.uint8)
    return np.concatenate([kinds.astype(np.uint8)[:, None], out], 1)


def encode_png_kind(samples: np.ndarray, colour: int, depth: int,
                    palette: Optional[np.ndarray] = None,
                    trns: Optional[Union[bytes, np.ndarray]] = None,
                    interlace: bool = False,
                    filters: Union[int, Sequence[int], np.ndarray] = 0,
                    level: int = 6) -> bytes:
    """PNG bytes of `samples` ([H, W] or [H, W, C] sample values of
    `depth` bits; palette indices for colour type 3) of `colour` type.
    `palette` [n, 3] uint8 (type 3), `trns` the tRNS payload (type 3: an
    alpha a palette entry; 0 / 2: the transparent sample values, given as
    an array of 1 or 3 values). `filters`: one row filter for every row
    (of every Adam7 pass), or a seeded cycle of them given as a
    sequence."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    if c != CHANNELS[colour] or depth not in DEPTHS[colour]:
        raise ValueError(f"colour type {colour} holds {CHANNELS[colour]} "
                         f"samples of {DEPTHS[colour]} bits, got {c} of "
                         f"{depth}")
    if samples.size and int(samples.max()) >= (1 << depth):
        raise ValueError(f"a sample over {depth} bits")
    bpp = max(1, c * depth // 8)
    passes = [(0, 0, 1, 1)] if not interlace else ADAM7
    kinds = np.atleast_1d(np.asarray(filters, np.int64))
    raw, used = [], 0
    for r0, c0, dr, dc in passes:
        sub = samples[r0::dr, c0::dc]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _pack_rows(sub, depth)
        k = np.resize(np.roll(kinds, -used), rows.shape[0])
        used += rows.shape[0]
        raw.append(_filter(rows, k, bpp).reshape(-1))
    data = np.concatenate(raw).tobytes() if raw else b""
    out = PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, 1 if interlace else 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        if colour == 3:
            payload = np.asarray(trns, np.uint8).tobytes()
        else:
            payload = np.asarray(trns, ">u2").tobytes()
        out += _chunk(b"tRNS", payload)
    return (out + _chunk(b"IDAT", zlib.compress(data, level))
            + _chunk(b"IEND", b""))


# --- the chip smoke's Blender scene in the new kinds -----------------------

SCENE_HW = (800, 800)
# The frames the Blender loader reads for `lego` (the pairs registry's
# lego_train, then lego_val): only these files are written.
SCENE_FRAMES = (6, 43, 33, 63, 70, 18, 28)
# One kind a frame, in turn; all read as uint8 RGBA, so the loader can
# stack them: 16-bit RGBA, Adam7 RGBA (8 bits), 16-bit grey + alpha.
SCENE_KINDS = ("rgba16", "adam7_rgba", "grey_alpha16")
# A palette image (with tRNS) reads as RGB: it cannot sit among RGBA
# frames (imageio's stack fails as the port's does), so the scene holds
# it beside its frames, decoded but not loaded.
PALETTE_FILE = "palette_trns.png"


def kinds_scene_rgba16(frame: int, hw=SCENE_HW) -> np.ndarray:
    """Frame `frame`'s seeded 16-bit RGBA content in integer arithmetic
    alone (the same bits on any machine): gradients shifted by the frame
    with a little noise, alpha 65535 on a disc and 0 off it."""
    rng = np.random.RandomState(500 + frame)
    h, w = hw
    yy, xx = np.mgrid[:h, :w].astype(np.int64)
    shift = rng.randint(0, 4096, 3)
    rgb = np.stack([xx * 60000 // max(1, w - 1) + shift[0],
                    yy * 60000 // max(1, h - 1) + shift[1],
                    (xx + yy) * 60000 // max(1, w + h - 2) + shift[2]], -1)
    rgb = np.minimum(rgb + rng.randint(0, 256, (h, w, 3)), 65535)
    inside = 100 * ((2 * yy - h) ** 2 + (2 * xx - w) ** 2) < 49 * h * h
    a = np.where(inside, 65535, 0)[..., None]
    return np.concatenate([rgb, a], -1).astype(np.uint16)


def kinds_scene_png(frame: int, hw=SCENE_HW) -> bytes:
    """Frame `frame` of the scene as PNG bytes, in the kind of its
    position in SCENE_FRAMES, rows under a seeded mix of the five
    filters."""
    kind = SCENE_KINDS[SCENE_FRAMES.index(frame) % len(SCENE_KINDS)]
    img16 = kinds_scene_rgba16(frame, hw)
    filters = np.random.RandomState(600 + frame).randint(0, 5, 64)
    if kind == "rgba16":
        return encode_png_kind(img16, 6, 16, filters=filters)
    if kind == "grey_alpha16":
        grey = (img16[..., :3].astype(np.int64).sum(-1) // 3).astype(
            np.uint16)
        return encode_png_kind(np.stack([grey, img16[..., 3]], -1), 4, 16,
                               filters=filters)
    return encode_png_kind((img16 >> 8).astype(np.uint8), 6, 8,
                           interlace=True, filters=filters)


def palette_png(hw=SCENE_HW) -> bytes:
    """The first frame's colours on a 256-entry palette (a 6x7x6 colour
    cube and four black entries), entry 0 transparent off the disc."""
    img8 = (kinds_scene_rgba16(SCENE_FRAMES[0], hw) >> 8).astype(np.int64)
    q = np.stack(np.meshgrid(np.arange(6), np.arange(7), np.arange(6),
                             indexing="ij"), -1).reshape(-1, 3)
    palette = np.round(q * (255.0 / np.array([5, 6, 5]))).astype(np.uint8)
    palette = np.concatenate([palette, np.zeros((4, 3), np.uint8)])
    idx = (np.rint(img8[..., 0] * 5 / 255.0).astype(np.int64) * 42
           + np.rint(img8[..., 1] * 6 / 255.0).astype(np.int64) * 6
           + np.rint(img8[..., 2] * 5 / 255.0).astype(np.int64))
    idx = np.where(img8[..., 3] == 0, 0, np.maximum(idx, 1))
    alpha = np.full(256, 255, np.uint8)
    alpha[0] = 0
    return encode_png_kind(idx, 3, 8, palette=palette, trns=alpha,
                           filters=np.random.RandomState(599).randint(0, 5,
                                                                      64))


def scene_files(hw=SCENE_HW):
    """(file name, kind, PNG bytes) of every file of the scene."""
    for k, frame in enumerate(SCENE_FRAMES):
        yield (f"r_{frame}.png", SCENE_KINDS[k % len(SCENE_KINDS)],
               kinds_scene_png(frame, hw))
    yield PALETTE_FILE, "palette_trns", palette_png(hw)


def decoded_digest(img: np.ndarray) -> dict:
    """What the digests record of a decoded image: dtype, shape and the
    SHA-256 of its bytes."""
    img = np.ascontiguousarray(img)
    return {"dtype": str(img.dtype), "shape": list(img.shape),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def main() -> None:
    import io

    import imageio.v2 as imageio

    out = {}
    for name, kind, data in scene_files():
        img = imageio.imread(io.BytesIO(data))
        out[name] = dict(decoded_digest(img), kind=kind)
    with open(OUT_JSON, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT_JSON)


if __name__ == "__main__":
    main()
