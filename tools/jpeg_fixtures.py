"""Write the JPEG fixtures: `tests/jpeg_fixtures/*.jpg` and
`tests/jpeg_fixtures.json` (each file's shape and the SHA-256 of its
pixels as `imageio.v2.imread` decodes them, libjpeg's default decode).

    python tools/jpeg_fixtures.py

Needs PIL, imageio and cv2 (the encoders and the reference decode); the
port's decoder (`consistentnerf_tpu_torch/data/jpeg.py`) is held to the
digests by `tests/test_torch_port_jpeg.py` and by `chip_smoke.py`, which
also builds an LLFF scene from the `llff_view_*.jpg` files. The content is
made from fixed seeds, so a rerun with the same libraries writes the same
files.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "tests", "jpeg_fixtures")
OUT_JSON = os.path.join(ROOT, "tests", "jpeg_fixtures.json")
LLFF_VIEWS = 4
LLFF_HW = (378, 504)


def smooth_image(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """Seeded smooth content with a little noise and a dark rectangle
    (edges for the chroma filters)."""
    rng = np.random.RandomState(seed)
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    f = rng.uniform(1, 6, (3, c)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (2, c)).astype(np.float32)
    v = (0.5 + 0.3 * np.sin(2 * np.pi * f[0] * x + ph[0])
         * np.cos(2 * np.pi * f[1] * y + ph[1])
         + 0.15 * np.sin(2 * np.pi * f[2] * (x + y))
         + 0.04 * rng.rand(h, w, c).astype(np.float32))
    img = (np.clip(v, 0, 1) * 255).astype(np.uint8)
    r0, c0 = rng.randint(0, max(1, h // 2)), rng.randint(0, max(1, w // 2))
    img[r0:r0 + max(1, h // 4), c0:c0 + max(1, w // 4)] //= 5
    return img[..., 0] if c == 1 else img


def exif_with_thumbnail(thumb: bytes, orientation: int = 6) -> bytes:
    """An APP1 Exif payload: IFD0 with an orientation tag, IFD1 pointing
    at an embedded JPEG thumbnail (which has its own SOI / EOI)."""
    le = "<"
    ifd0 = 8
    ifd1 = ifd0 + 2 + 12 + 4
    data_at = ifd1 + 2 + 2 * 12 + 4
    tiff = b"II*\x00" + struct.pack(le + "I", ifd0)
    tiff += struct.pack(le + "H", 1) + struct.pack(
        le + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(
        le + "I", ifd1)
    tiff += struct.pack(le + "H", 2) + struct.pack(
        le + "HHII", 0x0201, 4, 1, data_at) + struct.pack(
        le + "HHII", 0x0202, 4, 1, len(thumb)) + struct.pack(le + "I", 0)
    return b"Exif\x00\x00" + tiff + thumb


def insert_segment(jpeg: bytes, marker: int, payload: bytes) -> bytes:
    """`jpeg` with a marker segment put right after its SOI."""
    seg = struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload
    return jpeg[:2] + seg + jpeg[2:]


def with_fill_bytes(jpeg: bytes) -> bytes:
    """`jpeg` with fill bytes (FF FF FF) before its SOS and EOI markers."""
    sos = jpeg.index(b"\xff\xda")
    out = jpeg[:sos] + b"\xff\xff\xff" + jpeg[sos:]
    return out[:-2] + b"\xff\xff" + out[-2:]


def fixtures() -> dict:
    """name -> (JPEG bytes, what it exercises)."""
    import cv2
    from PIL import Image

    def pil(img, **kw):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        return buf.getvalue()

    def cv(img, *params):
        ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3
                               else img, list(params))
        assert ok
        return buf.tobytes()

    out = {}
    for q in (50, 95):
        for ss, name in ((0, "444"), (1, "422"), (2, "420")):
            out[f"q{q}_{name}"] = (pil(smooth_image(q + ss, 37, 53),
                                       quality=q, subsampling=ss),
                                   f"baseline, quality {q}, 4:{name[1]}:"
                                   f"{name[2]}, odd size")
    out["cv2_440"] = (cv(smooth_image(1, 33, 47),
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                         cv2.IMWRITE_JPEG_QUALITY, 90),
                      "baseline 4:4:0 (h1v2 fancy upsampling)")
    out["cv2_411"] = (cv(smooth_image(2, 30, 61),
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
                      "baseline 4:1:1 (sample replication)")
    out["progressive_420"] = (pil(smooth_image(3, 61, 45), quality=80,
                                  progressive=True),
                              "progressive, spectral selection and "
                              "successive approximation, 4:2:0")
    out["progressive_grey"] = (pil(smooth_image(4, 33, 29, 1), quality=70,
                                   progressive=True), "progressive, grey")
    out["restart_blocks"] = (pil(smooth_image(5, 40, 70), quality=75,
                                 restart_marker_blocks=3),
                             "baseline with a restart interval of 3 MCUs")
    out["restart_progressive"] = (cv(smooth_image(6, 45, 67),
                                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                     cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
                                  "progressive with restart intervals")
    thumb = pil(smooth_image(7, 16, 20), quality=60)
    out["exif_thumbnail"] = (insert_segment(
        pil(smooth_image(8, 48, 64), quality=85), 0xE1,
        exif_with_thumbnail(thumb)),
        "EXIF APP1 (orientation 6, not applied) with a JPEG thumbnail")
    out["grey_odd"] = (pil(smooth_image(9, 21, 19, 1), quality=75),
                       "baseline grey, odd size")
    out["tiny_3x5"] = (pil(smooth_image(10, 3, 5), quality=75),
                       "4:2:0 narrower than one MCU (plain upsampling)")
    out["fill_bytes"] = (with_fill_bytes(pil(smooth_image(11, 24, 40),
                                             quality=75)),
                         "fill bytes before SOS and EOI")
    out["optimized"] = (pil(smooth_image(12, 50, 50), quality=85,
                            optimize=True),
                        "optimized Huffman tables")
    for i in range(LLFF_VIEWS):
        out[f"llff_view_{i}"] = (pil(smooth_image(100 + i, *LLFF_HW),
                                     quality=85, subsampling=2),
                                 f"LLFF view {i}, {LLFF_HW[1]}x{LLFF_HW[0]}"
                                 " baseline 4:2:0")
    return out


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def main(argv=None) -> int:
    import imageio.v2 as imageio

    os.makedirs(OUT_DIR, exist_ok=True)
    index, total = {}, 0
    for name, (data, what) in fixtures().items():
        path = os.path.join(OUT_DIR, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        img = np.asarray(imageio.imread(path))
        index[f"{name}.jpg"] = {"shape": list(img.shape),
                                "sha256": digest(img), "what": what}
        total += len(data)
    with open(OUT_JSON, "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(index)} fixtures ({total} bytes) to {OUT_DIR} and "
          f"{OUT_JSON}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
