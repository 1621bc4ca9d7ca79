"""The port's image codecs (`data/images.py`) on the kinds that imageio
and cv2 read and resize for the JAX package:

* `decode_png` on every PNG kind (grey at 1, 2, 4, 8 and 16 bits, RGB,
  grey + alpha and RGBA at 8 and 16, palettes at 1-8 bits with and
  without `tRNS`, a palette shorter than its bit depth allows), plain and
  Adam7, against `imageio.v2.imread` of the same bytes: dtype, shape and
  values. The files come from `tools/png_kinds.py` (zlib and numpy:
  Pillow and cv2 write no Adam7 file).
* The chip smoke's Blender scene in those kinds (16-bit RGBA, Adam7
  RGBA, 16-bit grey + alpha and a palette + tRNS file at the paper's
  800x800) against the digests of imageio's decode recorded in
  `tests/png_kinds.json`, and imageio's own decode against them.
* `resize` against `cv2.resize` bit for bit, uint8 and float32, where
  INTER_AREA enlarges an axis (both, or one while the other shrinks) and
  where area boxes are cut by the image's edge (sizes rounded from
  fx / fy)."""

import io
import json
import os
import sys

import numpy as np
import pytest

from consistentnerf_tpu_torch.data import images
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import png_kinds  # noqa: E402

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")

HERE = os.path.dirname(__file__)
KINDS = [(colour, depth) for colour, depths in png_kinds.DEPTHS.items()
         for depth in depths]
NAMES = {0: "grey", 2: "rgb", 3: "palette", 4: "grey_alpha", 6: "rgba"}
SIZES = [(13, 11), (1, 1), (3, 2), (9, 17), (2, 7), (16, 8)]


def _pngs(colour, depth, interlace, seed):
    """(what, bytes) of one kind at every size in SIZES, with a tRNS
    chunk where the kind takes one and, for palettes, one shorter than
    2^depth entries; each file's rows under a seeded mix of filters."""
    rng = np.random.RandomState(seed)
    c = png_kinds.CHANNELS[colour]
    for h, w in SIZES:
        for trns in (False, True):
            if trns and colour in (4, 6):
                continue
            for short in ((False, True) if colour == 3 else (False,)):
                samples = rng.randint(0, 1 << depth, (h, w, c))
                palette = tr = None
                if colour == 3:
                    n = (1 << depth) if not short else max(
                        1, (1 << depth) // 2 - 1)
                    palette = rng.randint(0, 256, (n, 3))
                    tr = rng.randint(0, 256, max(1, n // 2)) if trns else None
                elif trns:
                    tr = samples[0, 0]
                data = png_kinds.encode_png_kind(
                    samples, colour, depth, palette=palette, trns=tr,
                    interlace=interlace, filters=rng.randint(0, 5, 11))
                yield (h, w, trns, short), data


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour, depth", KINDS,
                         ids=[f"{NAMES[c]}{d}" for c, d in KINDS])
def test_decode_png_matches_imageio(colour, depth, interlace):
    for what, data in _pngs(colour, depth, interlace, seed=depth + colour):
        want = imageio.imread(io.BytesIO(data))
        got = images.decode_png(data, "f.png")
        assert got.dtype == want.dtype, what
        assert got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=str(what))


def test_kinds_scene_matches_its_imageio_digests():
    """The chip smoke's scene files: the first frame of each kind and the
    palette file decode to the digests imageio gave when
    `tools/png_kinds.py` wrote the JSON, and imageio still gives them."""
    with open(os.path.join(HERE, "png_kinds.json")) as f:
        digests = json.load(f)
    files = list(png_kinds.scene_files())
    assert sorted(digests) == sorted(name for name, _, _ in files)
    n_kinds = len(png_kinds.SCENE_KINDS)
    for name, kind, data in files[:n_kinds] + files[-1:]:
        want = digests[name]
        assert want["kind"] == kind
        assert want["shape"] == [*png_kinds.SCENE_HW,
                                 3 if kind == "palette_trns" else 4]
        got = png_kinds.decoded_digest(images.decode_png(data, name))
        assert got == {k: want[k] for k in got}, name
        ref = png_kinds.decoded_digest(imageio.imread(io.BytesIO(data)))
        assert ref == got, name


# (source size, dsize or (fx, fy)) where INTER_AREA enlarges or boxes are
# cut by the image's edge.
RESIZE_CASES = {
    "area_up": [((7, 9), (18, 14)), ((5, 3), (31, 9)), ((16, 16), (40, 40)),
                ((1, 4), (9, 3)), ((7, 9), (1.7, 2.3)),
                ((12, 10), (2.0, 2.0))],
    "area_mixed": [((7, 9), (9, 21)), ((11, 13), (20, 3)),
                   ((37, 53), (20, 60)), ((12, 10), (2.0, 0.5)),
                   ((7, 9), (0.5, 3.0)), ((16, 16), (0.35, 1.6))],
    "edge_cut": [((7, 9), (0.5, 0.5)), ((11, 13), (1 / 3, 1 / 3)),
                 ((11, 13), (0.25, 0.5)), ((37, 53), (0.2, 0.2)),
                 ((5, 3), (0.5, 0.5)), ((7, 9), (0.35, 0.6)),
                 ((13, 11), (0.75, 0.75)), ((12, 10), (0.25, 0.25))],
}
CV2_FLAGS = {images.INTER_AREA: "INTER_AREA",
             images.INTER_LINEAR: "INTER_LINEAR",
             images.INTER_NEAREST: "INTER_NEAREST"}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_matches_cv2_bit_for_bit(case, dtype):
    """INTER_AREA on every case; INTER_LINEAR's halving (cv2's area path)
    and INTER_NEAREST on the cut boxes too."""
    rng = np.random.RandomState(len(case))
    interps = [images.INTER_AREA] + (
        [images.INTER_LINEAR, images.INTER_NEAREST] if case == "edge_cut"
        else [])
    for (h, w), size in RESIZE_CASES[case]:
        for c in (None, 3, 4):
            shape = (h, w) if c is None else (h, w, c)
            img = (rng.randint(0, 256, shape).astype(np.uint8)
                   if dtype == "uint8"
                   else (rng.rand(*shape) * 3).astype(np.float32))
            for interp in interps:
                if (interp == images.INTER_LINEAR
                        and (dtype == "float32" or size != (0.5, 0.5))):
                    # cv2 runs a float32 linear resize in IPP, held at
                    # 2e-7 in test_torch_port_loaders.py.
                    continue
                flag = getattr(cv2, CV2_FLAGS[interp])
                if isinstance(size[0], int):
                    want = cv2.resize(img, size, interpolation=flag)
                    got = images.resize(img, size, interpolation=interp)
                else:
                    fx, fy = size
                    want = cv2.resize(img, None, fx=fx, fy=fy,
                                      interpolation=flag)
                    got = images.resize(img, None, fx=fx, fy=fy,
                                        interpolation=interp)
                what = str((shape, size, interp))
                assert got.dtype == want.dtype and got.shape == want.shape, \
                    what
                assert got.tobytes() == want.tobytes(), what
