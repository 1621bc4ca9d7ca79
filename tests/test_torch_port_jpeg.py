"""The port's JPEG decoder (`data/jpeg.py`, behind `data/images.py::
imread`) against `imageio.v2.imread` (Pillow on libjpeg-turbo): every
variant bit for bit, the committed fixtures against their stored digests
(`tests/jpeg_fixtures.json`, written by `tools/jpeg_fixtures.py`), the
port's own `write_jpeg` output, the kinds that raise, and the LLFF loader
from JPEG `images/` against the JAX package's (`_minify` at factor 2 and
the factor-1 load)."""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest

from consistentnerf_tpu.data import llff as jllff
from consistentnerf_tpu_torch.data import images, jpeg, llff
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import jpeg_fixtures  # noqa: E402

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")
Image = pytest.importorskip("PIL.Image")

HERE = os.path.dirname(__file__)
FIXTURES = json.load(open(os.path.join(HERE, "jpeg_fixtures.json")))


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cv(img, *params):
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img,
                           list(params))
    assert ok
    return buf.tobytes()


def _img(seed, h, w, c=3):
    return jpeg_fixtures.smooth_image(seed, h, w, c)


# (name, encoder) of each variant: the samplings, qualities 50 and 95,
# progressive, restart intervals, EXIF with a thumbnail, odd and tiny
# sizes, greyscale, optimized tables, fill bytes, the RGB colour space.
VARIANTS = {
    **{f"pil_q{q}_{n}": (lambda q=q, ss=ss: _pil(
        _img(q + ss, 29, 43), quality=q, subsampling=ss))
       for q in (50, 95) for ss, n in ((0, "444"), (1, "422"), (2, "420"))},
    **{f"cv2_{n}": (lambda f=f: _cv(
        _img(3, 27, 35), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f,
        cv2.IMWRITE_JPEG_QUALITY, 90))
       for n, f in (("440", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                    ("411", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
                    ("422", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422))},
    "progressive_420": lambda: _pil(_img(4, 41, 37), quality=80,
                                    progressive=True),
    "progressive_444_q95": lambda: _pil(_img(5, 23, 31), quality=95,
                                        progressive=True, subsampling=0),
    "progressive_grey": lambda: _pil(_img(6, 19, 23, 1), progressive=True),
    "restart_blocks": lambda: _pil(_img(7, 30, 50), restart_marker_blocks=2),
    "restart_rows_progressive": lambda: _pil(
        _img(8, 30, 50), restart_marker_rows=1, progressive=True),
    "cv2_restart_progressive": lambda: _cv(
        _img(9, 33, 41), cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    "exif_thumbnail": lambda: jpeg_fixtures.insert_segment(
        _pil(_img(10, 24, 32)), 0xE1, jpeg_fixtures.exif_with_thumbnail(
            _pil(_img(11, 8, 8), quality=60))),
    "grey": lambda: _pil(_img(12, 17, 13, 1)),
    "optimized": lambda: _pil(_img(13, 24, 24), quality=85, optimize=True),
    "fill_bytes": lambda: jpeg_fixtures.with_fill_bytes(_pil(_img(14, 16,
                                                                  24))),
    "keep_rgb": lambda: _pil(_img(15, 16, 24), keep_rgb=True),
    **{f"tiny_{h}x{w}_{n}": (lambda h=h, w=w, ss=ss: _pil(
        _img(h * w, h, w), subsampling=ss))
       for h, w in ((1, 1), (2, 3), (3, 4), (9, 17))
       for ss, n in ((1, "422"), (2, "420"))},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_decode_matches_imageio(name):
    data = VARIANTS[name]()
    want = np.asarray(imageio.imread(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_its_digest(name):
    got = images.imread(os.path.join(HERE, "jpeg_fixtures", name))
    assert list(got.shape) == FIXTURES[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        FIXTURES[name]["sha256"]


@pytest.mark.parametrize("hw", [(48, 48), (47, 63), (5, 3)])
def test_write_jpeg_decodes_to_imageio_bits(tmp_path, hw):
    m = _img(hw[0] + hw[1], *hw, 1)
    path = str(tmp_path / "m.jpg")
    images.write_jpeg(path, m)
    np.testing.assert_array_equal(images.imread(path), imageio.imread(path))


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _refused():
    base = _pil(_img(16, 16, 16))
    sof = base.index(b"\xff\xc0")
    return {
        "arithmetic-coded (SOF9)": _patched(base, b"\xff\xc0", b"\xff\xc9"),
        "lossless (SOF3)": _patched(base, b"\xff\xc0", b"\xff\xc3"),
        "hierarchical (SOF5)": _patched(base, b"\xff\xc0", b"\xff\xc5"),
        "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
        "4-component": _cmyk(),
        "arithmetic-coded JPEGs": jpeg_fixtures.insert_segment(
            base, 0xCC, b"\x00\x10"),
    }


def _cmyk():
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([_img(17, 16, 16),
                                    _img(18, 16, 16, 1)[..., None]], -1),
                    "CMYK").save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["arithmetic-coded (SOF9)",
                                  "lossless (SOF3)", "hierarchical (SOF5)",
                                  "12-bit", "4-component",
                                  "arithmetic-coded JPEGs"])
def test_refused_kinds_raise_naming_them(kind):
    with pytest.raises(ValueError, match=kind.replace("(", r"\(").replace(
            ")", r"\)")):
        jpeg.decode_jpeg(_refused()[kind], "x.jpg")


def test_imread_dispatches_on_the_signature(tmp_path):
    img = _img(19, 12, 20)
    png, jpg, bmp = (str(tmp_path / f"x.{e}") for e in ("png", "jpg", "bmp"))
    images.write_png(png, img)
    with open(jpg, "wb") as f:
        f.write(_pil(img))
    imageio.imwrite(bmp, img)
    np.testing.assert_array_equal(images.imread(png), img)
    np.testing.assert_array_equal(images.imread(jpg), imageio.imread(jpg))
    with pytest.raises(ValueError, match="x.bmp: BMP"):
        images.imread(bmp)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x00\x01")


def _write_jpeg_llff(root, n=20, h=30, w=44):
    """An LLFF scene whose images/ are colour JPEGs of the kinds a camera
    or an editor writes (4:2:0, 4:2:2, 4:4:4, progressive)."""
    scene = root / "fern"
    (scene / "images").mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows = np.zeros((n, 17))
    for i in range(n):
        kw = [dict(subsampling=2), dict(subsampling=1),
              dict(subsampling=0, quality=95), dict(progressive=True)][i % 4]
        (scene / "images" / f"IMG_{i:04d}.JPG").write_bytes(
            _pil(_img(200 + i, h, w), **kw))
        t = rng.randn(3) * 0.1 + np.array([0, 0, 2.0])
        rows[i, :15] = np.concatenate(
            [np.eye(3), t[:, None], np.array([[h], [w], [50.0]])],
            1).reshape(-1)
        rows[i, 15:] = [1.0, 10.0]
    np.save(str(scene / "poses_bounds.npy"), rows)
    return scene


def test_minify_from_jpegs_matches_jax(tmp_path):
    """`_minify` at factor 2 from JPEG sources: the port's PNGs hold the
    JAX package's pixels (imageio decode, cv2 INTER_AREA) bit for bit."""
    scene = _write_jpeg_llff(tmp_path)
    jllff._minify(str(scene), 2)
    os.rename(scene / "images_2", tmp_path / "jax_images_2")
    llff._minify(str(scene), 2)
    files = sorted(os.listdir(tmp_path / "jax_images_2"))
    assert files == sorted(os.listdir(scene / "images_2")) and len(files) == 20
    for f in files:
        np.testing.assert_array_equal(
            images.imread(str(scene / "images_2" / f)),
            imageio.imread(str(tmp_path / "jax_images_2" / f)), err_msg=f)


@pytest.mark.parametrize("factor", [1, 2])
def test_llff_load_from_jpegs_matches_jax(tmp_path, factor):
    """The LLFF load from JPEG images/ at factor 1 (the JPEGs themselves)
    and 2 (through `_minify`) against the JAX loader."""
    scene = _write_jpeg_llff(tmp_path)
    ref = jllff.load_llff(str(scene), factor=factor, train_view_num=3)
    if factor != 1:
        os.rename(scene / f"images_{factor}", tmp_path / "jax_images")
    port = llff.load_llff(str(scene), factor=factor, train_view_num=3)
    assert (port.H, port.W) == (ref.H, ref.W) == (30 // factor, 44 // factor)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_allclose(port.poses, ref.poses, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port.i_train, ref.i_train)
