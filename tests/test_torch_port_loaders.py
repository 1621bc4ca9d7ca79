"""PyTorch port vs the JAX package: the dataset loaders (LLFF, Blender,
DTU, DeepVoxels, LINEMOD), PFM files, the pairs registry, and the port's
own image files and resizes (`data/images.py`) against imageio and cv2.

The fixtures are the JAX loader tests' own (`tests/test_loaders.py`,
`tests/test_legacy_loaders.py`), fed to both packages. Tolerances: images
1e-6, depth / disparity maps 1e-6 relative, poses, K and render poses
1e-5, splits, sizes and near / far exact."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import blender as jblender
from consistentnerf_tpu.data import dtu as jdtu
from consistentnerf_tpu.data import llff as jllff
from consistentnerf_tpu.data import loaders as jloaders
from consistentnerf_tpu.data import pairs as jpairs
from consistentnerf_tpu.data import pfm as jpfm
from consistentnerf_tpu.data import poses as jposes
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.data import blender, dtu, images, llff, loaders
from consistentnerf_tpu_torch.data import pairs, pfm, poses
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from test_legacy_loaders import (_write_deepvoxels_fixture,  # noqa: E402
                                 _write_linemod_fixture)
from test_loaders import (_write_blender_fixture,  # noqa: E402
                          _write_dtu_fixture, _write_llff_fixture,
                          _write_llff_orbit_fixture)

cv2 = pytest.importorskip("cv2")
imageio = pytest.importorskip("imageio.v2")

IMAGE_TOL = 1e-6
POSE_TOL = 1e-5
MAP_RTOL = 1e-6


def _same_scene(port, ref):
    """Every SceneData field of the port's scene against the JAX one's."""
    np.testing.assert_allclose(port.images, ref.images, atol=IMAGE_TOL,
                               rtol=0, err_msg="images")
    assert port.images.dtype == np.float32
    for name in ("poses", "K", "render_poses", "bounds"):
        a, b = getattr(port, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=0, err_msg=name)
    for name in ("depths", "masks", "mono_disp"):
        a, b = getattr(port, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_allclose(a, b, rtol=MAP_RTOL, atol=1e-7,
                                   err_msg=name)
    for name in ("i_train", "i_test", "i_val"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    for name in ("H", "W", "near", "far", "use_ndc", "depth_is_gt"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.focal == pytest.approx(ref.focal, rel=1e-6)


# --- PFM, pairs, poses -------------------------------------------------------


@pytest.mark.parametrize("shape", [(12, 17), (8, 9, 3)])
def test_pfm_files_cross_packages(tmp_path, shape):
    img = np.random.RandomState(0).randn(*shape).astype(np.float32)
    pfm.write_pfm(str(tmp_path / "port.pfm"), img, scale=2.0)
    jpfm.write_pfm(str(tmp_path / "jax.pfm"), img, scale=2.0)
    assert (tmp_path / "port.pfm").read_bytes() == \
        (tmp_path / "jax.pfm").read_bytes()
    back, scale = pfm.read_pfm(str(tmp_path / "jax.pfm"))
    np.testing.assert_array_equal(back, img)
    assert scale == 2.0


def test_pairs_registry_matches_jax(tmp_path):
    port, ref = pairs.load_pairs(), jpairs.load_pairs()
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    for scene, split, n in (("lego", "train", 3), ("dtu", "train", 9),
                            ("fern", "val", None)):
        np.testing.assert_array_equal(pairs.get_split(scene, split, n),
                                      jpairs.get_split(scene, split, n))
    path = str(tmp_path / "pairs.npz")
    np.savez(path, x_train=np.arange(5), x_val=np.arange(5, 7))
    np.testing.assert_array_equal(pairs.get_split("x", "train", 2, path),
                                  [0, 1])
    th = str(tmp_path / "pairs.th")
    torch.save({"x_train": torch.tensor([4, 2]), "x_val": [1, 3]}, th)
    np.testing.assert_array_equal(pairs.get_split("x", "val", path=th),
                                  jpairs.get_split("x", "val", path=th))
    with pytest.raises(KeyError):
        pairs.get_split("nonexistent_scene", "train")


def test_pose_constructions_match_jax():
    rng = np.random.RandomState(3)
    llff_poses = np.concatenate(
        [np.linalg.qr(rng.randn(6, 3, 3))[0], rng.randn(6, 3, 1),
         np.ones((6, 3, 1))], -1).astype(np.float32)
    np.testing.assert_allclose(poses.recenter_poses(llff_poses),
                               jposes.recenter_poses(llff_poses), atol=1e-6)
    np.testing.assert_allclose(poses.poses_avg(llff_poses),
                               jposes.poses_avg(llff_poses), atol=1e-6)
    bds = rng.rand(6, 2) + 1
    for got, want in zip(poses.spherify_poses(llff_poses[:, :, :4], bds),
                         jposes.spherify_poses(llff_poses[:, :, :4], bds)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    args = (poses.poses_avg(llff_poses), np.array([0, 1.0, 0]),
            np.array([0.3, 0.2, 0.1]), 2.0, 0.1, 0.5, 2, 12)
    np.testing.assert_allclose(poses.generate_spiral_path(*args),
                               jposes.generate_spiral_path(*args), atol=1e-6)


# --- images.py: PNG files against imageio, resizes against cv2 -------------


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_filters_against_imageio(channels, filt):
    rng = np.random.RandomState(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    kinds = rng.randint(0, 5, shape[0]) if filt == "mixed" else filt
    data = images.encode_png(img, kinds)
    ref = imageio.imread(io.BytesIO(data))
    np.testing.assert_array_equal(ref, img)
    got = images.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_png_written_by_imageio_reads_the_same(tmp_path):
    """A PNG from another encoder (adaptive row filters)."""
    rng = np.random.RandomState(1)
    img = (np.cumsum(rng.rand(40, 52, 4), 1) * 37 % 256).astype(np.uint8)
    path = str(tmp_path / "x.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(images.imread(path), imageio.imread(path))


@pytest.mark.parametrize("what, header", [
    ("bit depth 16", (4, 3, 16, 3, 0, 0, 0)),
    ("colour type 3", (4, 3, 8, 3, 0, 0, 0)),
    ("interlaced", (4, 3, 8, 2, 0, 0, 2)),
])
def test_png_reader_names_what_it_does_not_read(what, header):
    """What no PNG may be: a palette at 16 bits, a palette image without
    a PLTE chunk, an interlace method past Adam7 (every kind the standard
    allows is read: tests/test_torch_port_png_kinds.py)."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    data = (images.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", *header))
            + chunk(b"IDAT", zlib.compress(b"\0" * 64)) + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=what):
        images.decode_png(data, "f.png")


def test_imread_sends_other_formats_to_imageio(tmp_path, monkeypatch):
    img = (np.random.RandomState(2).rand(16, 16, 3) * 255).astype(np.uint8)
    jpg = str(tmp_path / "x.jpg")
    imageio.imwrite(jpg, img)
    np.testing.assert_array_equal(images.imread(jpg), imageio.imread(jpg))
    png = str(tmp_path / "x.png")
    images.write_png(png, img, 4)
    want = imageio.imread(jpg)
    gif = str(tmp_path / "x.gif")
    imageio.imwrite(gif, img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    # Neither a PNG nor a JPEG needs imageio; any other format raises,
    # naming the file and the format.
    np.testing.assert_array_equal(images.imread(png), img)
    np.testing.assert_array_equal(images.imread(jpg), want)
    with pytest.raises(ValueError, match="x.gif: GIF"):
        images.imread(gif)


RESIZES = [(37, 53, 20, 30), (40, 40, 20, 20), (48, 64, 12, 16),
           (45, 63, 15, 21), (30, 41, 45, 61), (64, 64, 17, 23)]
CV2_FLAGS = {images.INTER_AREA: "INTER_AREA",
             images.INTER_LINEAR: "INTER_LINEAR",
             images.INTER_NEAREST: "INTER_NEAREST"}


@pytest.mark.parametrize("interp", list(CV2_FLAGS))
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_against_cv2(interp, dtype):
    """uint8 bit for bit (cv2's rounding); float32 to 2e-7."""
    rng = np.random.RandomState(4)
    flag = getattr(cv2, CV2_FLAGS[interp])
    for h, w, dh, dw in RESIZES:
        if interp == images.INTER_AREA and (dh > h or dw > w):
            continue
        for c in (1, 3, 4):
            shape = (h, w) if c == 1 else (h, w, c)
            img = (rng.rand(*shape) * 255).astype(np.uint8)
            if dtype == "float32":
                img = rng.rand(*shape).astype(np.float32)
            want = cv2.resize(img, (dw, dh), interpolation=flag)
            got = images.resize(img, (dw, dh), interpolation=interp)
            assert got.shape == want.shape and got.dtype == want.dtype
            if dtype == "uint8":
                np.testing.assert_array_equal(got, want, err_msg=str(
                    (h, w, dh, dw, c)))
            else:
                np.testing.assert_allclose(got, want, atol=2e-7, rtol=0,
                                           err_msg=str((h, w, dh, dw, c)))
    # A size from fx / fy (DTU's GT depths take fx = fy = 0.5).
    img = rng.rand(62, 84).astype(np.float32)
    np.testing.assert_allclose(
        images.resize(img, None, fx=0.5, fy=0.5, interpolation=interp),
        cv2.resize(img, None, fx=0.5, fy=0.5, interpolation=flag),
        atol=2e-7, rtol=0)


# --- the loaders -----------------------------------------------------------


@pytest.mark.parametrize("no_ndc", [False, True])
def test_llff_matches_jax(tmp_path, no_ndc):
    """factor 2 (`_minify` writes images_2), NDC or not, with the MVS
    depth PFMs (INTER_LINEAR to the image size) and MiDaS PFMs."""
    scene_dir = _write_llff_fixture(tmp_path)
    rng = np.random.RandomState(5)
    depth_dir = tmp_path / "nerf_llff_data_depth" / "fern"
    midas_dir = tmp_path / "midas_llff_depth" / "output_llff_fern"
    depth_dir.mkdir(parents=True)
    midas_dir.mkdir(parents=True)
    for i in range(20):
        jpfm.write_pfm(str(depth_dir / f"depth_{i:03d}.pfm"),
                       rng.rand(11, 13).astype(np.float32) * 5 + 1)
        jpfm.write_pfm(str(midas_dir / f"img_{i:03d}-dpt_beit_large_512.pfm"),
                       rng.randn(16, 20).astype(np.float32))
    ref = jllff.load_llff(str(scene_dir), factor=2, no_ndc=no_ndc,
                          train_view_num=3)
    # The port reads the images_2/ the JAX loader wrote, then writes its
    # own from the same sources and must give the same bytes' pixels.
    port = llff.load_llff(str(scene_dir), factor=2, no_ndc=no_ndc,
                          train_view_num=3)
    _same_scene(port, ref)
    assert np.any(port.depths > 0) and np.any(port.mono_disp > 0)
    os.rename(scene_dir / "images_2", tmp_path / "jax_images_2")
    llff._minify(str(scene_dir), 2)
    for f in sorted(os.listdir(tmp_path / "jax_images_2")):
        np.testing.assert_array_equal(
            images.imread(str(scene_dir / "images_2" / f)),
            imageio.imread(str(tmp_path / "jax_images_2" / f)), err_msg=f)


def test_llff_minify_at_a_ratio_that_does_not_divide(tmp_path):
    """factor 3 on 32x40 images: 10x13 (40 / 13 is not an integer), so
    INTER_AREA takes its weighted boxes."""
    scene_dir = _write_llff_fixture(tmp_path)
    ref = jllff.load_llff(str(scene_dir), factor=3, train_view_num=3)
    os.rename(scene_dir / "images_3", tmp_path / "jax_images_3")
    port = llff.load_llff(str(scene_dir), factor=3, train_view_num=3)
    assert (port.H, port.W) == (10, 13)
    _same_scene(port, ref)
    for f in sorted(os.listdir(tmp_path / "jax_images_3")):
        np.testing.assert_array_equal(
            images.imread(str(scene_dir / "images_3" / f)),
            imageio.imread(str(tmp_path / "jax_images_3" / f)), err_msg=f)


def test_llff_spherify_matches_jax(tmp_path):
    scene_dir = _write_llff_orbit_fixture(tmp_path)
    path = str(tmp_path / "pairs.npz")
    np.savez(path, orbit_train=np.arange(0, 16, 2),
             orbit_val=np.arange(1, 16, 4))
    kw = dict(factor=1, spherify=True, no_ndc=True, train_view_num=4,
              pairs_path=path)
    _same_scene(llff.load_llff(str(scene_dir), **kw),
                jllff.load_llff(str(scene_dir), **kw))


@pytest.mark.parametrize("half_res, white", [(False, True), (True, True),
                                             (True, False)])
def test_blender_matches_jax(tmp_path, half_res, white):
    scene_dir = _write_blender_fixture(tmp_path)
    rng = np.random.RandomState(6)
    mvs = tmp_path / "nerf_synthesic_data_depth" / "lego"
    midas = tmp_path / "midas_nerf_depth" / "output_nerf_lego"
    mvs.mkdir(parents=True)
    midas.mkdir(parents=True)
    for i in range(71):
        jpfm.write_pfm(str(mvs / f"depth_{i:03d}.pfm"),
                       rng.rand(24, 24).astype(np.float32) * 4 + 2)
        jpfm.write_pfm(str(midas / f"r_{i}-dpt_beit_large_512.pfm"),
                       rng.randn(24, 24).astype(np.float32))
    kw = dict(half_res=half_res, train_view_num=3, white_bkgd=white)
    port = blender.load_blender(str(scene_dir), **kw)
    _same_scene(port, jblender.load_blender(str(scene_dir), **kw))
    assert port.images.shape[-1] == 3


def _write_dtu_extras(tmp_path, h, w, views):
    """GT depths, MiDaS disparity and IDR masks beside a DTU fixture."""
    rng = np.random.RandomState(7)
    gt = tmp_path / "Depths" / "scan114"
    midas = tmp_path / "midas_dtu_depth" / "output_dtu_scan114"
    masks = tmp_path / "idr_masks" / "scan114" / "mask"
    for d in (gt, midas, masks):
        d.mkdir(parents=True, exist_ok=True)
    for vid in views:
        depth = np.where(rng.rand(1112, 1440) > 0.3,
                         rng.rand(1112, 1440) * 400 + 400, 0)
        jpfm.write_pfm(str(gt / f"depth_map_{vid:04d}.pfm"),
                       depth.astype(np.float32))
    for vid in range(49):
        jpfm.write_pfm(str(midas / f"rect_{vid + 1:03d}_3_r5000"
                           "-dpt_beit_large_512.pfm"),
                       rng.randn(h, w).astype(np.float32))
    for idx in jdtu.pixelnerf_test_idx():
        m = (rng.rand(h, w) > 0.5).astype(np.uint8) * 255
        imageio.imwrite(str(masks / f"{idx:03d}.png"),
                        np.repeat(m[..., None], 3, -1))
    return str(tmp_path / "idr_masks")


@pytest.mark.parametrize("split_type, use_nerf_depth", [
    ("masknerf", True), ("pixelnerf", False)])
def test_dtu_uncropped_matches_jax(tmp_path, split_type, use_nerf_depth):
    """MiDaS priors, the GT-depth switch, both splits, IDR masks."""
    scan_dir = _write_dtu_fixture(tmp_path)
    mask_path = _write_dtu_extras(tmp_path, 60, 80, (0, 25, 48))
    kw = dict(train_view_num=3, crop_images=False, split_type=split_type,
              use_nerf_depth=use_nerf_depth)
    port = dtu.load_dtu(str(scan_dir), **kw)
    ref = jdtu.load_dtu(str(scan_dir), **kw)
    _same_scene(port, ref)
    assert port.mono_disp.min() >= 0 and port.mono_disp.max() > 0
    for factor in (0, 2):
        np.testing.assert_array_equal(
            dtu.load_idr_masks(mask_path, "scan114", factor),
            jdtu.load_idr_masks(mask_path, "scan114", factor))


def test_dtu_cropped_matches_jax(tmp_path):
    """The RegNeRF half-res + [44:556, 80:720] crop of 1112x1440 images
    (INTER_AREA), the shifted intrinsics and the cropped GT depths."""
    scan_dir = _write_dtu_fixture(tmp_path, n_views=3, h=1112, w=1440)
    _write_dtu_extras(tmp_path, 512, 640, (0, 2))
    kw = dict(train_view_num=3, use_nerf_depth=False, num_views=3,
              split_type="pixelnerf")
    port = dtu.load_dtu(str(scan_dir), **kw)
    _same_scene(port, jdtu.load_dtu(str(scan_dir), **kw))
    assert (port.H, port.W) == (512, 640)
    assert port.masks[2].any() and not port.masks[1].any()


def test_dtu_cam_file_matches_jax(tmp_path):
    _write_dtu_fixture(tmp_path, n_views=1)
    path = str(tmp_path / "Depths" / "Cameras" / "train" / "00000000_cam.txt")
    for got, want in zip(dtu.read_cam_file(path), jdtu.read_cam_file(path)):
        np.testing.assert_array_equal(got, want)
    assert dtu.pixelnerf_test_idx() == jdtu.pixelnerf_test_idx()


def test_deepvoxels_matches_jax(tmp_path):
    _write_deepvoxels_fixture(tmp_path)
    for skip in (1, 2):
        _same_scene(loaders.load_deepvoxels(str(tmp_path), "greek", skip),
                    jloaders.load_deepvoxels(str(tmp_path), "greek", skip))


@pytest.mark.parametrize("half_res", [False, True])
def test_linemod_matches_jax(tmp_path, half_res):
    _write_linemod_fixture(tmp_path)
    _same_scene(loaders.load_linemod(str(tmp_path), half_res, 1),
                jloaders.load_linemod(str(tmp_path), half_res, 1))


@pytest.mark.parametrize("kind", ["llff", "blender", "dtu", "deepvoxels",
                                  "LINEMOD"])
def test_load_scene_dispatches_every_dataset(tmp_path, kind):
    """load_scene of both packages on one config: the same scene, and the
    port no longer raises for any dataset type."""
    sets = dict(dataset_type=kind, train_view_num=3, basedir=str(tmp_path),
                testskip=1)
    if kind == "llff":
        sets.update(datadir=str(_write_llff_fixture(tmp_path)), factor=2)
    elif kind == "blender":
        sets.update(datadir=str(_write_blender_fixture(tmp_path)),
                    half_res=True, white_bkgd=True)
    elif kind == "dtu":
        sets.update(datadir=str(_write_dtu_fixture(tmp_path)),
                    dtu_split_type="masknerf")
    elif kind == "deepvoxels":
        _write_deepvoxels_fixture(tmp_path)
        sets.update(datadir=str(tmp_path), shape="greek")
    else:
        _write_linemod_fixture(tmp_path)
        sets.update(datadir=str(tmp_path))
    if kind == "dtu":
        # The DTU crop needs full-size images; the fixture is small.
        with pytest.raises(ValueError, match="crop"):
            loaders.load_scene(configs.Config(**sets), device="cpu")
        return
    ref = jloaders.load_scene(JaxConfig(**sets))
    port = loaders.load_scene(configs.Config(**sets), device="cpu")
    _same_scene(port, ref)


def test_load_scene_hard_masks_on_llff_ndc(tmp_path):
    """The hard masks of an NDC LLFF scene with MVS depths, made by the
    port (on the CPU here) and by the JAX package: equal but for pixels
    on the reprojection boundary (ROADMAP Queue 3 note E)."""
    scene_dir = _write_llff_fixture(tmp_path)
    depth_dir = tmp_path / "nerf_llff_data_depth" / "fern"
    depth_dir.mkdir(parents=True)
    for i in range(20):
        jpfm.write_pfm(str(depth_dir / f"depth_{i:03d}.pfm"),
                       np.full((16, 20), 2.0 + 0.01 * i, np.float32))
    sets = dict(dataset_type="llff", datadir=str(scene_dir), factor=2,
                hardmask=True, train_view_num=3, basedir=str(tmp_path))
    port = loaders.load_scene(configs.Config(**sets), device="cpu")
    ref = jloaders.load_scene(JaxConfig(**sets, expname="jax"))
    assert port.masks.shape == (20, 16, 20) and port.masks.any()
    assert np.mean(port.masks != ref.masks) <= 1e-2
