"""The producer CLIs of the port on the CPU at a tiny size: `cli/train.py
--bootstrap-priors`, `cli/train_mvs.py`, `cli/export_depth_priors.py` and
`cli/make_masks.py`, each by the files it writes and what they hold, and
`make_masks` against the JAX CLI on the same scene; and the port's JPEG
writer (`data/images.py::write_jpeg`), the producers' mask JPGs, read by
PIL (installed where the tests run on the CPU; the card's machine has
no imaging package).

Tolerances: exported depths equal the port's own render of the restored
model bit for bit (one function, one device); make_masks' masks.npy
equals the JAX CLI's but where `reproject.boundary_pixels` flags a
rounding (at most 0.01% of the train pixels); a JPEG of a 0/255 mask
decoded and cut at 128 equals the mask, and its mean absolute difference
from imageio's JPEG of the same mask (libjpeg, quality 75), both decoded
by PIL, is below 1 grey level (the two quantise the same table; only
their rounding differs).
"""

import io
import os

import numpy as np
import pytest

from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.cli import export_depth_priors, make_masks
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.cli import train_mvs
from consistentnerf_tpu_torch.consistency import reproject
from consistentnerf_tpu_torch.data import images, synthetic
from consistentnerf_tpu_torch.data.loaders import load_scene
from consistentnerf_tpu_torch.data.pfm import read_pfm
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train import render as render_lib
from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
from consistentnerf_tpu_torch.train.evaluation import camera_rays_for_view
from torch_port_shared import _one_torch_thread  # noqa: F401

JPEG_MAD_VS_LIBJPEG = 1.0
MAX_BOUNDARY_SHARE = 1e-4
TINY = ["dataset_type=synthetic", "synthetic_hw=24", "synthetic_views=6",
        "netdepth=2", "netwidth=32", "N_samples=8", "N_importance=8",
        "multires=4", "multires_views=2", "N_rand=64", "n_patches=1",
        "patch_size=8", "white_bkgd=true", "hardmask=true",
        "with_depth_loss=true", "i_print=1000", "checkpoint_every=4",
        "mvs_num_depths=8", "mvs_base_ch=4", "render_chunk_size=512"]


def _args(tmp_path, *extra, expname="tiny"):
    sets = TINY + [f"basedir={tmp_path}", f"expname={expname}"] + list(extra)
    return ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]


def _scene(tmp_path):
    cfg = configs.load_config(None, TINY + [f"basedir={tmp_path}",
                                            "expname=tiny"])
    return cfg, load_scene(cfg, device="cpu", attach=False)


def _decode(path):
    from PIL import Image

    with open(path, "rb") as f:
        return np.asarray(Image.open(io.BytesIO(f.read())))


def _mask(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    m = (((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (0.3 * h) ** 2) | (
        rng.rand(h, w) < 0.02)
    return (m * 255).astype(np.uint8)


@pytest.mark.parametrize("hw", [(48, 48), (47, 63), (5, 3)])
def test_write_jpeg_decodes_to_the_mask(tmp_path, hw):
    import imageio.v2 as imageio

    m = _mask(*hw)
    path = str(tmp_path / "m.jpg")
    images.write_jpeg(path, m)
    data = open(path, "rb").read()
    # Baseline JFIF: SOI, APP0 "JFIF", SOF0 with the size, EOI.
    assert data[:2] == b"\xff\xd8" and data[6:11] == b"JFIF\x00"
    sof = data.index(b"\xff\xc0")
    assert data[sof + 4] == 8
    assert (int.from_bytes(data[sof + 5:sof + 7], "big"),
            int.from_bytes(data[sof + 7:sof + 9], "big")) == hw
    assert data[-2:] == b"\xff\xd9"
    got = _decode(path)
    assert got.shape == hw and got.dtype == np.uint8
    np.testing.assert_array_equal(got >= 128, m >= 128)
    ref = str(tmp_path / "ref.jpg")
    imageio.imwrite(ref, m)
    mad = np.abs(got.astype(int) - _decode(ref).astype(int)).mean()
    assert mad < JPEG_MAD_VS_LIBJPEG, mad


def test_write_jpeg_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError):
        images.encode_jpeg(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        images.encode_jpeg(np.zeros((4, 4), np.float32))


def test_train_cli_bootstrap_priors(tmp_path):
    res = train_cli.main(_args(tmp_path) + ["--num-steps", "4",
                                            "--bootstrap-priors", "4"])
    assert res.state.step == 4
    exp = tmp_path / "tiny"
    out = exp / "bootstrap_priors"
    tr = np.asarray(_scene(tmp_path)[1].i_train)
    assert sorted(os.listdir(out)) == sorted(
        [f"depth_{v:04d}.pfm" for v in tr] + [f"{v}_mask_boot.jpg"
                                              for v in tr])
    for v in tr:
        depth, _ = read_pfm(str(out / f"depth_{v:04d}.pfm"))
        assert depth.shape == (24, 24)
        assert _decode(str(out / f"{v}_mask_boot.jpg")).shape == (24, 24)
    # The warmup and the retrain each checkpoint under their own expname.
    assert (exp / "checkpoints").is_dir()
    assert (tmp_path / "tiny_warmup" / "checkpoints").is_dir()


def test_train_mvs_cli(tmp_path, capsys):
    out = tmp_path / "priors"
    result, priors = train_mvs.main(_args(tmp_path) + [
        "--steps", "4", "--out", str(out), "--with-masks"])
    text = capsys.readouterr().out
    assert "GT-supervised" in text
    assert "prior depth-MSE vs scene GT on train views" in text
    scene = _scene(tmp_path)[1]
    tr = np.asarray(scene.i_train)
    assert result.steps == 4 and np.isfinite(result.final_loss)
    masks = reproject.compute_hard_masks(
        scene.poses, priors, scene.K, tr, 24, 24, device="cpu")
    for v in tr:
        depth, _ = read_pfm(str(out / f"depth_{v:04d}.pfm"))
        np.testing.assert_array_equal(np.asarray(depth), priors[v])
        got = _decode(str(out / f"{v}_mask_mvs.jpg"))
        np.testing.assert_array_equal(got >= 128, masks[v])


def test_export_depth_priors_cli(tmp_path, capsys):
    train_cli.main(_args(tmp_path) + ["--num-steps", "4"])
    out = tmp_path / "exported"
    step = export_depth_priors.main(_args(tmp_path) + [
        "--out", str(out), "--views", "train"])
    assert step == 4
    cfg, scene = _scene(tmp_path)
    model = make_model(cfg, "cpu")
    CheckpointManager(str(tmp_path / "tiny" / "checkpoints")
                      ).restore_for_eval(model, 4)
    model.eval()
    render = render_lib.build_render_fn(model, cfg)
    assert sorted(os.listdir(out)) == [f"depth_{v:04d}.pfm"
                                       for v in scene.i_train]
    for v in scene.i_train:
        depth, _ = read_pfm(str(out / f"depth_{v:04d}.pfm"))
        want = render(camera_rays_for_view(scene, scene.poses[v],
                                           device="cpu"))["depth"]
        np.testing.assert_array_equal(np.asarray(depth), want.numpy())
    # --views all, and without a checkpoint: a random init, said so.
    export_depth_priors.main(_args(tmp_path, expname="none") + [
        "--out", str(tmp_path / "all")])
    assert "random init" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "all")) == len(scene.images)


def test_make_masks_cli_matches_the_jax_cli(tmp_path):
    from consistentnerf_tpu.cli import make_masks as jmake_masks

    sets = ["dataset_type=synthetic", "synthetic_hw=48",
            "synthetic_views=6", f"basedir={tmp_path}"]
    port_dir = make_masks.main(
        ["--device", "cpu", "--out", str(tmp_path / "port")]
        + [x for s in sets for x in ("--set", s)])
    jmake_masks.main(["--out", str(tmp_path / "jax")]
                     + [x for s in sets + ["use_tensorboard=false"]
                        for x in ("--set", s)])
    got = np.load(os.path.join(port_dir, "masks.npy"))
    want = np.load(str(tmp_path / "jax" / "masks.npy"))
    assert got.dtype == want.dtype == bool and got.shape == want.shape
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    near = reproject.boundary_pixels(scene.poses, scene.depths, scene.K,
                                     scene.i_train, 48, 48, device="cpu")
    diff = got != want
    assert not (diff & ~near).any()
    assert diff.sum() <= MAX_BOUNDARY_SHARE * got[scene.i_train].size
    assert sorted(os.listdir(port_dir)) == sorted(
        os.listdir(tmp_path / "jax"))
    for i in range(len(got)):
        img = _decode(os.path.join(port_dir, f"{i}_mask_3view.jpg"))
        np.testing.assert_array_equal(img >= 128, got[i])
    # The default directory: {basedir}/{expname}/mask/{scene}/{n}view.
    default = make_masks.main(["--device", "cpu"]
                              + [x for s in sets for x in ("--set", s)])
    assert default.endswith(os.path.join("mask", "lego", "3view"))
    np.testing.assert_array_equal(
        np.load(os.path.join(default, "masks.npy")), got)
