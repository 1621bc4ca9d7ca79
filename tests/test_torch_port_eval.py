"""PyTorch port vs the JAX package: the metric suite (`core/mathx.py`,
`train/image_metrics.py`), LPIPS with the JAX params carried across,
`evaluate()` on the synthetic scene, the visualization suite, and the
port's eval CLI and `cli/train.py --eval-after` on a tiny checkpoint.

Metrics are held to 1e-5 (relative where the value is not near 0),
LPIPS to 1e-5 relative, `evaluate()`'s values to 1e-4. The evaluate
parity runs at multires 4 / 2 (ROADMAP Queue 3 note D)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core import mathx as jmathx
from consistentnerf_tpu.data import synthetic as jsynthetic
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.train import evaluation as jeval
from consistentnerf_tpu.train import image_metrics as jim
from consistentnerf_tpu.train import lpips as jlpips
from consistentnerf_tpu.train import render as jrender
from consistentnerf_tpu.train import vis as jvis
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import eval as eval_cli
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import images, synthetic
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train import evaluation, image_metrics
from consistentnerf_tpu_torch.train import lpips, vis
from consistentnerf_tpu_torch.train import render as render_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5
EVAL_TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _pair(h=40, w=48, seed=0, noise=0.05):
    rng = np.random.RandomState(seed)
    gt = rng.rand(h, w, 3).astype(np.float32)
    pred = np.clip(gt + noise * rng.randn(h, w, 3), 0, 1).astype(np.float32)
    return pred, gt


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(float(got), float(want), rtol=tol, atol=tol)


# --- metrics ---------------------------------------------------------------


def test_psnr_ssim_and_masked_psnr_match_jax():
    pred, gt = _pair()
    mask = (np.random.RandomState(1).rand(40, 48) > 0.4).astype(np.float32)
    _close(image_metrics.psnr(_t(pred), _t(gt)), jim.psnr(pred, gt))
    _close(image_metrics.ssim(_t(pred)[None], _t(gt)[None])[0],
           jim.ssim(pred[None], gt[None])[0])
    _close(image_metrics.masked_psnr(_t(pred), _t(gt), _t(mask)),
           jim.masked_psnr(pred, gt, mask))


def test_ms_ssim_matches_jax():
    """At the smallest size the five scales take (176), with odd sides
    below it (the pool drops the last row / column)."""
    pred, gt = _pair(177, 179, seed=2, noise=0.2)
    got = image_metrics.ms_ssim(_t(pred)[None], _t(gt)[None])[0]
    _close(got, jax.jit(jim.ms_ssim)(jnp.asarray(pred)[None],
                                     jnp.asarray(gt)[None])[0])
    a, b = image_metrics._avg_pool2(_t(pred)), jim._avg_pool2(pred)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


def test_census_and_error_helpers_match_jax():
    pred, gt = _pair(seed=3)
    eps = 1.0 / 255
    np.testing.assert_array_equal(
        mathx.compute_ternary_census(_t(pred), eps).numpy(),
        np.asarray(jmathx.compute_ternary_census(pred, eps)))
    _close(mathx.compute_census_err(_t(pred), _t(gt), eps),
           jmathx.compute_census_err(pred, gt, eps))
    _close(mathx.compute_avg_error(torch.tensor(23.5), torch.tensor(0.81),
                                   torch.tensor(0.2)),
           jmathx.compute_avg_error(23.5, 0.81, 0.2))
    _close(mathx.psnr_to_mse(torch.tensor(21.0)), jmathx.psnr_to_mse(21.0))
    x = np.linspace(-0.01, 1.2, 97).astype(np.float32)
    np.testing.assert_allclose(mathx.linear_to_srgb(_t(x)).numpy(),
                               np.asarray(jmathx.linear_to_srgb(x)),
                               rtol=TOL, atol=1e-7)
    np.testing.assert_allclose(mathx.srgb_to_linear(_t(x)).numpy(),
                               np.asarray(jmathx.srgb_to_linear(x)),
                               rtol=TOL, atol=1e-7)


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """The JAX package's uncalibrated LPIPS init written in the `.npz`
    export format, and the JAX params."""
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jlpips.init_params)(jax.random.PRNGKey(0)))
    arrays = {}
    for bi, block in enumerate(params["convs"]):
        for ci, conv in enumerate(block):
            arrays[f"conv{bi}_{ci}_w"] = conv["w"]
            arrays[f"conv{bi}_{ci}_b"] = conv["b"]
        arrays[f"lin{bi}"] = params["lins"][bi]
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **arrays)
    return path, params


def test_lpips_with_carried_params_matches_jax(lpips_npz):
    path, params = lpips_npz
    pred, gt = _pair(48, 56, seed=4)
    want = np.asarray(jlpips.lpips(params, jnp.asarray(pred)[None] * 2 - 1,
                                   jnp.asarray(gt)[None] * 2 - 1))
    carried = interop.lpips_params_from_jax(params)
    got = lpips.lpips(carried, _t(pred)[None] * 2 - 1, _t(gt)[None] * 2 - 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
    fn = lpips.LPIPS(path, device="cpu")
    assert fn.is_calibrated
    np.testing.assert_allclose(fn(_t(pred), _t(gt)).numpy(), want, rtol=TOL)
    for a, b in zip(fn.params["lins"], carried["lins"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_lpips_uncalibrated_init_has_the_jax_shapes():
    port = lpips.LPIPS(None, seed=0, device="cpu")
    assert not port.is_calibrated
    ref = jax.eval_shape(jlpips.init_params, jax.random.PRNGKey(0))
    for pb, jb in zip(port.params["convs"], ref["convs"]):
        for pc, jc in zip(pb, jb):
            assert tuple(pc["w"].permute(2, 3, 1, 0).shape) == jc["w"].shape
            var = 2.0 / (9 * jc["w"].shape[2])
            assert abs(float(pc["w"].var()) / var - 1) < 0.2
    for pl, jl in zip(port.params["lins"], ref["lins"]):
        assert pl.shape == jl.shape and float(pl.min()) >= 0
    again = lpips.LPIPS(None, seed=0, device="cpu")
    pred, gt = _pair(32, 32, seed=5)
    assert float(port(_t(pred), _t(gt))) == float(again(_t(pred), _t(gt)))


@pytest.mark.parametrize("masked", [False, True])
def test_compute_image_metrics_matches_jax(lpips_npz, masked):
    path, _ = lpips_npz
    pred, gt = _pair(40, 44, seed=6)
    mask = ((np.random.RandomState(7).rand(40, 44) > 0.5)
            .astype(np.float32) if masked else None)
    got = evaluation.compute_image_metrics(
        pred, gt, lpips.LPIPS(path, device="cpu"), mask)
    want = jeval.compute_image_metrics(pred, gt, jlpips.LPIPS(path), mask)
    assert sorted(got) == sorted(want)
    assert ("masked_lpips" in got) == masked
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("side, has_ms_ssim", [(175, False), (176, True)])
def test_ms_ssim_only_at_176_pixels_a_side(side, has_ms_ssim):
    pred, gt = _pair(side, 200, seed=8)
    got = evaluation.compute_image_metrics(pred, gt)
    assert ("ms_ssim" in got) == has_ms_ssim
    assert "lpips" not in got and "avg_err" not in got


# --- evaluate() ------------------------------------------------------------

TINY = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=8,
            N_importance=4, multires=4, multires_views=2, white_bkgd=True,
            render_chunk_size=256, perturb=0.0)


@pytest.fixture(scope="module")
def eval_setup(request, lpips_npz):
    """A JAX VanillaNeRF's params and the port model holding the same
    weights, on the 5-view 32x32 synthetic scene of both packages."""
    return once_per_run(request, lambda: _eval_setup(lpips_npz))


def _eval_setup(lpips_npz):
    path, _ = lpips_npz
    jcfg = JaxConfig(**TINY, use_tensorboard=False, lpips_weights_path=path)
    pcfg = configs.Config(**TINY, lpips_weights_path=path)
    jscene = jsynthetic.make_scene(n_views=5, H=32, W=32).to_scene_data()
    pscene = synthetic.make_scene(n_views=5, H=32, W=32).to_scene_data()
    jmodel = jax_make_model(jcfg)
    from consistentnerf_tpu.core.rays import Rays as JaxRays

    n = 4
    ones = jnp.ones((n, 1))
    dummy = JaxRays(origins=jnp.zeros((n, 3)), directions=jnp.ones((n, 3)),
                    viewdirs=jnp.ones((n, 3)) / np.sqrt(3), radii=ones,
                    lossmult=ones, near=ones * 2, far=ones * 6)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), None, dummy))
    model = make_model(pcfg, CPU)
    model.load_state_dict(interop.params_from_jax(params))
    model.eval()
    return jcfg, pcfg, jscene, pscene, jmodel, params, model


@pytest.mark.parametrize("mode", ["artifacts", "masked"])
def test_evaluate_matches_jax(tmp_path, eval_setup, mode, monkeypatch):
    """The same keys, the same file names, every value within 1e-4 but
    eval_rays_per_sec (a time): with the images written (the JAX
    package's blocking path), and DTU-masked without them (its deferred
    per-view path). The images: see `assert_same_pngs`."""
    import dataclasses

    jcfg, pcfg, jscene, pscene, jmodel, params, model = eval_setup
    kw = dict(views=np.array([0, 2, 4]), step=3,
              save_images=mode == "artifacts")
    if mode == "masked":
        masks = np.zeros(pscene.images.shape[:3], np.float32)
        masks[:, 6:26, 4:28] = 1.0
        jscene = dataclasses.replace(jscene, masks=masks)
        pscene = dataclasses.replace(pscene, masks=masks)
        jcfg = jcfg.replace(dataset_type="dtu")
        pcfg = pcfg.replace(dataset_type="dtu")
    want = jeval.evaluate(jmodel, jcfg, params, jscene,
                          out_dir=str(tmp_path / "jax"), **kw)
    got = evaluation.evaluate(model, pcfg, pscene,
                              out_dir=str(tmp_path / "port"), **kw)
    assert sorted(got) == sorted(want)
    assert ("masked_lpips" in got) == (mode == "masked")
    for k in want:
        if k != "eval_rays_per_sec":
            np.testing.assert_allclose(got[k], want[k], atol=EVAL_TOL,
                                       rtol=EVAL_TOL, err_msg=k)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    if mode == "artifacts":
        png = images.read_png(str(tmp_path / "port" / "color_002.png"))
        assert png.shape == (32, 32, 3)
        # The JAX evaluate() again, on the port's renders.
        port_render = render_lib.build_render_fn(model, pcfg)

        def port_renders(model_, cfg_, params_):
            def render(rays):
                with torch.no_grad():
                    out = port_render(Rays(**{
                        f.name: torch.from_numpy(np.asarray(
                            getattr(rays, f.name)))
                        for f in dataclasses.fields(Rays)}))
                return {k: jnp.asarray(v.numpy()) for k, v in out.items()}
            return render

        monkeypatch.setattr(jrender, "build_render_fn", port_renders)
        jeval.evaluate(jmodel, jcfg, params, jscene,
                       out_dir=str(tmp_path / "jax_on_port_renders"), **kw)
        assert_same_pngs(tmp_path / "port", tmp_path / "jax",
                         tmp_path / "jax_on_port_renders", 9)


def assert_same_pngs(port_dir, jax_dir, jax_on_port_dir, n):
    """The `n` PNGs of both packages' evaluate(): on the port's renders,
    the JAX package's decode to the port's bytes, every kind (color,
    depth in matplotlib's turbo, acc, normals). On each package's own
    renders (within 1e-4 of each other), color and acc within 1 level:
    both truncate to u8, so a render one float step apart (acc 1.0
    against 0.99999994) can sit a level apart; depth is not compared
    there, as a colormap entry can be several levels from the next."""
    names = sorted(f for f in os.listdir(jax_dir) if f.endswith(".png"))
    assert len(names) == n
    for d in (port_dir, jax_on_port_dir):
        assert names == sorted(f for f in os.listdir(d) if f.endswith(".png"))
    for name in names:
        got = images.read_png(str(port_dir / name))
        want = images.read_png(str(jax_on_port_dir / name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if name.startswith(("color", "acc")):
            own = images.read_png(str(jax_dir / name)).astype(int)
            assert np.abs(got.astype(int) - own).max() <= 1, name


@pytest.mark.parametrize("per_call, device, n, want", [
    (0, "cpu", 5, 1), (0, "cuda", 5, 3), (0, "cuda", 25, 4),
    (2, "cpu", 5, 2), (8, "cuda", 3, 2), (3, "cuda", 1, 1),
])
def test_views_per_call_keeps_a_warm_window(per_call, device, n, want):
    """evaluate()'s group size: eval_views_per_call (0: 1 on the CPU, 4 on
    a card), at most half the views rounded up."""
    cfg = configs.Config(eval_views_per_call=per_call)
    assert evaluation.views_per_call(cfg, device, n) == want


def test_evaluate_writes_each_views_pngs_from_its_group(tmp_path):
    """Views in groups of two, each group's PNGs written after the next
    group is rendered: every color_{n}.png is view n's own render, the
    ragged last group's too, and only the selected views are written."""
    cfg = configs.Config(**TINY, eval_views_per_call=2,
                         eval_disable_lpips=True, eval_render_interval=2)
    scene = synthetic.make_scene(n_views=5, H=32, W=32).to_scene_data()
    model = make_model(cfg, CPU).eval()
    views = np.array([4, 3, 2, 1, 0, 4, 3, 2, 1])
    evaluation.evaluate(model, cfg, scene, out_dir=str(tmp_path),
                        views=views, step=1)
    colors = sorted(f for f in os.listdir(tmp_path)
                    if f.startswith("color_"))
    assert colors == [f"color_{n:03d}.png" for n in (0, 2, 4, 6, 8)]
    for n in (0, 2, 4, 6, 8):
        rays = evaluation.camera_rays_for_view(scene, scene.poses[views[n]],
                                               device=CPU)
        rgb = render_lib.render_image(model, cfg, rays)["rgb"]
        want = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        got = images.read_png(str(tmp_path / f"color_{n:03d}.png"))
        assert np.abs(got.astype(int) - want).max() <= 1, n


# --- visualization and the render CLI's depth ranges ----------------------


def test_visualize_suite_and_png_round_trip(tmp_path):
    """Every key of the suite equals the JAX package's bit for bit; a
    depth PNG reads back as written; visualize_rays draws an image."""
    rng = np.random.RandomState(0)
    depth = rng.rand(16, 16).astype(np.float32) * 4 + 2
    acc = rng.rand(16, 16).astype(np.float32)
    rendering = {"rgb": rng.rand(16, 16, 3), "depth": depth, "acc": acc,
                 "disp": 1.0 / depth}
    normals = rng.randn(16, 16, 3)
    rendering["normals"] = normals / np.linalg.norm(normals, axis=-1,
                                                    keepdims=True)
    suite = vis.visualize_suite(rendering)
    want = jvis.visualize_suite(rendering)
    assert sorted(suite) == sorted(want)
    for k, v in suite.items():
        assert v.shape == (16, 16, 3) and v.min() >= 0 and v.max() <= 1, k
        # depth and disp: matplotlib's turbo table and lookup, exactly.
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(suite["color"],
                                  np.clip(rendering["rgb"], 0, 1))
    path = str(tmp_path / "x.png")
    vis.save_img_u8(suite["depth"], path)
    np.testing.assert_array_equal(
        images.read_png(path), (suite["depth"] * 255).astype(np.uint8))
    img = vis.visualize_rays(np.sort(rng.rand(4, 9), -1), rng.rand(4, 8))
    assert img.ndim == 3 and img.shape[-1] == 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_turbo_colormap_is_matplotlibs(dtype):
    """The JAX package's colormap (matplotlib's turbo of the clipped
    value) bit for bit: every table entry's interval and its edges,
    values out of [0, 1], NaN, and both float widths."""
    x = np.concatenate([np.linspace(-0.5, 1.5, 4001), np.arange(257) / 256,
                        np.nextafter(np.arange(1, 257) / 256, 0),
                        [np.nan, np.inf, -np.inf, 1 - 1e-17]]).astype(dtype)
    got = vis._turbo_colormap(x)
    want = jvis._turbo_colormap(x)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_save_img_f32_reads_back_bit_for_bit(tmp_path):
    """The port's float TIFF (no PIL) holds the same floats as the JAX
    package's (Pillow's) through imageio, and the same bytes."""
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.RandomState(3)
    for shape in ((1, 1), (17, 23), (64, 48)):
        depth = rng.randn(*shape) * 3
        depth[0, 0] = np.nan
        depth.flat[-1] = np.inf
        got, want = tmp_path / "port" / "d.tif", tmp_path / "jax" / "d.tif"
        vis.save_img_f32(depth, str(got))
        jvis.save_img_f32(depth, str(want))
        a, b = imageio.imread(str(got)), imageio.imread(str(want))
        assert a.dtype == b.dtype == np.float32 and a.shape == shape
        assert a.tobytes() == b.tobytes(), shape
        assert got.read_bytes() == want.read_bytes(), shape
    with pytest.raises(ValueError, match="one \\[H, W\\] map"):
        vis.save_img_f32(np.zeros((4, 4, 3)), str(got))


def test_render_cli_depth_ranges_match_jax():
    from consistentnerf_tpu.cli import render as jrender_cli

    assert render_cli.LLFF_DEPTH_RANGES == jrender_cli.LLFF_DEPTH_RANGES
    assert render_cli.DTU_DEPTH_RANGES == jrender_cli.DTU_DEPTH_RANGES
    for kind, datadir in (("llff", "data/nerf_llff_data/fern"),
                          ("dtu", "data/dtu/scan114"),
                          ("blender", "data/nerf_synthetic/lego")):
        cfg = configs.Config(dataset_type=kind, datadir=datadir)
        jcfg = JaxConfig(dataset_type=kind, datadir=datadir)
        assert render_cli.scene_depth_range(cfg) == \
            jrender_cli.scene_depth_range(jcfg)


# --- the CLIs ---------------------------------------------------------------


def test_eval_cli_and_eval_after_on_a_tiny_checkpoint(tmp_path, capsys):
    """`cli/train.py --eval-after` scores the test views when training
    ends; `cli/eval.py` restores that checkpoint and gives the same
    metrics and files."""
    args = ["--device", "cpu"] + [x for s in (
        "dataset_type=synthetic", "synthetic_views=4", "synthetic_hw=16",
        "synthetic_n_test=2", "netdepth=2", "netwidth=32", "N_samples=8",
        "N_importance=4", "multires=4", "multires_views=2", "N_rand=64",
        "n_patches=1", "patch_size=8", "white_bkgd=true", "i_print=1",
        "eval_disable_lpips=true", f"basedir={tmp_path}", "expname=tiny")
        for x in ("--set", s)]
    res = train_cli.main(args + ["--num-steps", "2", "--eval-after"])
    preds = tmp_path / "tiny" / "test_preds"
    assert sorted(res.metrics) == ["census_err", "eval_rays_per_sec",
                                   "psnr", "ssim"]
    assert (preds / "metric_psnr_2.txt").is_file()
    assert (preds / "color_001.png").is_file()
    after = {k: v for k, v in res.metrics.items() if k != "eval_rays_per_sec"}
    os.rename(preds, tmp_path / "after")
    metrics = eval_cli.main(args)
    for k, v in after.items():
        assert metrics[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
    assert sorted(os.listdir(preds)) == sorted(os.listdir(tmp_path / "after"))
    assert "warning: no checkpoint" not in capsys.readouterr().out
    metrics = eval_cli.main(args + ["--set", "expname=none"])
    assert "warning: no checkpoint found" in capsys.readouterr().out


def test_idr_masks_take_the_loaders_crop(tmp_path):
    """IDR masks at the dataset's 1200x1600 are brought to the DTU
    loader's crop (half resolution, rows 44:556, cols 80:720), as its
    images are; masks of another size raise, naming both sizes."""
    from consistentnerf_tpu_torch.data import dtu

    masks = tmp_path / "idr" / "scan114" / "mask"
    masks.mkdir(parents=True)
    yy, xx = np.mgrid[:1200, :1600]
    full = {}
    for idx in dtu.pixelnerf_test_idx():
        m = ((yy // 37 + xx // (53 + idx)) % 2).astype(np.uint8) * 255
        full[idx] = m
        images.write_png(str(masks / f"{idx:03d}.png"),
                         np.repeat(m[..., None], 3, -1))
    scene = synthetic.make_scene(n_views=4, H=8, W=8).to_scene_data()
    scene.H, scene.W = 512, 640
    scene.i_test = np.asarray(dtu.pixelnerf_test_idx())
    cfg = configs.Config(dataset_type="dtu", datadir="data/dtu/scan114",
                         dtu_mask_path=str(tmp_path / "idr"), factor=0)
    got = evaluation._idr_masks(cfg, scene)
    for idx in (1, 47):
        want = (full[idx][::2, ::2][44:556, 80:720] == 255).astype(np.float32)
        np.testing.assert_array_equal(got[idx], want)
    scene.H = 500
    with pytest.raises(ValueError, match="IDR masks"):
        evaluation._idr_masks(cfg, scene)
