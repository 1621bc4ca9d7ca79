"""The port's render slice vs the JAX package: the fused render, the
VanillaNeRF forward, chunked rendering, the render CLI restoring an
exported `.tar`, and the PNG/depth visualization. Depth 8 at width 32,
8 + 8 samples, fp32; the JAX fused render runs its Pallas kernel in
interpret mode.

The slice runs at multires 4 / 2, the frequencies of the JAX package's
own fused-render test: a fine sample's depth comes out of the inverse CDF,
which turns ~1e-6 differences in the coarse weights into ~1e-4 moves
where a bin's pdf is small, and at 2^9 the fine MLP turns those into
changes far above 2e-4. The MLP itself is held at multires 10 / 4 in
test_torch_port_mlp.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli.export_torch_ckpt import export_checkpoint
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.models.nerf import VanillaNeRF as JaxVanillaNeRF
from consistentnerf_tpu.ops import fused_render as jfr
from consistentnerf_tpu.train import vis as jvis
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import common
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_render
from consistentnerf_tpu_torch.train import evaluation, vis
from consistentnerf_tpu_torch.train import render as render_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

DEPTH, WIDTH, S_C, S_F, MR, MV = 8, 32, 8, 8, 4, 2
KEYS = ["rgb", "depth", "acc", "rgb0", "depth0"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def slice_setup(request):
    """Seeded JAX VanillaNeRF params, the port model carrying the same
    weights, and numpy rays through the scene's [near, far] band."""
    return once_per_run(request, _slice_setup)


def _slice_setup():
    rs = np.random.RandomState(3)
    n = 40
    d = rs.randn(n, 3).astype(np.float32)
    o = (-2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)
         + 0.3 * rs.randn(n, 3)).astype(np.float32)
    ones = np.ones((n, 1), np.float32)
    fields = dict(origins=o, directions=d,
                  viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=ones * 1e-3, lossmult=ones, near=ones * 0.5,
                  far=ones * 4.5)
    jrays = JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()})
    prays = Rays(**{k: torch.from_numpy(v) for k, v in fields.items()})
    jmodel = JaxVanillaNeRF(num_samples=S_C, num_importance=S_F,
                            multires=MR, multires_views=MV,
                            net_depth=DEPTH, net_width=WIDTH,
                            white_bkgd=True)
    params = jmodel.init(jax.random.PRNGKey(0), None, jrays)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = VanillaNeRF(num_samples=S_C, num_importance=S_F, multires=MR,
                        multires_views=MV, net_depth=DEPTH, net_width=WIDTH,
                        white_bkgd=True)
    model.load_state_dict(interop.params_from_jax(params))
    return jmodel, params, jrays, model, prays


def _assert_slice_close(got, want):
    # The bound the JAX fused render meets against model.apply.
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


def test_fused_render_matches_jax_fused_render(slice_setup):
    _, params, jrays, model, prays = slice_setup
    want = jfr.fused_render_rays(
        params, jrays, num_samples=S_C, num_importance=S_F, multires=MR,
        multires_views=MV, net_depth=DEPTH, white_bkgd=True, tile=32,
        interpret=True, kernel="v2", pdf_kernel=False,
    )
    weights = {lvl: fm.flatten_params(getattr(model, lvl), True, DEPTH)
               for lvl in ("coarse", "fine")}
    with torch.no_grad():
        got = fused_render.fused_render_rays(
            weights, prays, num_samples=S_C, num_importance=S_F,
            multires=MR, multires_views=MV, net_depth=DEPTH, white_bkgd=True,
        )
    _assert_slice_close(got, want)


def test_vanilla_nerf_matches_jax_apply(slice_setup):
    jmodel, params, jrays, model, prays = slice_setup
    want = jmodel.apply(params, None, jrays)
    with torch.no_grad():
        got = model(prays)
    _assert_slice_close(got, want)
    np.testing.assert_allclose(got["z_std"].numpy(),
                               np.asarray(want["z_std"]), atol=2e-4,
                               rtol=2e-4)


def test_unported_render_variants_raise(slice_setup):
    """No variant raises any more: kernel='v1' (#12) and the one-pass and
    pdf-kernel variants render what the JAX variants render; an unknown
    kernel name raises."""
    _, params, jrays, model, prays = slice_setup
    weights = {lvl: fm.flatten_params(getattr(model, lvl), True, DEPTH)
               for lvl in ("coarse", "fine")}
    kw = dict(num_samples=S_C, num_importance=S_F, multires=MR,
              multires_views=MV, net_depth=DEPTH, white_bkgd=True)
    with pytest.raises(ValueError, match="unknown fused render kernel"):
        fused_render.fused_render_rays(weights, prays, kernel="v3", **kw)
    want = jfr.fused_render_rays(params, jrays, tile=32, interpret=True,
                                 kernel="v1", pdf_kernel=False, **kw)
    with torch.no_grad():
        got = fused_render.fused_render_rays(weights, prays, kernel="v1",
                                             **kw)
    _assert_slice_close(got, want)
    for switch in (dict(onepass=True), dict(pdf_kernel=True)):
        want = jfr.fused_render_rays(
            params, jrays, tile=32, interpret=True, kernel="v2",
            **{"onepass": False, "pdf_kernel": False, **switch}, **kw)
        with torch.no_grad():
            got = fused_render.fused_render_rays(weights, prays, **switch,
                                                 **kw)
        _assert_slice_close(got, want)


def _tiny_cfg(**kw):
    base = dict(dataset_type="synthetic", synthetic_views=3,
                synthetic_hw=10, synthetic_n_test=1, netdepth=DEPTH,
                netwidth=WIDTH, N_samples=S_C, N_importance=S_F,
                white_bkgd=True)
    base.update(kw)
    return configs.Config(**base)


@pytest.mark.parametrize("fused", [False, True])
def test_build_render_fn_chunks_like_one_call(fused):
    """A 10x13 view (130 rays) in chunks of 48 (the last one ragged)
    equals the single-chunk render, for both branches; a [V, H, W] stack
    equals its views rendered one by one."""
    cfg = _tiny_cfg(use_fused_render=fused, compute_dtype="float32")
    model = make_model(cfg, CPU).eval()
    scene = synthetic.make_scene(n_views=2, H=10, W=13).to_scene_data()
    views = [evaluation.camera_rays_for_view(scene, p, device=CPU)
             for p in scene.poses]
    chunked = render_lib.build_render_fn(
        model, cfg.replace(render_chunk_size=48))
    whole = render_lib.build_render_fn(model, cfg.replace(
        render_chunk_size=1024))
    a, b = chunked(views[0]), whole(views[0])
    assert a["rgb"].shape == (10, 13, 3) and a["depth"].shape == (10, 13)
    for k in ("rgb", "depth", "disp", "acc"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    stacked = chunked(render_lib.stack_rays(views))
    assert stacked["rgb"].shape == (2, 10, 13, 3)
    np.testing.assert_allclose(stacked["rgb"][1].numpy(),
                               chunked(views[1])["rgb"].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_fused_and_plain_render_agree_at_bf16():
    """Kernel path vs module path of build_render_fn at bf16 on the CPU:
    the same rounding points, so only sum order differs."""
    cfg = _tiny_cfg(compute_dtype="bfloat16")
    model = make_model(cfg, CPU).eval()
    scene = synthetic.make_scene(n_views=1, H=10, W=10).to_scene_data()
    rays = evaluation.camera_rays_for_view(scene, scene.poses[0],
                                           device=CPU)
    fused = render_lib.render_image(model, cfg.replace(
        use_fused_render=True), rays)
    plain = render_lib.render_image(model, cfg, rays)
    assert np.abs(fused["rgb"] - plain["rgb"]).mean() < 2e-3


def test_auto_fused_defaults():
    p = common.make_parser("t")
    bf16 = ["--set", "compute_dtype=bfloat16"]
    cfg = configs.load_config(None, ["compute_dtype=bfloat16"])
    assert common.auto_fused_defaults(cfg, p.parse_args(bf16)) \
        .use_fused_render is True
    cpu = p.parse_args(bf16 + ["--device", "cpu"])
    assert common.auto_fused_defaults(cfg, cpu).use_fused_render is False
    off = p.parse_args(bf16 + ["--set", "use_fused_render=false"])
    cfg_off = common.resolve_config(off)
    assert common.auto_fused_defaults(cfg_off, off).use_fused_render \
        is False
    fp32 = p.parse_args([])
    assert common.auto_fused_defaults(common.resolve_config(fp32), fp32) \
        .use_fused_render is False


def test_cli_render_restores_exported_tar(tmp_path, capsys):
    """`python -m consistentnerf_tpu_torch.cli.render` (main) restores the
    `.tar` the JAX package exports and writes the PNGs of the weights it
    restored."""
    cfg = _tiny_cfg()
    jmodel = JaxVanillaNeRF(num_samples=S_C, num_importance=S_F,
                            net_depth=DEPTH, net_width=WIDTH,
                            white_bkgd=True)
    ones = jnp.ones((2, 1))
    d = jnp.ones((2, 3)) / jnp.sqrt(3.0)
    params = jmodel.init(jax.random.PRNGKey(7), None, JaxRays(
        origins=jnp.zeros((2, 3)), directions=d, viewdirs=d, radii=ones,
        lossmult=ones, near=ones, far=ones * 4))
    params = jax.tree_util.tree_map(np.asarray, params)
    exp_dir = tmp_path / "exp"
    exp_dir.mkdir()
    export_checkpoint(params, 5, str(exp_dir / "000005.tar"), DEPTH)
    export_checkpoint(params, 3, str(exp_dir / "000003.tar"), DEPTH)
    overrides = ["dataset_type=synthetic", "synthetic_views=3",
                 "synthetic_hw=10", "synthetic_n_test=1",
                 f"netwidth={WIDTH}", f"N_samples={S_C}",
                 f"N_importance={S_F}", "white_bkgd=true",
                 f"basedir={tmp_path}", "expname=exp"]
    argv = ["--device", "cpu", "--render-test"]
    for o in overrides:
        argv += ["--set", o]
    out_dir = render_cli.main(argv)
    assert "restored" in capsys.readouterr().out
    assert out_dir == str(exp_dir / "renderonly_test_000005")
    assert sorted(os.listdir(out_dir)) == ["color_000.png", "depth_000.png"]

    from PIL import Image

    model = VanillaNeRF(num_samples=S_C, num_importance=S_F,
                        net_depth=DEPTH, net_width=WIDTH, white_bkgd=True)
    model.load_state_dict(interop.params_from_jax(params))
    scene = synthetic.make_scene(n_views=3, H=10, W=10).to_scene_data(
        1, True)
    rays = evaluation.camera_rays_for_view(scene, scene.poses[scene.i_test[0]],
                                           device=CPU)
    want = render_lib.render_image(model.eval(), cfg, rays)["rgb"]
    png = np.asarray(Image.open(os.path.join(out_dir, "color_000.png")))
    expected = (np.clip(want, 0, 1) * 255).astype(np.uint8)
    assert np.abs(png.astype(int) - expected.astype(int)).max() <= 1


def test_png_writer_and_depth_vis(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    img = rs.uniform(-0.1, 1.1, (7, 9, 3)).astype(np.float32)
    path = str(tmp_path / "a" / "x.png")
    vis.save_img_u8(img, path)
    expected = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), expected)
    vis.save_img_u8(img[..., 0], str(tmp_path / "gray.png"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(str(tmp_path / "gray.png"))), expected[..., 0])

    depth = rs.uniform(2, 6, (16, 16)).astype(np.float32)
    acc = rs.uniform(0, 1, (16, 16)).astype(np.float32)
    got = vis.visualize_depth(depth, acc)
    want = jvis.visualize_depth(depth, acc)
    assert got.shape == want.shape
    # matplotlib's turbo table and lookup, carried as data: exact.
    np.testing.assert_array_equal(got, want)
