"""PyTorch port vs the JAX package: config, scene data, rays, encoding,
sampling and compositing. Same numpy inputs through both, fp32, atol 1e-5
unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.configs import parse_overrides as jax_overrides
from consistentnerf_tpu.core import encoding as jenc
from consistentnerf_tpu.core import rays as jrays
from consistentnerf_tpu.core import rendering as jrender
from consistentnerf_tpu.core import sampling as jsamp
from consistentnerf_tpu.data import poses as jposes
from consistentnerf_tpu.data import synthetic as jsyn
from consistentnerf_tpu.train import evaluation as jeval
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.core import encoding, rays, rendering, sampling
from consistentnerf_tpu_torch.data import loaders, poses, synthetic
from consistentnerf_tpu_torch.train import evaluation
from torch_port_shared import _one_torch_thread  # noqa: F401

ATOL = 1e-5
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, atol=ATOL, rtol=0.0, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


# --- configs ---------------------------------------------------------------


def test_config_defaults_match_jax():
    port = configs.Config()
    ref = JaxConfig()
    for name in port.__dataclass_fields__:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("value, expected", [
    ("False", False), ("false", False), ("TRUE", True), ("true", True),
])
def test_override_boolean_coercion(value, expected):
    cfg = configs.parse_overrides(configs.Config(),
                                  [f"white_bkgd={value}"])
    assert cfg.white_bkgd is expected
    assert jax_overrides(JaxConfig(), [f"white_bkgd={value}"]).white_bkgd \
        is expected


def test_overrides_and_json_config(tmp_path):
    cfg = configs.parse_overrides(
        configs.Config(), ["N_samples=32", "compute_dtype=bfloat16",
                           "basedir=/x/y"])
    assert (cfg.N_samples, cfg.compute_dtype, cfg.basedir) == (
        32, "bfloat16", "/x/y")
    with pytest.raises(KeyError):
        configs.parse_overrides(configs.Config(), ["bogus=1"])
    path = tmp_path / "c.json"
    path.write_text('{"netwidth": 64, "white_bkgd": true}')
    cfg = configs.load_config(str(path), ["netdepth=4"])
    assert (cfg.netwidth, cfg.white_bkgd, cfg.netdepth) == (64, True, 4)
    path.write_text('{"not_a_field": 1}')
    with pytest.raises(KeyError):
        configs.load_config(str(path))


# --- scene data ------------------------------------------------------------


def test_pose_spherical_matches_jax():
    for theta, phi, r in [(0.0, -30.0, 4.0), (123.0, 10.0, 2.5)]:
        np.testing.assert_array_equal(poses.pose_spherical(theta, phi, r),
                                      jposes.pose_spherical(theta, phi, r))
    np.testing.assert_array_equal(poses.spherical_render_poses(7),
                                  jposes.spherical_render_poses(7))


@pytest.mark.parametrize("layout, interleave", [("sphere", True),
                                                ("cluster", False)])
def test_synthetic_scene_matches_jax(layout, interleave):
    kw = dict(n_views=5, H=12, W=12, texture_freq=2.0, layout=layout)
    port = synthetic.make_scene(**kw).to_scene_data(2, interleave)
    ref = jsyn.make_scene(**kw).to_scene_data(2, interleave)
    for name in ("images", "poses", "K", "i_train", "i_test", "i_val",
                 "depths", "masks", "mono_disp"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    for name in ("H", "W", "focal", "near", "far", "depth_is_gt"):
        assert getattr(port, name) == getattr(ref, name), name


def test_load_scene_synthetic_only():
    cfg = configs.Config(dataset_type="synthetic", synthetic_views=4,
                         synthetic_hw=8, synthetic_n_test=1)
    scene = loaders.load_scene(cfg)
    assert scene.images.shape == (4, 8, 8, 3)
    assert len(scene.i_test) == 1 and scene.masks.shape == (4, 8, 8)
    # The dataset loaders are ported: a dataset type reads its files, and
    # an unknown type raises as in the JAX package.
    with pytest.raises(FileNotFoundError):
        loaders.load_scene(cfg.replace(dataset_type="llff",
                                       datadir="/nonexistent/fern"))
    with pytest.raises(ValueError, match="Unknown dataset type"):
        loaders.load_scene(cfg.replace(dataset_type="bogus"))


def test_load_scene_is_its_read_then_its_attach(tmp_path):
    """load_scene = attach_priors(read_scene(cfg)), and read_scene calls
    the reader scene_reader names with its arguments: every dataset
    type's arguments bind to its reader's signature."""
    import inspect

    cfg = configs.Config(dataset_type="synthetic", synthetic_views=4,
                         synthetic_hw=8, synthetic_n_test=1, hardmask=True,
                         basedir=str(tmp_path))
    want = loaders.load_scene(cfg, device="cpu")
    got = loaders.attach_priors(loaders.read_scene(cfg), cfg, device="cpu")
    for name in ("images", "depths", "masks", "poses"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert want.masks.min() == 0  # the hard masks were attached
    fn, kwargs = loaders.scene_reader(cfg)
    np.testing.assert_array_equal(fn(**kwargs).images, want.images)
    for kind in ("blender", "llff", "dtu", "deepvoxels", "LINEMOD"):
        fn, kwargs = loaders.scene_reader(cfg.replace(dataset_type=kind))
        inspect.signature(fn).bind(**kwargs)


# --- rays ------------------------------------------------------------------


@pytest.mark.parametrize("use_ndc", [False, True])
def test_camera_rays_match_jax(use_ndc):
    scene = jsyn.make_scene(n_views=3, H=10, W=14).to_scene_data()
    K, c2w = scene.K, scene.poses[1]
    if use_ndc:
        # A forward-facing camera looking down -z, as NDC assumes.
        c2w = np.concatenate([np.eye(3), [[0.1], [-0.2], [0.3]]], 1)
    port = rays.camera_rays(10, 14, K, c2w, 2.0, 6.0, use_ndc=use_ndc,
                            device=CPU)
    ref = jrays.camera_rays(10, 14, K, c2w, 2.0, 6.0, use_ndc=use_ndc)
    for name in ("origins", "directions", "viewdirs", "radii", "lossmult",
                 "near", "far"):
        got = getattr(port, name)
        assert got.shape == getattr(ref, name).shape, name
        _close(got, getattr(ref, name), atol=ATOL, rtol=ATOL, msg=name)


def test_camera_rays_for_view_matches_jax():
    scene = jsyn.make_scene(n_views=3, H=12, W=12).to_scene_data()
    for factor in (0, 2):
        port = evaluation.camera_rays_for_view(scene, scene.poses[0],
                                               factor, device=CPU)
        ref = jeval.camera_rays_for_view(scene, scene.poses[0], factor)
        _close(port.origins, ref.origins)
        _close(port.directions, ref.directions)


# --- encoding, sampling, compositing ---------------------------------------


@pytest.mark.parametrize("num_freqs", [10, 4, 0])
def test_posenc_nerf_matches_jax(num_freqs):
    # Points out to |x| ~ 4 reach 2^9 * 4 >> 100*pi, the range-reduced
    # branch of safe_sin/safe_cos.
    x = np.random.RandomState(0).randn(257, 3).astype(np.float32) * 2.0
    got = encoding.posenc_nerf(_t(x), num_freqs)
    want = jenc.posenc_nerf(jnp.asarray(x), num_freqs)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("jitter", [False, True])
def test_vanilla_z_vals_matches_jax(lindisp, jitter):
    rs = np.random.RandomState(1)
    near = rs.uniform(1, 2, (33, 1)).astype(np.float32)
    far = near + rs.uniform(2, 4, (33, 1)).astype(np.float32)
    t_rand = rs.uniform(size=(33, 16)).astype(np.float32) if jitter else None
    got = sampling.vanilla_z_vals(_t(near), _t(far), 16, lindisp,
                                  None if t_rand is None else _t(t_rand))
    want = jsamp.vanilla_z_vals(jnp.asarray(near), jnp.asarray(far), 16,
                                lindisp, t_rand)
    _close(got, want)


def _pdf_inputs(seed=2, n=41, m=15):
    rs = np.random.RandomState(seed)
    bins = np.sort(rs.uniform(2, 6, (n, m)), -1).astype(np.float32)
    weights = rs.exponential(size=(n, m - 1)).astype(np.float32)
    weights[::5] = 0.0  # degenerate rows: the +1e-5 floor decides
    return bins, weights


def test_sample_pdf_det_matches_jax():
    bins, weights = _pdf_inputs()
    got = sampling.sample_pdf(_t(bins), _t(weights), 24, det=True)
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24,
                            det=True)
    _close(got, want)


def test_sample_pdf_explicit_u_matches_jax():
    bins, weights = _pdf_inputs(seed=3)
    u = np.random.RandomState(4).uniform(size=(41, 24)).astype(np.float32)
    got = sampling.sample_pdf(_t(bins), _t(weights), 24, u=_t(u),
                              det=False)
    want = jsamp.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 24,
                            u=jnp.asarray(u))
    _close(got, want)
    with pytest.raises(ValueError):
        sampling.sample_pdf(_t(bins), _t(weights), 24, det=False)


def _raw_inputs(seed=5, n=37, s=19):
    rs = np.random.RandomState(seed)
    raw = (rs.randn(n, s, 4) * 2).astype(np.float32)
    z = np.sort(rs.uniform(2, 6, (n, s)), -1).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    return raw, z, d


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_matches_jax(white_bkgd):
    raw, z, d = _raw_inputs()
    got = rendering.raw2outputs(_t(raw), _t(z), _t(d), None, white_bkgd)
    want = jrender.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                               jnp.asarray(d), None, white_bkgd)
    for g, w, name in zip(got, want, ["rgb", "disp", "acc", "weights",
                                      "depth"]):
        assert g.shape == w.shape, name
        _close(g, w, atol=ATOL, rtol=ATOL, msg=name)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_T_matches_jax(white_bkgd):
    raw, z, d = _raw_inputs(seed=6)
    raw_T = np.ascontiguousarray(raw.transpose(2, 0, 1))
    got = rendering.raw2outputs_T(_t(raw_T), _t(z), _t(d), None, white_bkgd)
    want = jrender.raw2outputs_T(jnp.asarray(raw_T), jnp.asarray(z),
                                 jnp.asarray(d), None, white_bkgd)
    for g, w, name in zip(got, want, ["rgb", "disp", "acc", "weights",
                                      "depth"]):
        assert g.shape == w.shape, name
        _close(g, w, atol=ATOL, rtol=ATOL, msg=name)
