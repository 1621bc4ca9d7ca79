"""The port's depth-prior bootstrap (`train/bootstrap.py`) and prior fusion
(`consistency/reproject.py::fuse_depth_priors`) against the JAX package,
and the whole bootstrap by its own invariants.

The JAX bootstrap's warmup runs the JAX train loop, which can abort a test
worker (ROADMAP Queue 3 note F), so no test here calls the JAX loop or the
JAX `bootstrap_scene_priors` in warmup mode. The pieces are held against
JAX instead: `warmup_config` field by field, `render_warmup_depths` on
carried params at multires 4 / 2 (note D), `fuse_depth_priors` (at
min_consensus 1 and 2) and the hard masks of the fused priors. The whole
flow is held against the JAX package's step functions applied a step at a
time (`tools/bootstrap_seeds.py::jax_flow`, no JAX loop): from the
port's init carried into the JAX package at perturb 0, the warmup's
losses and held-out metrics, its fused priors and masks, and the retrain
on the JAX priors and masks. The port's whole bootstrap, in both modes, is also held by
what it must give: the NDC refusal, `depth_is_gt=False`, binary masks
equal to `compute_hard_masks` of the fused priors, fused priors zero where
the warmup saw nothing, and the exported files.

Tolerances, fp32 on the CPU: fused depths 1e-5 relative where both
packages keep a pixel; a pixel may be kept by one package only, or fused
from other votes, where a rounding decides it (a projected coordinate
within 1e-4 px of a half-integer, or a |depth diff| within 1e-5 relative
of the threshold), at most 0.1% of the train pixels; rendered depth 1e-4,
but at most 0.5% of the pixels within 1e-3, where a fine sample sits on a
bin near the pdf floor (note D: ~1e-7 in the cdf moves such a sample by
~1e-4); the acc > 0.5 cut compared away from 0.5 (1e-4) with the flips at
the edge counted (at most 1% of the pixels). The flow from a carried init
(30 + 30 steps of the sphere's 48x48 end-to-end config): each step's loss
1e-3 relative; held-out depth-MSE 1e-2 relative and PSNR 0.02 dB; fused
priors 1e-2 where both packages keep a pixel, kept by one package only or
masked differently at most 0.5% of the train pixels.
"""

import dataclasses
import io
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.consistency import reproject as jrep
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import synthetic as jsynthetic
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.train import bootstrap as jboot
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.consistency import reproject
from consistentnerf_tpu_torch.core import rays as rays_core
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pfm import read_pfm
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train import bootstrap
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import bootstrap_seeds  # noqa: E402

CPU = torch.device("cpu")
FUSE_RTOL = 1e-5
ROUND_PX = 1e-4
THRESH_REL = 1e-5
MAX_FUSE_FLIP_SHARE = 1e-3
RENDER_TOL = 1e-4
RENDER_FLOOR_TOL = 1e-3
MAX_FLOOR_SHARE = 5e-3
ACC_EDGE = 1e-4
MAX_ACC_FLIP_SHARE = 1e-2
FLOW_STEPS = 30  # warmup and retrain steps of the carried-init flow
FLOW_LOSS_RTOL = 1e-3
FLOW_DEPTH_MSE_RTOL = 1e-2
FLOW_PSNR_ATOL = 0.02  # dB
FLOW_PRIOR_ATOL = 1e-2
FLOW_MAX_FLIP_SHARE = 5e-3
TINY = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=8,
            N_importance=8, multires=4, multires_views=2, white_bkgd=True,
            N_rand=64, n_patches=1, patch_size=8, render_chunk_size=512,
            hardmask=True, with_depth_loss=True, perturb=0.0)


def _noisy_priors(n_views=8, hw=48, seed=0):
    """The sphere scene with simulated warmup error: noise on every prior
    pixel and 5% view-independent gross outliers (tests/test_bootstrap.py's
    corruption)."""
    scene = synthetic.make_scene(n_views=n_views, H=hw, W=hw).to_scene_data()
    gt = scene.depths
    rng = np.random.RandomState(seed)
    noisy = gt + (gt > 0) * rng.normal(0, 0.03, gt.shape)
    outliers = (rng.rand(*gt.shape) < 0.05) & (gt > 0)
    noisy = np.where(outliers, gt + rng.uniform(0.5, 1.5, gt.shape),
                     noisy).astype(np.float32)
    return scene, noisy, outliers


def _fusion_edges(poses, depths, K, i_train, H, W, threshold):
    """bool [N, H, W]: target pixels whose fusion a rounding decides
    against some reference: a projected coordinate (into the reference,
    or the re-lifted point back into the target) within ROUND_PX of a
    half-integer, or a |depth diff| within THRESH_REL of the threshold."""
    P, D, Kt, i_train = reproject._on_device(poses, depths, K, i_train,
                                             "cpu")
    out = np.zeros(D.shape, bool)

    def near_half(q):
        return ((q - torch.floor(q) - 0.5).abs() < ROUND_PX).any(-1)

    for tgt in i_train:
        pts = reproject._target_points(P[tgt], D[tgt], Kt, H, W)
        w2c_t = rays_core.world_to_camera(P[tgt])
        edge = torch.zeros(H * W, dtype=torch.bool)
        for r in i_train:
            if r == tgt:
                continue
            w2c_r = rays_core.world_to_camera(P[r])
            p_cam, q = reproject._project(pts, w2c_r, Kt)
            edge |= near_half(q)
            x, y, z_ref, _ = reproject.world_to_ref_pixels(pts, w2c_r, Kt,
                                                           H, W)
            xi = torch.nan_to_num(x.clamp(0, W - 1)).long()
            yi = torch.nan_to_num(y.clamp(0, H - 1)).long()
            d_ref = D[r][yi, xi]
            edge |= ((z_ref - d_ref).abs() - threshold).abs() < \
                THRESH_REL * threshold
            ro, rd = rays_core.get_rays(H, W, Kt, P[r],
                                                  device="cpu")
            pix = yi * W + xi
            back = ro.reshape(-1, 3)[pix] + d_ref[:, None] * \
                rd.reshape(-1, 3)[pix]
            edge |= near_half(reproject._project(back, w2c_t, Kt)[1])
        out[tgt] = edge.reshape(H, W).numpy()
    return out


@pytest.mark.parametrize("min_consensus", [1, 2])
def test_fuse_depth_priors_matches_jax(min_consensus):
    scene, noisy, _ = _noisy_priors()
    args = (scene.poses, noisy, scene.K, scene.i_train, scene.H, scene.W)
    want = jrep.fuse_depth_priors(*args, threshold=0.1,
                                  min_consensus=min_consensus)
    got = reproject.fuse_depth_priors(*args, threshold=0.1,
                                      min_consensus=min_consensus,
                                      device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    tr = np.asarray(scene.i_train)
    others = [v for v in range(len(noisy)) if v not in tr]
    assert not got[others].any()
    close = np.isclose(got, want, rtol=FUSE_RTOL, atol=0)
    edges = _fusion_edges(*args, 0.1)
    assert not (~close & ~edges).any()
    assert (~close).sum() <= MAX_FUSE_FLIP_SHARE * got[tr].size
    # A plausible share of the priors survives (more at consensus 1).
    kept = (got[tr] > 0).mean() / (noisy[tr] > 0).mean()
    assert (0.5 if min_consensus == 1 else 0.2) < kept < 1.0


def test_hard_masks_of_fused_priors_match_jax():
    scene, noisy, _ = _noisy_priors(n_views=6)
    fused = reproject.fuse_depth_priors(scene.poses, noisy, scene.K,
                                        scene.i_train, scene.H, scene.W,
                                        device="cpu")
    args = (scene.poses, fused, scene.K, scene.i_train, scene.H, scene.W)
    got = reproject.compute_hard_masks(*args, device="cpu")
    want = np.asarray(jrep.compute_hard_masks(*args))
    near = reproject.boundary_pixels(*args, device="cpu")
    diff = got != want
    assert not (diff & ~near).any()
    assert diff.sum() <= 1e-4 * got[scene.i_train].size
    assert 0.05 < got[scene.i_train].mean() < 0.95


def test_fused_priors_beat_raw_warmup_synthetic():
    """Fusion halves the prior depth-MSE of the corrupted depths: noise
    averages down across agreeing views, and outliers no other view
    confirms lose their prior (tests/test_bootstrap.py's twin)."""
    scene, noisy, outliers = _noisy_priors()
    gt = scene.depths
    fused = reproject.fuse_depth_priors(scene.poses, noisy, scene.K,
                                        scene.i_train, scene.H, scene.W,
                                        threshold=0.1, min_consensus=1,
                                        device="cpu")
    tr = np.asarray(scene.i_train)
    m_raw = (noisy[tr] > 0) & (gt[tr] > 0)
    m_fused = (fused[tr] > 0) & (gt[tr] > 0)
    mse_raw = float(np.mean((noisy[tr][m_raw] - gt[tr][m_raw]) ** 2))
    mse_fused = float(np.mean((fused[tr][m_fused] - gt[tr][m_fused]) ** 2))
    assert mse_fused < 0.5 * mse_raw, (mse_fused, mse_raw)
    assert float(np.mean(fused[tr][outliers[tr]] > 0)) < 0.2
    assert float(np.mean(fused[tr][m_raw & ~outliers[tr]] > 0)) > 0.5


def test_warmup_config_matches_jax():
    kw = dict(TINY, softmask=True, softLpmask=True, ss_loss=True,
              use_test_pseudo_label=True, train_render_every=50,
              expname="boot", total_iters=1000)
    want = jboot.warmup_config(JaxConfig(**kw, use_tensorboard=False), 40)
    got = bootstrap.warmup_config(configs.Config(**kw), 40)
    fields = [f.name for f in dataclasses.fields(got)]
    assert got.expname == "boot_warmup" and got.total_iters == 40
    for name in fields:
        if name == "use_tensorboard":
            continue
        assert getattr(got, name) == getattr(want, name), name


def test_render_warmup_depths_matches_jax():
    """The JAX VanillaNeRF's params (numpy, seeded) carried into the port
    model; both render the train views' depths, zeroed where acc <= 0.5."""
    kw = dict(TINY, hardmask=False)
    jcfg = JaxConfig(**kw, use_tensorboard=False)
    pcfg = configs.Config(**kw)
    jscene = jsynthetic.make_scene(n_views=5, H=24, W=24).to_scene_data()
    pscene = synthetic.make_scene(n_views=5, H=24, W=24).to_scene_data()
    jmodel = jax_make_model(jcfg)
    n = 4
    ones = jnp.ones((n, 1))
    dummy = JaxRays(origins=jnp.zeros((n, 3)), directions=jnp.ones((n, 3)),
                    viewdirs=jnp.ones((n, 3)) / np.sqrt(3), radii=ones,
                    lossmult=ones, near=ones * 2, far=ones * 6)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, None, dummy),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)

    def leaf(s):
        a = rng.randn(*s.shape)
        return (a / np.sqrt(s.shape[0]) if len(s.shape) == 2
                else 0.3 * a).astype(np.float32)

    params = jax.tree_util.tree_map(leaf, shapes)
    model = make_model(pcfg, CPU)
    model.load_state_dict(interop.params_from_jax(params))
    model.eval()
    want = jboot.render_warmup_depths(jcfg, jscene, params)
    got = bootstrap.render_warmup_depths(pcfg, pscene, model)
    # The acc > 0.5 cut: compare away from its edge, bound the flips.
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    render = render_lib.build_render_fn(model, pcfg)
    tr = np.asarray(pscene.i_train)
    acc = np.zeros(got.shape, np.float32)
    for v in tr:
        acc[v] = render(camera_rays_for_view(pscene, pscene.poses[v],
                                             device=CPU))["acc"].numpy()
    edge = np.abs(acc - 0.5) < ACC_EDGE
    both = (got > 0) & (want > 0)
    err = np.abs(got[both] - want[both])
    assert err.max() < RENDER_FLOOR_TOL
    assert (err > RENDER_TOL).sum() <= MAX_FLOOR_SHARE * err.size
    flips = (got > 0) != (want > 0)
    assert not (flips & ~edge).any()
    assert flips.sum() <= MAX_ACC_FLIP_SHARE * got[tr].size
    assert 0.05 < (got[tr] > 0).mean() < 0.95, "the acc cut is trivial"
    others = [v for v in range(len(got)) if v not in tr]
    assert not got[others].any()


# --- the port's whole bootstrap, by its invariants -------------------------


def _boot_cfg(tmp_path, **kw):
    return configs.Config(**dict(
        TINY, basedir=str(tmp_path), expname="boot", i_print=1000,
        checkpoint_every=100000, lrate=5e-3, mvs_num_depths=8,
        mvs_base_ch=4, mvs_conf_thresh=0.0, **kw))


@pytest.mark.parametrize("mode", ["warmup", "mvs"])
def test_bootstrap_scene_priors_end_to_end(tmp_path, mode, monkeypatch):
    from PIL import Image

    scene = synthetic.make_scene(n_views=6, H=24, W=24).to_scene_data()
    scene.ensure_priors()
    cfg = _boot_cfg(tmp_path, bootstrap_mode=mode)
    raw = {}
    real_render = bootstrap.render_warmup_depths

    def spy(*a, **k):
        raw["depths"] = real_render(*a, **k)
        raw["model"] = a[2]
        return raw["depths"]

    monkeypatch.setattr(bootstrap, "render_warmup_depths", spy)
    export = str(tmp_path / "priors")
    logs = []
    boot, result = bootstrap.bootstrap_scene_priors(
        cfg, scene, 12, log_fn=logs.append, export_dir=export, device="cpu")
    tr = np.asarray(scene.i_train)
    others = [v for v in range(len(scene.images)) if v not in tr]
    assert boot.depth_is_gt is False and scene.depth_is_gt is True
    assert boot.masks.dtype == np.float32
    assert set(np.unique(boot.masks)) <= {0.0, 1.0}
    assert float(boot.depths[tr].max()) > 0
    assert not boot.depths[others].any() and not boot.masks[others].any()
    # The masks are the hard masks of the (fused) priors.
    np.testing.assert_array_equal(
        boot.masks, reproject.compute_hard_masks(
            scene.poses, boot.depths, scene.K, tr, scene.H, scene.W,
            occlusion_threshold=cfg.occlusion_threshold,
            device="cpu").astype(np.float32))
    if mode == "warmup":
        assert type(result).__name__ == "TrainResult"
        assert result.state.step == 12
        assert os.path.isdir(tmp_path / "boot_warmup" / "checkpoints")
        # Fused priors are zero where the warmup saw nothing.
        assert not boot.depths[raw["depths"] == 0].any()
        assert any("warmup training 12 steps" in s for s in logs)
    else:
        assert type(result).__name__ == "MVSTrainResult"
        assert result.steps == 12 and np.isfinite(result.final_loss)
        assert "depths" not in raw
        assert any("GT-supervised" in s for s in logs)
    for v in tr:
        depth, _ = read_pfm(os.path.join(export, f"depth_{v:04d}.pfm"))
        np.testing.assert_array_equal(np.asarray(depth, np.float32),
                                      boot.depths[v])
        with open(os.path.join(export, f"{v}_mask_boot.jpg"), "rb") as f:
            img = np.asarray(Image.open(io.BytesIO(f.read())))
        assert img.shape == (scene.H, scene.W)
        np.testing.assert_array_equal(img >= 128, boot.masks[v] > 0)
    assert len(os.listdir(export)) == 2 * len(tr)


def test_bootstrap_refuses_ndc_and_unknown_modes(tmp_path):
    scene = synthetic.make_scene(n_views=4, H=16, W=16).to_scene_data()
    with pytest.raises(ValueError, match="NDC"):
        bootstrap.bootstrap_scene_priors(
            _boot_cfg(tmp_path), dataclasses.replace(scene, use_ndc=True), 1,
            device="cpu")
    with pytest.raises(ValueError, match="bootstrap_mode"):
        bootstrap.bootstrap_scene_priors(
            _boot_cfg(tmp_path, bootstrap_mode="notebook"), scene, 1,
            device="cpu")


def test_bootstrap_flow_tracks_jax_from_a_carried_init():
    """The warmup bootstrap as a whole, deterministic: from the port's
    seeded init carried into the JAX package at perturb 0 and the same
    seeded batches, the port's warmup follows the JAX package's steps
    loss by loss and scores the same held-out depth-MSE and PSNR; its
    rendered, fused priors and hard masks are the JAX package's up to
    pixels that a rounding decides; and the consistent retrain (hard
    masks, depth loss on produced priors, so depth_is_gt False) on the
    JAX priors and masks follows the JAX retrain the same way. A fault in
    the masks or the depth loss of the retrain moves its losses from the
    first step."""
    cfg = dict(bootstrap_seeds.CFG, perturb=0.0)
    want = bootstrap_seeds.jax_flow(FLOW_STEPS, cfg,
                                    init=bootstrap_seeds.port_init(cfg))
    got = bootstrap_seeds.port_flow(
        FLOW_STEPS, None, cfg, retrain_on=(want["priors"], want["masks"]))
    for stage in ("warmup", "retrain"):
        np.testing.assert_allclose(got[stage + "_losses"],
                                   want[stage + "_losses"],
                                   rtol=FLOW_LOSS_RTOL, err_msg=stage)
        (d_got, p_got), (d_want, p_want) = got[stage], want[stage]
        assert abs(d_got / d_want - 1) < FLOW_DEPTH_MSE_RTOL, (
            stage, d_got, d_want)
        assert abs(p_got - p_want) < FLOW_PSNR_ATOL, (stage, p_got, p_want)
    tr = got["i_train"]
    prior_got, prior_want = got["priors"][tr], want["priors"][tr]
    both = (prior_got > 0) & (prior_want > 0)
    assert both.mean() > 0.02, both.mean()
    # A pixel kept by one package only, or fused from other votes.
    flips = ((prior_got > 0) != (prior_want > 0)) | (
        both & (np.abs(prior_got - prior_want) > FLOW_PRIOR_ATOL))
    assert flips.mean() <= FLOW_MAX_FLIP_SHARE, flips.mean()
    assert (got["masks"][tr] != want["masks"][tr]).mean() \
        <= FLOW_MAX_FLIP_SHARE
    assert want["masks"][tr].mean() > 0.01
