"""The port's consistency variants vs the JAX package: the edge masks and
the softmask PNGs of `attach_masks`, `img2mse_softmask`, the online
reprojection loss (`consistency/online.py`), the batcher's ss_loss
fields, and the ss_loss branch of every vanilla step.

The edge masks equal cv2's bit for bit (the JAX package calls cv2; the
port computes cv2's arithmetic in numpy), as does the uint8 blurred image
they read. The steps run at the small config of the port's other step
tests (depth 2, width 32, 16 + 8 samples, multires 4 / 2, 192 + 64 rays,
hard mask, depth loss, perturb 0: ROADMAP Queue 3 note D) against the JAX
XLA step with ss_loss, once for each value of the gate: the JAX step
draws it from its own key (`split(fold_in(fold_in(key, step), 1))[1]`),
so the test picks keys that give each value and hands that value to the
port as its draw.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.consistency import masks as jmasks
from consistentnerf_tpu.consistency import online as jonline
from consistentnerf_tpu.data import loaders as jloaders
from consistentnerf_tpu.data import pipeline as jpipe
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.consistency import masks, online
from consistentnerf_tpu_torch.data import images, loaders, pipeline
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

cv2 = pytest.importorskip("cv2")

CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=192,
           n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
           hardmask=True, with_depth_loss=True, perturb=0.0, ss_loss=True,
           use_fused_train=True, use_onepass_train=True)
# The bounds of the port's step tests (the JAX package's own for its
# fused steps against its XLA step).
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(atol=2e-4, rtol=5e-3)
STATS = ("loss", "ss_loss", "img_loss", "depth_loss", "img_loss0",
         "depth_loss0", "mono_depth_loss", "patch_ssim", "psnr")
# The port's steps with ss_loss: the config each one needs.
STEPS = {"eager": dict(use_fused_train=False),
         "onepass": {},
         "v2": dict(use_onepass_train=False, fused_kernel="v2"),
         "v2row": dict(use_onepass_train=False, fused_kernel="v2row"),
         "v1": dict(use_onepass_train=False, fused_kernel="v1")}


# --- edge masks and softmask ------------------------------------------------


def _textured(h, w, n=3, seed=0):
    """Seeded smooth colour textures with pixel noise, float32 [n, h, w, 3]
    in [0, 1]."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    out = []
    for _ in range(n):
        f = rs.uniform(0.05, 0.4, (3, 2))
        ph = rs.uniform(0, 6.3, 3)
        img = np.stack([0.5 + 0.35 * np.sin(f[c, 0] * xx + ph[c])
                        * np.cos(f[c, 1] * yy) for c in range(3)], -1)
        img = img + rs.normal(0, 0.04, img.shape)
        out.append(np.clip(img, 0, 1))
    return np.stack(out).astype(np.float32)


def _edge_inputs(kind):
    if kind == "synthetic":
        scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
        return np.asarray(scene.images, np.float32), scene.i_train
    h, w = {"textured_64x80": (64, 80), "textured_61x77": (61, 77)}[kind]
    return _textured(h, w), np.array([0, 2])


@pytest.mark.parametrize("kind", ["synthetic", "textured_64x80",
                                  "textured_61x77"])
def test_edge_masks_equal_cv2_bit_for_bit(kind):
    """canny_masks / sobel_masks equal the JAX package's (cv2), and the
    gray, blurred and uint8 images they read equal cv2's, bit for bit.
    61x77 leaves 5 pixels after a row's 8-pixel groups (cv2's gray sums
    two of them in another order)."""
    imgs, i_train = _edge_inputs(kind)
    for i in i_train:
        gray = cv2.cvtColor(imgs[i], cv2.COLOR_BGR2GRAY)
        blur = cv2.GaussianBlur(gray, (3, 3), 0)
        np.testing.assert_array_equal(masks._gray(imgs[i]), gray)
        np.testing.assert_array_equal(masks._blur3(gray), blur)
        np.testing.assert_array_equal(masks.blurred_uint8(imgs[i]),
                                      (blur * 255).astype(np.uint8))
    for fn in ("canny_masks", "sobel_masks"):
        got = getattr(masks, fn)(imgs, i_train)
        want = getattr(jmasks, fn)(imgs, i_train)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want, err_msg=fn)
        assert got[i_train].any()
        assert not np.delete(got, i_train, 0).any()


def test_canny_thresholds_and_hysteresis_equal_cv2():
    """Other thresholds (and their swap) on noise and on a ramp: the
    non-maximum suppression's sectors and the hysteresis."""
    rs = np.random.RandomState(3)
    noise = (rs.rand(37, 53) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:37, :53]
    ramp = (127 + 100 * np.sin(xx / 4.0) * np.cos(yy / 6.0)).astype(np.uint8)
    for img in (noise, ramp):
        for lo, hi in ((1, 200), (50, 100), (100, 50), (10, 11)):
            np.testing.assert_array_equal(masks._canny(img, lo, hi),
                                          cv2.Canny(img, lo, hi) > 0)
        np.testing.assert_array_equal(
            masks._sobel11(img), cv2.Sobel(img, cv2.CV_64F, 1, 1, ksize=5))


def test_softmask_pngs_load_as_in_jax(tmp_path, monkeypatch):
    """Softmask PNGs written in the JAX layout under the working directory
    (grey PNGs, one train view without a file): both packages attach the
    same masks, nonzero pixels of the train views with a file, zeros
    elsewhere; softmask wins over hardmask, as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    kw = dict(dataset_type="synthetic", synthetic_hw=24, synthetic_views=6,
              softmask=True, hardmask=True, softmask_K=30,
              datadir="data/nerf_synthetic/lego", basedir=str(tmp_path))
    scene = synthetic.make_scene(n_views=6, H=24, W=24).to_scene_data(
        n_test=2, interleave_test=True)  # load_scene's split
    d = tmp_path / "Softmask" / "synthetic" / "lego" / "iter_500"
    d.mkdir(parents=True)
    rs = np.random.RandomState(1)
    with_png = list(scene.i_train[:-1])
    for i in with_png:
        png = (rs.rand(24, 24) > 0.6) * rs.randint(1, 256, (24, 24))
        images.write_png(str(d / f"softmask_{i:04d}_30per.png"),
                         png.astype(np.uint8), filter_type=int(i) % 5)
    want = jloaders.load_scene(JaxConfig(expname="jax", **kw))
    got = loaders.load_scene(configs.Config(expname="port", **kw),
                             device="cpu")
    np.testing.assert_array_equal(got.masks, want.masks)
    assert all(got.masks[i].any() for i in with_png)
    assert not got.masks[scene.i_train[-1]].any()
    assert not got.masks[scene.i_test].any()


def test_img2mse_softmask_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(50, 3).astype(np.float32)
    y = rs.rand(50, 3).astype(np.float32)
    for temp in (1.0, 0.3):
        want, want_g = jax.value_and_grad(jmasks.img2mse_softmask)(
            jnp.asarray(x), jnp.asarray(y), temp)
        xt = torch.from_numpy(x).requires_grad_()
        got = masks.img2mse_softmask(xt, torch.from_numpy(y), temp)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)


# --- the online reprojection ------------------------------------------------


@pytest.fixture(scope="module")
def scenes(request):
    return once_per_run(request, _scenes)


def _scenes():
    kw = dict(n_views=6, H=48, W=48)
    return (synthetic.make_scene(**kw).to_scene_data(),
            jsynth.make_scene(**kw).to_scene_data())


def _ref_points(scene, ref_i, rs):
    """World points that project into view ref_i at chosen pixels: the
    border rows and columns, the interior, outside, and behind the
    camera; at the prior's depth (with noise, so the occlusion test
    splits them) or far from it."""
    H, W = scene.H, scene.W
    K, c2w = np.asarray(scene.K, np.float64), np.asarray(
        scene.poses[ref_i], np.float64)
    px = np.concatenate([np.full(12, W - 1), np.zeros(12),
                         rs.randint(0, W, 12), rs.randint(0, W, 40),
                         rs.uniform(-20, W + 20, 20)])
    py = np.concatenate([rs.randint(0, H, 12), rs.randint(0, H, 12),
                         np.full(12, H - 1), rs.randint(0, H, 40),
                         rs.uniform(-20, H + 20, 20)])
    xi = np.clip(np.round(px), 0, W - 1).astype(int)
    yi = np.clip(np.round(py), 0, H - 1).astype(int)
    prior = scene.depths[ref_i][yi, xi]  # 0 where the ray misses
    depth = np.where(prior > 0, prior, rs.uniform(2, 6, px.size)) * (
        1 + rs.normal(0, 0.02, px.size))
    depth[-10:] = -depth[-10:]  # behind the camera
    dirs = np.stack([(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1],
                     -np.ones_like(px)], -1)
    pts = c2w[:3, 3] + depth[:, None] * (dirs @ c2w[:3, :3].T)
    return pts.astype(np.float32)


@pytest.mark.parametrize("threshold", [0.1, 0.01])
def test_build_ref_rays_matches_jax(scenes, threshold):
    """Weights and the gathered targets exactly (the same pixel indices,
    the border row and column included), rays at 1e-6, against the
    jitted JAX function (its quotients by constants are fp32
    reciprocals); and an empty in-bounds set: zero weight."""
    scene, _ = scenes
    rs = np.random.RandomState(0)
    jfn = jax.jit(jonline.build_ref_rays, static_argnums=(5, 6))
    for ref_i in scene.i_train:
        pts = _ref_points(scene, ref_i, rs)
        args = (pts, scene.poses[ref_i][:3, :4].astype(np.float32),
                scene.images[ref_i].astype(np.float32),
                scene.depths[ref_i].astype(np.float32),
                np.asarray(scene.K, np.float32))
        for use_occ in (True, False):
            want = jfn(*map(jnp.asarray, args), threshold, use_occ)
            got = online.build_ref_rays(*map(torch.from_numpy, args),
                                        threshold, use_occ)
            for k in ("weight", "rgb_target", "depth_target"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), err_msg=k)
            for k in ("origins", "directions"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=1e-6,
                                           rtol=1e-6, err_msg=k)
            w = got["weight"].numpy()
            assert 0 < w.sum() < w.size
        assert w[:12].any() and w[24:36].any()  # the last column and row
    args = [torch.from_numpy(a) for a in args]
    args[0] = torch.full_like(args[0], float("nan"))  # nothing in bounds
    empty = online.build_ref_rays(*args)
    assert not empty["weight"].any()
    assert torch.equal(empty["depth_target"],
                       args[3][0, 0].expand(len(pts)))  # pixel 0 read


def _jax_cfg(**kw):
    return JaxConfig(use_tensorboard=False, fused_tile=64, **{**CFG, **kw})


@pytest.fixture(scope="module")
def jax_run(request):
    """The ss_loss batch, initial params, the online loss of the JAX model,
    and the JAX XLA step's result for each gate value."""
    return once_per_run(request, _jax_run)


def _jax_run():
    jcfg = _jax_cfg()
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = jpipe.VanillaBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    # Jitted, as the JAX step runs it (its quotients by constants are
    # then fp32 reciprocals, as in the port).
    ss = jax.jit(lambda p, b: jonline.online_reprojection_loss(
        model, p, None, b, jcfg)[0])(
            state.params, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jstep.build_vanilla_train_step(model, jcfg, donate=False)
    out = {"params": jax.device_get(state.params), "ss": float(ss)}
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        _, gate_key = jax.random.split(jax.random.fold_in(
            jax.random.fold_in(key, 0), 1))
        gate = bool(jax.random.bernoulli(gate_key))
        if gate in out:
            continue
        out.setdefault("keys", {})[gate] = key
        s, st = step(state, batch, key)
        out[gate] = (interop.params_from_jax(jax.device_get(s.params)),
                     {k: float(np.asarray(v)) for k, v in st.items()})
        if True in out and False in out:
            break
    # A third of the rays with a zero depth prior, and the reference
    # camera at the batch's own camera: those points sit at its centre.
    odd = _degenerate(batch)
    key = out["keys"][True]
    s, st = step(state, odd, key)
    out["degenerate"] = (interop.params_from_jax(jax.device_get(s.params)),
                         {k: float(np.asarray(v)) for k, v in st.items()})
    return batch, out


def _degenerate(batch):
    odd = dict(batch)
    odd["depth"] = np.where(np.arange(len(batch["depth"])) % 3 == 0, 0.0,
                            batch["depth"]).astype(np.float32)
    pose = batch["ref_pose"].copy()
    pose[:, 3] = batch["origins"][0]
    odd["ref_pose"] = pose
    return odd


def test_points_at_the_reference_camera_stay_finite(jax_run):
    """Points at the reference camera's centre (a zero depth prior, the
    reference view the batch's own) project to no pixel: zero weight, a
    finite ray, and the step's loss and update those of the JAX step
    (where its projection leaves a rounding residual and stays finite)."""
    batch, out = jax_run
    odd = to_device(_degenerate(batch), "cpu")
    cfg = configs.Config(**CFG)
    ref = online.batch_ref_rays(odd, cfg)
    assert not ref["weight"][::3].any()
    assert torch.isfinite(ref["directions"]).all()
    want_sd, want_stats = out["degenerate"]
    assert np.isfinite(want_stats["loss"])
    for kind in ("eager", "onepass"):
        cfg = configs.Config(**{**CFG, **STEPS[kind]})
        state = _port_state(out["params"], cfg)
        state, stats = loop.select_train_step(cfg, state.model)(
            state, odd, {"ss": {"gate": torch.tensor(True)}})
        for k in STATS:
            np.testing.assert_allclose(float(stats[k]), want_stats[k],
                                       err_msg=f"{kind} {k}", **LOSS_TOL)
        sd = state.model.state_dict()
        for k in sd:
            np.testing.assert_allclose(
                sd[k].numpy(), want_sd[k].numpy().reshape(sd[k].shape),
                err_msg=f"{kind} {k}", **PARAM_TOL)


def _port_state(params, cfg):
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.params_from_jax(params))
    return state


def test_online_reprojection_loss_matches_jax(jax_run):
    batch, out = jax_run
    cfg = configs.Config(**CFG)
    model = _port_state(out["params"], cfg).model
    got, aux = online.online_reprojection_loss(
        lambda rays, d: model(rays), to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(float(got.detach()), out["ss"], rtol=1e-5,
                               atol=1e-5)
    assert 0 < float(aux["consistency_weight"].sum()) < batch["rgb"].shape[0]


def test_batcher_ss_loss_batches_match_jax(scenes):
    """Same seed, same batches over 20 steps: the reference view drawn
    after every other draw, and the rest of the sequence unchanged."""
    scene, jscene = scenes
    base = dict(N_rand=200, n_patches=2, patch_size=8, seed=7,
                use_test_pseudo_label=True)
    b = pipeline.VanillaBatcher(scene, configs.Config(ss_loss=True, **base))
    jb = jpipe.VanillaBatcher(jscene, JaxConfig(ss_loss=True, **base))
    plain = pipeline.VanillaBatcher(scene, configs.Config(**base))
    for _ in range(20):
        got, want = b.next_batch(), jb.next_batch()
        assert set(got) == set(want)
        for k in ("ref_image", "ref_depth", "ref_pose", "K", "rgb", "depth",
                  "mask", "mono_disp", "loss_scale"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
            assert got[k].dtype == np.asarray(want[k]).dtype, k
        for k in ("origins", "directions", "viewdirs"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
        # The ss_loss draw comes last: the batch is the one drawn without
        # ss_loss, once that draw is made beside it.
        ref = plain.next_batch()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        plain.rng.choice(scene.i_train)
    assert b.rng.randint(1 << 30) == jb.rng.randint(1 << 30)


# --- the steps --------------------------------------------------------------


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("kind", sorted(STEPS))
def test_ss_loss_step_matches_jax_xla_step(jax_run, kind, gate,
                                           monkeypatch):
    """Each vanilla step the dispatch picks with ss_loss, one step from
    the JAX params and batch, against the JAX XLA step that drew the same
    gate: loss, ss_loss, stats, grad norm and updated params. The one-pass
    step launches the level kernel four times (main and reference rays,
    both levels)."""
    batch, out = jax_run
    cfg = configs.Config(**{**CFG, **STEPS[kind]})
    state = _port_state(out["params"], cfg)
    train_step = loop.select_train_step(cfg, state.model)
    levels = []
    real = op.onepass_level
    monkeypatch.setattr(op, "onepass_level",
                        lambda *a, **k: levels.append(a[3].shape)
                        or real(*a, **k))
    draws = {"ss": {"gate": torch.tensor(gate)}}
    state, stats = train_step(state, to_device(batch, "cpu"), draws)
    want_sd, want_stats = out[gate]
    for k in STATS:
        np.testing.assert_allclose(float(stats[k]), want_stats[k],
                                   err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               want_stats["grad_norm"], rtol=1e-3)
    sd = state.model.state_dict()
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(),
                                   want_sd[k].numpy().reshape(sd[k].shape),
                                   err_msg=k, **PARAM_TOL)
    n, p = batch["rgb"].shape[0], cfg.n_patches * cfg.patch_size**2
    want_levels = ([(n - p, 16), (n - p, 24), (n, 16), (n, 24)]
                   if kind == "onepass" else [])
    assert levels == want_levels


@pytest.mark.parametrize("kw", [{}, dict(use_pdf_kernel=True)])
def test_perturbed_ss_loss_onepass_matches_eager(jax_run, kw):
    """perturb=1: with the same draws (the reference rays' t_rand / u
    among them) the kernel step and the eager step compute the same
    update, for both gate values; a repeat is bit-identical; and the
    draws without ss_loss are those with it, less `ss`."""
    batch, out = jax_run
    cfg = configs.Config(**{**CFG, "perturb": 1.0, **kw})
    b = to_device(batch, "cpu")
    n = b["rgb"].shape[0]
    draws = step_lib.make_draws(cfg, n, torch.Generator().manual_seed(3),
                                "cpu")
    plain = step_lib.make_draws(cfg.replace(ss_loss=False), n,
                                torch.Generator().manual_seed(3), "cpu")
    assert set(draws) - set(plain) == {"ss"}
    for k in plain:
        assert torch.equal(draws[k], plain[k])
    assert set(draws["ss"]) == {"gate", "t_rand", "u"}
    assert draws["ss"]["u"].shape == draws["u"].shape == (n, 8)
    base = _port_state(out["params"], cfg)
    one = op.build_onepass_vanilla_train_step(cfg)
    eager = step_lib.build_vanilla_train_step(base.model, cfg)
    for gate in (True, False):
        d = dict(draws, ss=dict(draws["ss"], gate=torch.tensor(gate)))
        s1, st1 = one(copy.deepcopy(base), b, d)
        s2, st2 = eager(copy.deepcopy(base), b, d)
        s3, st3 = one(copy.deepcopy(base), b, d)
        for k in STATS:
            np.testing.assert_allclose(float(st1[k]), float(st2[k]),
                                       err_msg=k, **LOSS_TOL)
        assert float(st1["loss"]) == float(st3["loss"])
        for (k, a), c, e in zip(s1.model.named_parameters(),
                                s2.model.parameters(),
                                s3.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(),
                                       c.detach().numpy(), err_msg=k,
                                       **PARAM_TOL)
            assert torch.equal(a, e)


def test_train_cli_scene_preset_with_ss_loss(tmp_path, capsys):
    """The train CLI from a scene preset (`--scene synthetic_pol`, cut to
    a tiny size by --set) with ss_loss on the one-pass step: the preset's
    recipe, the overrides, a finite ss_loss, and the housekeeping the
    preset turns on run (TensorBoard's scalars; no line of skipped
    fields)."""
    sets = ["synthetic_hw=24", "synthetic_views=4", "synthetic_n_test=1",
            "netdepth=2", "netwidth=32", "N_samples=8", "N_importance=8",
            "multires=4", "multires_views=2", "N_rand=64", "n_patches=1",
            "patch_size=8", "compute_dtype=float32", "use_fused_train=true",
            "use_onepass_train=true", "ss_loss=true", "i_print=2",
            f"basedir={tmp_path}"]
    args = ["--device", "cpu", "--scene", "synthetic_pol",
            "--num-steps", "2"] + [x for s in sets for x in ("--set", s)]
    res = train_cli.main(args)
    assert res.state.step == 2
    last = res.stats_history[-1]
    assert np.isfinite(last["ss_loss"]) and last["ss_loss"] > 0
    out = capsys.readouterr().out
    assert "skipped" not in out
    assert os.listdir(tmp_path / "synthetic_pol" / "runs")
    saved = configs.load_config(str(tmp_path / "synthetic_pol"
                                    / "config.json"))
    assert saved.hardmask and saved.with_depth_loss and saved.ss_loss
    assert saved.total_iters == 2  # the preset's horizon is not explicit
    assert os.path.isdir(tmp_path / "synthetic_pol" / "checkpoints")


def test_mip_steps_ignore_ss_loss_with_a_warning():
    """No mip step reads ss_loss, in either package, and the mip batches
    carry no reference view: the dispatch warns and picks the step it
    picks without it."""
    from consistentnerf_tpu_torch.ops import fused_onepass

    cfg = configs.Config(backbone="mipnerf", ss_loss=True,
                         use_fused_train=True, use_onepass_train=True)
    with pytest.warns(UserWarning, match="ss_loss"):
        step = loop.select_train_step(cfg, None)
    assert step.__qualname__.startswith(
        fused_onepass.build_onepass_mip_train_step.__name__ + ".")
    scene = synthetic.make_scene(n_views=4, H=16, W=16).to_scene_data()
    batch = pipeline.MipBatcher(scene, cfg.replace(N_rand=32)).next_batch()
    assert "ref_image" not in batch
