"""The port's two-call fused train steps vs the JAX package, and the
train CLI on both.

The vanilla step (`ops/fused_train.py::build_fused_vanilla_train_step`,
CPU path: the kernels' plain versions) is held against the JAX step of
the same name, from the same params and batch, with `softLpmask` (where
the dispatch sends it) and with `hardmask` (use_onepass_train=false), each
with `fused_kernel` "v2" (#1/#2), "v2row" (#10/#11), "v2h" (the plain
forward and #11), "v1" (#13/#14) and "hybrid" (the plain forward and
#14), at the small config of the port's one-pass step tests
(depth 2, width 32, 16 + 8 samples, multires 4 / 2, 192 + 64 rays,
perturb 0): loss, stats and updated params within the JAX package's
bounds for its fused steps. The mip step (`build_fused_mip_train_step`)
is held against the JAX one at the config of the JAX package's own test
(tests/test_train_step.py:439-476: the RegNeRF depth TV norm with decay
on random-pose patch rays from the scene's first 4 poses,
randomized=False), with the disp metrics on (the dispatch's reason to
take it). Each JAX step runs once per module.
"""

import os

import jax
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import MipBatcher as JaxMipBatcher
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_train as jft
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_train
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train.checkpoints import checkpoint_steps

CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=192,
           n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
           with_depth_loss=True, perturb=0.0, use_fused_train=True,
           use_onepass_train=True)
MASKS = {"softLp": dict(hardmask=False, softLpmask=True),
         "hard": dict(hardmask=True, use_onepass_train=False)}
KINDS = ("v2", "v2row", "v2h", "v1", "hybrid")
# The bounds of the port's step tests (the JAX package's own for its
# fused steps against its XLA step).
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(atol=2e-4, rtol=5e-3)
STATS = ("loss", "img_loss", "depth_loss", "img_loss0", "depth_loss0",
         "mono_depth_loss", "patch_ssim", "psnr")
MIP_CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32,
               mip_num_samples=8, mip_num_levels=2, max_deg_point=4,
               disable_normals=True, N_rand=0, white_bkgd=True, near=2.0,
               far=6.0, compute_depth_metrics=True,
               compute_mono_depth_metrics=True, use_hardmask=True,
               dataset_type="blender", use_fused_train=True,
               use_onepass_train=True, compute_disp_metrics=True,
               depth_tvnorm_decay=True, depth_tvnorm_maxstep=512,
               depth_tvnorm_loss_mult_start=400.0,
               depth_tvnorm_loss_mult_end=0.1, depth_tvnorm_mask_weight=1.0,
               load_random_rays=True, batch_size_random=128,
               random_patch_size=8, randomized=False)
MIP_LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
MIP_PARAM_TOL = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    return jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()


@pytest.fixture(scope="module", params=[(m, k) for m in MASKS for k in KINDS],
                ids=[f"{m}-{k}" for m in MASKS for k in KINDS])
def jax_vanilla(request):
    """Config, batch, initial params and the JAX two-call step's result."""
    mask, kind = request.param
    kw = dict(CFG, fused_kernel=kind, **MASKS[mask])
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **kw)
    model = jax_make_model(jcfg)
    batch = JaxBatcher(_scene(), jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    step = jft.build_fused_vanilla_train_step(jcfg, donate=False, tile=64)
    s, st = step(state, batch, jax.random.PRNGKey(0))
    return kw, batch, jax.device_get(state.params), (
        interop.params_from_jax(jax.device_get(s.params)),
        {k: float(np.asarray(v)) for k, v in st.items()})


def test_vanilla_twocall_step_matches_jax(jax_vanilla, monkeypatch):
    """select_train_step picks the two-call step (softLpmask, or the
    one-pass step switched off); one step of it equals the JAX step: loss,
    stats, grad norm and updated params."""
    kw, batch, params, (want_sd, want_stats) = jax_vanilla
    cfg = configs.Config(**kw)
    built = []
    real = fused_train.build_fused_vanilla_train_step
    monkeypatch.setattr(fused_train, "build_fused_vanilla_train_step",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.params_from_jax(params))
    train_step = loop.select_train_step(cfg, state.model)
    assert built == [1]
    state, stats = train_step(state, to_device(batch, "cpu"))
    for k in STATS:
        np.testing.assert_allclose(float(stats[k]), want_stats[k],
                                   err_msg=k, **LOSS_TOL)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               want_stats["grad_norm"], rtol=1e-3)
    sd = state.model.state_dict()
    assert sd.keys() == want_sd.keys()
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(),
                                   want_sd[k].numpy().reshape(sd[k].shape),
                                   err_msg=k, **PARAM_TOL)
    assert state.step == 1


@pytest.mark.parametrize("kind", ["v1", "hybrid"])
def test_v1_kernels_raise(kind):
    """The v1 kinds no longer raise: the dispatch builds the two-call step
    on the v1 ops (#13/#14, or the plain forward and #14), and their
    differentiable op gives the v1 kernels' weight grads and zero input
    grads."""
    from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt

    cfg = configs.Config(**{**CFG, **MASKS["softLp"], "fused_kernel": kind})
    step = loop.select_train_step(cfg, None)
    assert step.__qualname__.startswith(
        fused_train.build_fused_vanilla_train_step.__name__)
    op, transposed = fused_train.vanilla_op(kind)
    assert op is (fmt.fused_mlp_train if kind == "v1" else
                  fmt.hybrid_mlp_train) and not transposed
    state = loop.init_state(cfg, "cpu")
    flat = fm.flatten_params(state.model.fine, True, cfg.netdepth)
    pts = torch.randn(50, 3, requires_grad=True)
    views = torch.nn.functional.normalize(torch.randn(50, 3), dim=-1)
    raw = op(flat, pts, views, cfg.netdepth, (), cfg.multires,
             cfg.multires_views, "float32")
    raw.square().sum().backward()
    assert raw.shape == (50, 4) and torch.equal(pts.grad,
                                                torch.zeros_like(pts))
    want = fmt.plain_backward([w.detach() for w in flat], pts.detach(),
                              views, 2 * raw.detach(), cfg.netdepth, (),
                              cfg.multires, cfg.multires_views, "float32")
    for w, g in zip(flat, want):
        torch.testing.assert_close(w.grad, g)


def _port_rays(rays):
    return Rays(**{f: torch.tensor(np.asarray(getattr(rays, f)))
                   for f in ("origins", "directions", "viewdirs", "radii",
                             "lossmult", "near", "far")})


def port_mip_batch(batch):
    """A JAX mip batch (numpy or jax arrays) as the port's CPU batch."""
    return {k: _port_rays(v) if k.startswith("rays")
            else torch.tensor(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_mip():
    """Batch (with random-pose rays), initial params and the JAX two-call
    mip step's result."""
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **MIP_CFG)
    scene = _scene()
    model = jax_make_model(jcfg)
    batch = JaxMipBatcher(scene, jcfg,
                          random_poses=scene.poses[:4]).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    step = jft.build_fused_mip_train_step(jcfg, donate=False, tile=64)
    s, st = step(state, batch, jax.random.PRNGKey(0))
    return batch, jax.device_get(state.params), (
        interop.mip_params_from_jax(jax.device_get(s.params)),
        {k: np.asarray(v) for k, v in st.items()})


def test_mip_twocall_step_matches_jax(jax_mip):
    """compute_disp_metrics sends the mip config to the two-call step; one
    step of it (TV norm on the random-pose rays included) equals the JAX
    step: loss, per-level stats and updated params."""
    batch, params, (want_sd, want_stats) = jax_mip
    cfg = configs.Config(**MIP_CFG)
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.mip_params_from_jax(params))
    train_step = loop.select_train_step(cfg, state.model)
    state, stats = train_step(state, port_mip_batch(batch))
    for k in ("loss", "losses", "depth_mses", "mono_depth_mses",
              "patch_tv_losses", "psnr"):
        np.testing.assert_allclose(np.asarray(stats[k]), want_stats[k],
                                   err_msg=k, **MIP_LOSS_TOL)
    assert float(stats["patch_tv_losses"][-1]) > 0
    sd = state.model.state_dict()
    assert sd.keys() == want_sd.keys()
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(),
                                   want_sd[k].reshape(sd[k].shape),
                                   err_msg=k, **MIP_PARAM_TOL)


def _cli_args(tmp_path, sets):
    return ["--device", "cpu"] + [x for s in sets + [
        "dataset_type=synthetic", "synthetic_hw=24", "synthetic_views=4",
        "netdepth=2", "netwidth=32", "white_bkgd=true", "i_print=3",
        "checkpoint_every=3", f"basedir={tmp_path}"] for x in ("--set", s)]


@pytest.mark.parametrize("backbone", ["vanilla", "mipnerf"])
def test_train_cli_twocall_steps(tmp_path, capsys, backbone):
    """The train CLI on the CPU: 3 steps of the vanilla two-call step
    (softLpmask, v2row) or of the mip two-call step with the TV norm on
    random-pose rays (use_onepass_train=false), a checkpoint, and a
    resume."""
    if backbone == "vanilla":
        sets = ["N_samples=8", "N_importance=8", "multires=4",
                "multires_views=2", "N_rand=64", "n_patches=1",
                "patch_size=8", "softLpmask=true", "with_depth_loss=true",
                "use_fused_train=true", "fused_kernel=v2row",
                "expname=soft"]
    else:
        sets = ["backbone=mipnerf", "mip_num_samples=8", "max_deg_point=4",
                "N_rand=32", "compute_depth_metrics=true",
                "use_fused_train=true", "use_onepass_train=false",
                "depth_tvnorm_decay=true", "depth_tvnorm_maxstep=512",
                "depth_tvnorm_loss_mult_start=400",
                "depth_tvnorm_loss_mult_end=0.1",
                "depth_tvnorm_mask_weight=1", "load_random_rays=true",
                "n_random_poses=8", "batch_size_random=128",
                "anneal_nearfar=true", "expname=miptv"]
    args = _cli_args(tmp_path, sets)
    exp = sets[-1].split("=")[1]
    res = train_cli.main(args + ["--num-steps", "3"])
    assert res.state.step == 3
    assert np.isfinite(res.stats_history[-1]["loss"])
    if backbone == "mipnerf":
        assert res.stats_history[-1]["patch_tv_losses"][-1] > 0
    assert checkpoint_steps(os.path.join(tmp_path, exp, "checkpoints")) == [3]
    res = train_cli.main(args + ["--num-steps", "5"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert res.state.step == 5
