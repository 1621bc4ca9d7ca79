"""The RegNeRF regularizers of the mip trainer in the port vs the JAX
package: the depth TV norm and its annealed weight (`core/mathx.py`), the
random poses and the near/far annealing (`data/random_poses.py`), the mip
batcher's random-pose patch rays, the TV branch of `mip_losses`, and the
eager and one-pass mip steps with the TV norm on (its random-pose rays
through the differentiable fused forward, #6/#7's plain versions here).

The steps run at the config of tests/test_torch_port_mip_step.py (depth
2, width 32, 8 samples, 4 IPE frequencies, hard mask, depth MSE, MiDaS
term, Blender scales, randomized=False) with the TV norm's decay, 128
random-pose rays in 8x8 patches from the scene's first 4 poses and
`anneal_nearfar`, and are held at that file's bounds: the loss within
1e-5 relative and each parameter's grad within 1e-4 relative L2. Each
JAX step runs once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core import mathx as jmathx
from consistentnerf_tpu.data import random_poses as jrp
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import MipBatcher as JaxMipBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.train import losses as jlosses
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.data import random_poses as rp
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pipeline import MipBatcher
from consistentnerf_tpu_torch.train import losses, loop
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True, N_rand=64,
           white_bkgd=True, randomized=False, use_fused_train=True,
           use_onepass_train=True, compute_depth_metrics=True,
           compute_mono_depth_metrics=True, use_hardmask=True,
           dataset_type="blender", depth_tvnorm_decay=True,
           depth_tvnorm_maxstep=512, depth_tvnorm_loss_mult_start=400.0,
           depth_tvnorm_loss_mult_end=0.1, depth_tvnorm_mask_weight=1.0,
           load_random_rays=True, batch_size_random=128,
           random_patch_size=8, anneal_nearfar=True)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STATS = ("loss", "losses", "depth_mses", "mono_depth_mses",
         "patch_tv_losses", "psnr")
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "lossmult",
              "near", "far")


@pytest.mark.parametrize("losstype", ["l2", "l1"])
@pytest.mark.parametrize("weighted", [False, True])
def test_tv_norm_and_weight_match_jax(losstype, weighted):
    rs = np.random.RandomState(0)
    values = rs.randn(3, 8, 8, 1).astype(np.float32)
    w = rs.rand(3, 7, 7, 1).astype(np.float32) if weighted else None
    got = mathx.compute_tv_norm(torch.tensor(values), losstype,
                                None if w is None else torch.tensor(w))
    want = jmathx.compute_tv_norm(jnp.asarray(values), losstype,
                                  None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for step, max_step in ((0, 512), (100, 512), (600, 512), (3, 0)):
        np.testing.assert_allclose(
            mathx.compute_tvnorm_weight(step, max_step, 400.0, 0.1),
            float(jmathx.compute_tvnorm_weight(step, max_step, 400.0, 0.1)),
            rtol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(pose_type="renderpath"), dict(pose_type="renderpath",
                                       focusptjitter=False, radius=0.5),
    dict(pose_type="renderpath", add_test_poses=True),
    dict(pose_type="linearcomb"), dict(pose_type="testposes"),
    dict(pose_type="allposes")], ids=lambda kw: "-".join(
        f"{v}" for v in kw.values()))
def test_random_poses_and_annealing_match_jax(kw):
    scene = synthetic.make_scene(n_views=6, H=16, W=16).to_scene_data()
    train, test = scene.poses[:4], scene.poses[4:]
    got = rp.generate_random_poses(train, n_poses=12, test_poses=test,
                                   rng=np.random.RandomState(3), **kw)
    want = jrp.generate_random_poses(train, n_poses=12, test_poses=test,
                                     rng=np.random.RandomState(3), **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for it in (0, 250, 2000, 5000):
        assert rp.anneal_nearfar_values(it, 2.0, 6.0, 1000, 0.2, 0.5) == \
            jrp.anneal_nearfar_values(it, 2.0, 6.0, 1000, 0.2, 0.5)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return configs.Config(**kw), JaxConfig(use_tensorboard=False,
                                           fused_tile=64, **kw)


@pytest.mark.parametrize("mode", ["single_image_patch", "all_images"])
def test_mip_batcher_random_rays_match_jax(mode):
    """One seed, identical batches: the random-pose patch rays draw from
    the batcher's RandomState in the JAX order, and anneal_nearfar
    rewrites near / far of every ray bundle."""
    cfg, jcfg = _cfgs(batching=mode, anneal_nearfar_steps=2)
    poses = synthetic.make_scene(n_views=6, H=32, W=32).poses[:4]
    port = MipBatcher(synthetic.make_scene(n_views=4, H=32,
                                           W=32).to_scene_data(), cfg,
                      random_poses=poses)
    ref = JaxMipBatcher(jsynth.make_scene(n_views=4, H=32,
                                          W=32).to_scene_data(), jcfg,
                        random_poses=poses)
    nears = []
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        assert got.keys() == want.keys() and "rays_random" in got
        for k in got:
            if k.startswith("rays"):
                for f in RAY_FIELDS:
                    np.testing.assert_array_equal(
                        getattr(got[k], f), np.asarray(getattr(want[k], f)),
                        err_msg=f"{k}.{f}")
            else:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=k)
        assert got["rays_random"].origins.shape == (128, 3)
        nears.append(float(got["rays_random"].near[0, 0]))
    assert nears[0] > nears[1] > nears[2] == 2.0  # annealed to near


def _port_rays(rays):
    from consistentnerf_tpu_torch.core.rays import Rays

    return Rays(**{f: torch.tensor(np.asarray(getattr(rays, f)))
                   for f in RAY_FIELDS})


def _port_batch(batch):
    return {k: _port_rays(v) if k.startswith("rays")
            else torch.tensor(np.asarray(v)) for k, v in batch.items()}


def test_mip_losses_tv_branch_matches_jax():
    """mip_losses on given renderings: the TV norm of each random-pose
    level, weighted (decay or mult) into the loss as the JAX package
    weighs it."""
    rs = np.random.RandomState(1)
    n, nr, ps = 16, 2 * 64, 8

    def level(k):
        return {"rgb": rs.rand(k, 3).astype(np.float32),
                "distance_mean": rs.rand(k).astype(np.float32) + 2,
                "distance_mean_save": rs.rand(k).astype(np.float32) + 2,
                "acc": rs.rand(k).astype(np.float32)}

    rend = [level(n), level(n)]
    rend_r = [level(nr), level(nr)]
    ones = np.ones((n, 1), np.float32)
    from consistentnerf_tpu.core.rays import Rays as JRays

    jrays = JRays(origins=ones * 0, directions=ones * 0, viewdirs=ones * 0,
                  radii=ones, lossmult=ones, near=ones * 2, far=ones * 6)
    batch = {"rays": jrays, "rgb": rs.rand(n, 3).astype(np.float32),
             "dpts": rs.rand(n).astype(np.float32),
             "masks": np.ones((n,), np.float32),
             "mono_dpts": rs.rand(n).astype(np.float32),
             "bounds": np.array([2.0, 6.0], np.float32)}
    params = {"w": rs.randn(4, 4).astype(np.float32)}
    for kw in (dict(), dict(depth_tvnorm_decay=False,
                            depth_tvnorm_loss_mult=0.3,
                            depth_tvnorm_type="l1",
                            depth_tvnorm_selector="distance_mean")):
        cfg, jcfg = _cfgs(compute_mono_depth_metrics=False, **kw)
        weight = 123.0
        jl, jst = jlosses.mip_losses(
            [{k: jnp.asarray(v) for k, v in r.items()} for r in rend],
            [{k: jnp.asarray(v) for k, v in r.items()} for r in rend_r],
            batch, params, jcfg, weight)
        tl, tst = losses.mip_losses(
            [{k: torch.tensor(v) for k, v in r.items()} for r in rend],
            [{k: torch.tensor(v) for k, v in r.items()} for r in rend_r],
            _port_batch(batch), [torch.tensor(params["w"])], cfg, weight)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(tst["patch_tv_losses"].numpy(),
                                   np.asarray(jst["patch_tv_losses"]),
                                   rtol=1e-6)
        assert float(tst["patch_tv_losses"][-1]) > 0


def _keep_grads():
    """An optax transformation that updates nothing and keeps the grads
    in its state."""
    def init(params):
        return {"g": jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        del state, params
        return jax.tree_util.tree_map(jnp.zeros_like, updates), \
            {"g": updates}

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module", params=["eager", "onepass"])
def jax_step(request):
    """Batch, initial params, and one JAX step's stats and grads."""
    return once_per_run(request, lambda: _jax_step(request.param))


def _jax_step(kind):
    _, jcfg = _cfgs()
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batcher = JaxMipBatcher(scene, jcfg, random_poses=scene.poses[:4])
    batcher.next_batch()  # a step into the annealing
    batch = batcher.next_batch()
    state = jloop.init_state(jcfg, model, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params), step=7)
    fn = (jstep.build_mip_train_step(model, jcfg, tx=tx, donate=False)
          if kind == "eager" else
          jop.build_onepass_mip_train_step(jcfg, tx=tx, donate=False,
                                           tile=256))
    s, st = fn(state, batch, jax.random.PRNGKey(0))
    grads = interop.mip_params_from_jax(jax.device_get(s.opt_state["g"]))
    return kind, batch, jax.device_get(state.params), (
        {k: np.asarray(v) for k, v in st.items()}, grads)


def test_mip_steps_with_tv_match_jax(jax_step):
    """The port's eager and one-pass mip steps with the TV norm against
    their JAX counterparts: loss, per-level stats (the TV terms included)
    and the grads that the update reads, at step 7 of the decay."""
    kind, batch, params, (want_stats, want_grads) = jax_step
    cfg, _ = _cfgs(use_fused_train=kind == "onepass")
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.mip_params_from_jax(params))
    state.step = 7
    opt, grads = state.optimizer, {}
    update = opt.step
    names = [n for n, _ in state.model.named_parameters()]

    def keep(count):
        for name, p in zip(names, opt.params):
            grads[name] = p.grad.detach().clone()
        update(count)

    opt.step = keep
    train_step = loop.select_train_step(cfg, state.model)
    _, stats = train_step(state, _port_batch(batch))
    for k in STATS:
        # psnr = -10 log10(mse): the mse's relative bound is an absolute
        # one of 10 / ln(10) times it on the psnr (near 0 here).
        atol = 10 / np.log(10) * LOSS_RTOL if k == "psnr" else 1e-7
        np.testing.assert_allclose(np.asarray(stats[k]), want_stats[k],
                                   err_msg=k, rtol=LOSS_RTOL, atol=atol)
    assert float(stats["patch_tv_losses"][-1]) > 0
    assert grads.keys() == want_grads.keys()
    for k, g in grads.items():
        w = want_grads[k].reshape(g.shape)
        rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w)).item()
        assert rel < GRAD_REL, f"{k}: grad rel L2 {rel:.3e}"
