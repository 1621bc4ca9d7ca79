"""The port's train-step pieces vs the JAX package: the mask losses, the
MiDaS patch loss, SSIM on 4x16x16 patches, `vanilla_losses`, the
optimizer chain and the batchers. Inputs are made with numpy from a seed
and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.consistency import masks as jmasks
from consistentnerf_tpu.consistency import monodepth as jmono
from consistentnerf_tpu.core import mathx as jmathx
from consistentnerf_tpu.data import pipeline as jpipe
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.train import image_metrics as jim
from consistentnerf_tpu.train import losses as jlosses
from consistentnerf_tpu.train import state as jstate
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.consistency import masks
from consistentnerf_tpu_torch.consistency import monodepth
from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.data import pipeline
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.train import image_metrics, losses, state

TOL = dict(atol=1e-6, rtol=1e-6)  # fp32 on both sides, same formulas
N, NP, PS = 1280, 4, 16  # rays, patches, patch size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    pred = rs.uniform(size=(N, 3)).astype(np.float32)
    target = rs.uniform(size=(N, 3)).astype(np.float32)
    mask = (rs.uniform(size=N) > 0.3).astype(np.float32)
    depth = rs.uniform(2, 6, size=N).astype(np.float32)
    prior = rs.uniform(2, 6, size=N).astype(np.float32)
    mono = np.where(rs.uniform(size=N) > 0.1,
                    rs.uniform(0.1, 0.5, size=N), 0).astype(np.float32)
    return dict(pred=pred, target=target, mask=mask, depth=depth,
                prior=prior, mono=mono)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("mask_kind", ["mixed", "all", "none"])
def test_mask_losses_match_jax(data, mask_kind):
    m = {"mixed": data["mask"], "all": np.ones(N, np.float32),
         "none": np.zeros(N, np.float32)}[mask_kind]
    p, t, d, pr = data["pred"], data["target"], data["depth"], data["prior"]
    _close(masks.img2mse(_t(p), _t(t)), jmasks.img2mse(p, t))
    _close(masks.masked_mse(_t(p), _t(t), _t(m)), jmasks.masked_mse(p, t, m))
    _close(masks.hardmask_rgb_loss(_t(p), _t(t), _t(m), 0.2),
           jmasks.hardmask_rgb_loss(p, t, m, 0.2))
    _close(masks.hardmask_depth_loss(_t(d), _t(pr), _t(m), 6.0),
           jmasks.hardmask_depth_loss(d, pr, m, 6.0))
    for far in (None, 6.0):
        _close(masks.unmasked_depth_loss(_t(d), _t(pr), _t(m), far),
               jmasks.unmasked_depth_loss(d, pr, m, far))
    _close(masks.img2mse_softLpmask(_t(p), _t(t), 2.0),
           jmasks.img2mse_softLpmask(p, t, 2.0))
    _close(masks.temp_schedule(10, 100, 1.0, 0.1),
           jmasks.temp_schedule(10, 100, 1.0, 0.1))
    _close(mathx.mse_to_psnr(torch.tensor(0.01)), jmathx.mse_to_psnr(0.01))
    _close(mathx.exp_lr_decay(1234, 5e-4, 0.1, 250000),
           jmathx.exp_lr_decay(1234, 5e-4, 0.1, 250000))


def test_midas_patch_loss_and_ssim_match_jax(data):
    d, mono = data["depth"].copy(), data["mono"]
    d[:7] = 0.0  # the reference's epsilon clamp
    _close(monodepth.midas_patch_loss(_t(d), _t(mono), PS, NP),
           jmono.midas_patch_loss(d, mono, PS, NP))
    img0 = data["pred"][: NP * PS * PS].reshape(NP, PS, PS, 3)
    img1 = data["target"][: NP * PS * PS].reshape(NP, PS, PS, 3)
    _close(image_metrics.ssim(_t(img0), _t(img1)), jim.ssim(img0, img1))


def _cfgs(**kw):
    base = dict(hardmask=True, with_depth_loss=True, n_patches=NP,
                patch_size=PS)
    base.update(kw)
    return configs.Config(**base), JaxConfig(**base)


@pytest.mark.parametrize("kw", [
    {},
    dict(hardmask=False, with_depth_norm=True),
    dict(hardmask=False),
    dict(hardmask=False, softLpmask=True),
    dict(use_batching=True),
])
def test_vanilla_losses_match_jax(data, kw):
    cfg, jcfg = _cfgs(**kw)
    rs = np.random.RandomState(2)
    outputs = {"rgb": data["pred"], "depth": data["depth"],
               "rgb0": rs.uniform(size=(N, 3)).astype(np.float32),
               "depth0": rs.uniform(2, 6, size=N).astype(np.float32)}
    batch = {"rgb": data["target"], "mask": data["mask"],
             "depth": data["prior"], "mono_disp": data["mono"],
             "loss_scale": np.float32(0.1)}
    loss, stats = losses.vanilla_losses(
        {k: _t(v) for k, v in outputs.items()},
        {k: _t(v) for k, v in batch.items()}, cfg, 6.0)
    jloss, jstats = jlosses.vanilla_losses(outputs, batch, jcfg, 6.0)
    _close(loss, jloss)
    assert set(stats) == set(jstats)
    for k in stats:
        _close(stats[k], jstats[k], atol=1e-6, rtol=1e-5)
    params = [rs.randn(4, 3).astype(np.float32), rs.randn(5).astype(
        np.float32)]
    _close(losses.tree_norm([_t(x) for x in params]),
           jlosses.tree_norm(params))


@pytest.mark.parametrize("kw", [{}, dict(grad_max_norm=0.05),
                                dict(check_grad_for_nans=False,
                                     grad_max_val=0.0)])
def test_optimizer_matches_optax_chain(kw):
    """Three updates from the same grads (with a NaN and values past the
    clip) against the JAX optimizer; the schedule reads the count before
    its increment."""
    cfg, jcfg = _cfgs(lrate=5e-4, lrate_decay=1, **kw)
    rs = np.random.RandomState(3)
    params = [rs.randn(6, 5).astype(np.float32),
              rs.randn(5).astype(np.float32)]
    grads = []
    for _ in range(3):
        g = [0.3 * rs.randn(*p.shape).astype(np.float32) for p in params]
        if cfg.check_grad_for_nans:
            g[0][1, 2] = np.nan
        grads.append(g)
    tparams = [torch.nn.Parameter(_t(p.copy())) for p in params]
    opt = state.make_optimizer(cfg, tparams)
    tx = jstate.make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jst = tx.init(jp)
    for i, g in enumerate(grads):
        for p, gi in zip(tparams, g):
            p.grad = _t(gi.copy())
        opt.step(i)
        upd, jst = tx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        for a, b in zip(tparams, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-7, rtol=0)
    assert state.make_lr_schedule(cfg)(0) == cfg.lrate


@pytest.fixture(scope="module")
def scenes():
    kw = dict(n_views=6, H=48, W=48)
    return (synthetic.make_scene(**kw).to_scene_data(),
            jsynth.make_scene(**kw).to_scene_data())


@pytest.mark.parametrize("kw", [
    dict(precrop_iters=2),
    dict(use_test_pseudo_label=True),
])
def test_vanilla_batcher_matches_jax(scenes, kw):
    """Same seed, same batches: precrop steps, then full-image steps with
    white-background patch rejection (the scene's borders are white)."""
    scene, jscene = scenes
    base = dict(N_rand=200, n_patches=2, patch_size=8, seed=7)
    base.update(kw)
    b = pipeline.VanillaBatcher(scene, configs.Config(**base))
    jb = jpipe.VanillaBatcher(jscene, JaxConfig(**base))
    for _ in range(5):
        got, want = b.next_batch(), jb.next_batch()
        assert set(got) == set(want)
        for k in ("rgb", "depth", "mask", "mono_disp", "loss_scale"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
        for k in ("origins", "directions", "viewdirs"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-6, rtol=0, err_msg=k)
    assert b.rng.randint(1 << 30) == jb.rng.randint(1 << 30)


def test_all_images_batcher_matches_jax(scenes):
    scene, jscene = scenes
    kw = dict(N_rand=500, n_patches=1, patch_size=8, use_batching=True)
    b = pipeline.AllImagesBatcher(scene, configs.Config(**kw))
    jb = jpipe.AllImagesBatcher(jscene, JaxConfig(**kw))
    for _ in range(30):  # past one pass over the pool: a reshuffle
        got, want = b.next_batch(), jb.next_batch()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                       err_msg=k)
