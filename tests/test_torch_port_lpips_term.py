"""The train-time patch LPIPS term vs the JAX package: the term on 16x16
patches (VGG's pools leave 1x1 maps there) in value and gradient, the
eager step with the term against the JAX eager step (loss, `patch_lpips`,
grads), the port's one-pass and two-call steps with the term against its
eager step, and the loop's gate (vanilla only, calibrated weights only).

Both packages load one `.npz` that the test writes from the JAX package's
seeded init (calibrated weights are not in the repo and nothing fetches
them). Small config: depth 2, width 32, 16 + 8 samples, multires 4 / 2,
one 16x16 patch and 64 random rays, perturb 0 (ROADMAP Queue 3 note D),
patch_lpips_loss_mult 1 so that the term's gradient shows in every
parameter's. Tolerances: the term and the loss 1e-5 relative; grads 1e-4
relative L2 per parameter, for the term's own gradient (the step's grads
with the term less those without it, in each package) and for the kernel
steps against the eager step. The whole step's grads agree with the JAX
step's to 3e-4 at this config with or without the term: the fine level's
inverse CDF turns ~1e-7 differences into its first layers' grads (ROADMAP
Queue 3 note D), so they are held at 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import lpips as jlpips
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pipeline import VanillaBatcher, to_device
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import fused_train
from consistentnerf_tpu_torch.train import loop, losses, lpips
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=64,
           n_patches=1, patch_size=16, white_bkgd=True, near=2.0, far=6.0,
           hardmask=True, with_depth_loss=True, perturb=0.0,
           patch_lpips_loss_mult=1.0)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_GRAD_REL = 5e-4  # the whole step against JAX (note D)
STATS = ("loss", "patch_lpips", "patch_ssim", "mono_depth_loss", "img_loss",
         "depth_loss", "img_loss0", "depth_loss0")


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """The JAX package's seeded LPIPS init written in the `.npz` export
    format by `lpips.save_weights`, and the JAX params as the JAX loader
    reads that file (equal to the init's)."""
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jlpips.init_params)(jax.random.PRNGKey(0)))
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    lpips.save_weights(path, interop.lpips_params_from_jax(params))
    loaded = jlpips.load_weights(path)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    return path, loaded


@pytest.fixture(scope="module")
def port_npz(tmp_path_factory):
    """The port's seeded init in the `.npz` export format (for the tests
    that hold the port against itself)."""
    path = str(tmp_path_factory.mktemp("lpips") / "port_vgg.npz")
    lpips.save_weights(path, lpips.init_params(0))
    return path


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


@pytest.fixture(scope="module")
def jax_run(request, lpips_npz):
    """Batch, initial params and the JAX eager step's stats and grads,
    with the LPIPS term (key 1.0) and without it (key 0.0: no params)."""
    return once_per_run(request, lambda: _jax_run(lpips_npz))


def _jax_run(lpips_npz):
    path, jparams = lpips_npz
    jcfg = JaxConfig(use_tensorboard=False, lpips_weights_path=path, **CFG)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = JaxBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    out = {}
    for mult in (0.0, 1.0):
        step = jstep.build_vanilla_train_step(
            model, jcfg, tx=tx, lpips_params=jparams if mult else None,
            donate=False)
        s, st = step(state, batch, jax.random.PRNGKey(0))
        out[mult] = ({k: np.asarray(v) for k, v in st.items()},
                     interop.params_from_jax(jax.device_get(
                         s.opt_state["g"])))
    return batch, jax.device_get(state.params), out


def _port_state(params, cfg):
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.params_from_jax(params))
    return state


def _grads_at_update(state):
    """{name: grad} that the optimizer's next update reads."""
    opt, grads = state.optimizer, {}
    update = opt.step
    names = [n for n, _ in state.model.named_parameters()]

    def step(count):
        for name, p in zip(names, opt.params):
            grads[name] = (torch.zeros_like(p) if p.grad is None
                           else p.grad.detach().clone())
        update(count)

    opt.step = step
    return grads


def _assert_grads(grads, want, tol=GRAD_REL):
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        w = want[k].reshape(g.shape)
        norm = torch.linalg.norm(w)
        if norm == 0:  # the temperature scalars take no grad
            assert torch.linalg.norm(g) == 0, k
            continue
        rel = (torch.linalg.norm(g - w) / norm).item()
        assert rel < tol, f"{k}: grad rel L2 {rel:.3e}"


def test_lpips_term_on_16x16_patches_matches_jax(lpips_npz):
    """The term of `_patch_terms` on four 16x16 patches (the flagship's
    patch shape; the deepest block runs on 1x1 maps): its value and its
    gradient by the predicted patch against the JAX term's."""
    path, jparams = lpips_npz
    rng = np.random.RandomState(0)
    pred = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(
        np.float32)

    def jterm(p):
        return jnp.mean(jlpips.lpips(jparams, p * 2 - 1, gt * 2 - 1))

    want, want_g = jax.value_and_grad(jterm)(jnp.asarray(pred))
    params = lpips.load_weights(path)
    x = torch.tensor(pred, requires_grad=True)
    got = torch.mean(lpips.lpips(params, x * 2 - 1, torch.tensor(gt) * 2 - 1))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    g, w = x.grad.numpy(), np.asarray(want_g)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < GRAD_REL
    feats = lpips._features(params, x.detach() * 2 - 1)
    assert [f.shape[-1] for f in feats] == [16, 8, 4, 2, 1]


def test_eager_step_with_lpips_matches_jax(jax_run, lpips_npz):
    """The eager step with the term against the JAX eager step: the loss,
    the stats (`patch_lpips` the fine level's term), the term's own
    gradient and the whole step's grads."""
    batch, params, want = jax_run
    path, _ = lpips_npz
    got = {}
    cfg = configs.Config(**CFG, lpips_weights_path=path)
    for mult in (0.0, 1.0):
        state = _port_state(params, cfg)
        grads = _grads_at_update(state)
        lp = loop.train_lpips_params(cfg, "cpu") if mult else None
        train_step = loop.select_train_step(cfg, state.model,
                                            lpips_params=lp)
        state, stats = train_step(state, to_device(batch, "cpu"))
        got[mult] = (stats, grads)
        want_stats, want_grads = want[mult]
        assert (float(stats["patch_lpips"]) > 0) == bool(mult)
        for k in STATS:
            np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                       err_msg=k, rtol=LOSS_RTOL, atol=1e-7)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(want_stats["grad_norm"]),
                                   rtol=GRAD_REL)
        _assert_grads(grads, want_grads, STEP_GRAD_REL)
    term = {k: got[1.0][1][k] - got[0.0][1][k] for k in got[0.0][1]}
    want_term = {k: want[1.0][1][k] - want[0.0][1][k] for k in term}
    _assert_grads(term, want_term)


@pytest.mark.parametrize("kind", ["onepass", "v2"])
def test_kernel_steps_with_lpips_match_the_eager_step(port_npz, kind):
    """The one-pass step (patch rays through #1 / #2 with autograd, the
    rest through #3) and the v2 two-call step, with the term, against the
    eager step from the same state and batch: the term's gradient reaches
    the kernels' cotangents through autograd."""
    cfg = configs.Config(**CFG, lpips_weights_path=port_npz,
                         use_fused_train=True, use_onepass_train=True)
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    b = to_device(VanillaBatcher(scene, cfg).next_batch(), "cpu")
    lp = loop.train_lpips_params(cfg, "cpu")
    build = (op.build_onepass_vanilla_train_step if kind == "onepass"
             else fused_train.build_fused_vanilla_train_step)
    results = []
    for step_fn in (build(cfg, lpips_params=lp),
                    step_lib.build_vanilla_train_step(None, cfg,
                                                      lpips_params=lp)):
        state = loop.init_state(cfg, "cpu")
        grads = _grads_at_update(state)
        _, st = step_fn(state, b)
        results.append((st, grads))
    (st_k, g_k), (st_e, g_e) = results
    assert float(st_e["patch_lpips"]) > 0
    for k in STATS:
        np.testing.assert_allclose(float(st_k[k]), float(st_e[k]),
                                   err_msg=k, rtol=LOSS_RTOL, atol=1e-7)
    _assert_grads(g_k, g_e)
    # Without the term the step computes another loss.
    st_0 = build(cfg)(loop.init_state(cfg, "cpu"), b)[1]
    assert float(st_0["patch_lpips"]) == 0.0
    assert float(st_0["loss"]) != float(st_k["loss"])


def test_lpips_gate_and_dispatch(port_npz, tmp_path):
    """The gate of the JAX loop (train/loop.py:136-160): the vanilla
    backbone with calibrated weights takes the term (its params on the
    train device); a path that names no file warns and skips; the mip
    backbone does not read the field. The one-pass gate is the JAX
    predicate with the term on."""
    path = port_npz
    cfg = configs.Config(**CFG, lpips_weights_path=path)
    lp = loop.train_lpips_params(cfg, "cpu")
    assert lp["convs"][0][0]["w"].shape == (64, 3, 3, 3)
    assert lp["convs"][0][0]["w"].device.type == "cpu"
    said = []
    missing = cfg.replace(lpips_weights_path=str(tmp_path / "none.npz"))
    assert loop.train_lpips_params(missing, "cpu", said.append) is None
    assert len(said) == 1 and "SKIPPING the train-time LPIPS term" in said[0]
    assert loop.train_lpips_params(cfg.replace(lpips_weights_path=None),
                                   "cpu", said.append) is None
    with pytest.raises(ValueError, match="at least 16 pixels"):
        loop.train_lpips_params(cfg.replace(patch_size=8), "cpu")
    assert loop.train_lpips_params(cfg.replace(patch_size=8, n_patches=0),
                                   "cpu") is not None
    mip = configs.Config(backbone="mipnerf", lpips_weights_path=path)
    assert loop.train_lpips_params(mip, "cpu", said.append) is None
    assert len(said) == 1
    jcfg = JaxConfig(use_tensorboard=False, lpips_weights_path=path,
                     use_fused_train=True, use_onepass_train=True, **CFG)
    one = cfg.replace(use_fused_train=True, use_onepass_train=True)
    assert op.onepass_supported(one) == jop.onepass_supported(jcfg) is True
    step = loop.select_train_step(one, None, lpips_params=lp)
    assert step.__qualname__.startswith(
        op.build_onepass_vanilla_train_step.__name__ + ".")
    # The term changes the loss by patch_lpips_loss_mult x its value.
    outputs = {"rgb": torch.rand(320, 3), "depth": torch.rand(320) * 4 + 2}
    b = {"rgb": torch.rand(320, 3), "depth": torch.rand(320) * 4 + 2,
         "mask": torch.ones(320), "mono_disp": torch.rand(320)}
    with_lp = losses.vanilla_losses(outputs, b, cfg, cfg.far, 1.0, lp)[1]
    without = losses.vanilla_losses(outputs, b, cfg, cfg.far, 1.0, None)[1]
    np.testing.assert_allclose(
        float(with_lp["loss"]) - float(without["loss"]),
        cfg.patch_lpips_loss_mult * float(with_lp["patch_lpips"]),
        rtol=1e-5)
