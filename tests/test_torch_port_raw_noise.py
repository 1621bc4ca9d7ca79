"""Density noise (`raw_noise_std`) of the vanilla model vs the JAX package.

The JAX `VanillaNeRF` draws its noise from `split(rng, 4)` by name
(coarse_strat, coarse_noise, pdf, fine_noise; models/nerf.py:117-120)
and only when its step hands it an rng, i.e. at perturb > 0
(train/step.py:126-127). The test pulls the JAX step's draws out of the
same key and hands them to the port's eager step as tensors (`t_rand`,
`u`, `noise_c`, `noise_f`): loss and stats within 1e-5 relative, the
noise's own gradient (the step's grads with the noise less those without
it, from the same draws, in each package) within 1e-4 relative L2 per
parameter, and the whole step's grads within 5e-4 (at perturb 1 the fine
level's inverse CDF turns ~1e-7 differences into its first layers' grads,
ROADMAP Queue 3 note D). At perturb 0 neither package adds noise. The
kernel steps compute none, so the dispatch sends a config whose eager
step adds it to the eager step, with a warning (ROADMAP Queue 3 note E).
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
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import fused_train
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=64,
           n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
           hardmask=True, with_depth_loss=True, perturb=1.0,
           raw_noise_std=1.0)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_GRAD_REL = 5e-4  # the whole perturbed step against JAX (note D)
STATS = ("loss", "img_loss", "depth_loss", "img_loss0", "depth_loss0",
         "mono_depth_loss", "patch_ssim", "psnr")
KEY = jax.random.PRNGKey(7)


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


def jax_draws(n):
    """The JAX eager step's draws at step 0 as the port takes them: the
    model splits fold_in(KEY, 0) into its four named keys."""
    keys = jax.random.split(jax.random.fold_in(KEY, 0), 4)
    s, s_i = CFG["N_samples"], CFG["N_importance"]
    draws = {"t_rand": jax.random.uniform(keys[0], (n, s)),
             "noise_c": jax.random.normal(keys[1], (n, s)),
             "u": jax.random.uniform(keys[2], (n, s_i)),
             "noise_f": jax.random.normal(keys[3], (n, s + s_i))}
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def setup(request):
    """A JAX batch and the JAX model's initial params."""
    return once_per_run(request, _setup)


def _setup():
    jcfg = JaxConfig(use_tensorboard=False, **CFG)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    batch = JaxBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, jax_make_model(jcfg), batch)
    return batch, jax.device_get(state.params)


@pytest.fixture(scope="module")
def jax_run(request, setup):
    """The JAX eager step's stats and grads at perturb 1 with the noise
    (key 1.0) and without it (key 0.0), from `setup`."""
    return once_per_run(request, lambda: _jax_run(setup))


def _jax_run(setup):
    batch, params = setup
    tx = _keep_grads()
    out = {}
    for std in (0.0, 1.0):
        c = JaxConfig(use_tensorboard=False, **{**CFG, "raw_noise_std": std})
        model = jax_make_model(c)
        state = jloop.init_state(c, model, batch)
        state = state.replace(params=params, opt_state=tx.init(params))
        step = jstep.build_vanilla_train_step(model, c, tx=tx, donate=False)
        s, st = step(state, batch, KEY)
        out[std] = ({k: np.asarray(v) for k, v in st.items()},
                    interop.params_from_jax(jax.device_get(
                        s.opt_state["g"])))
    return out


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


def _assert_grads(grads, want, tol):
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        w = want[k].reshape(g.shape)
        norm = torch.linalg.norm(w)
        if norm == 0:  # the temperature scalars take no grad
            assert torch.linalg.norm(g) == 0, k
            continue
        rel = (torch.linalg.norm(g - w) / norm).item()
        assert rel < tol, f"{k}: grad rel L2 {rel:.3e}"


def test_noisy_step_with_the_jax_draws_matches_jax(setup, jax_run):
    """perturb 1: the port's eager step on the JAX step's own draws, with
    and without the density noise, against the JAX eager step."""
    (batch, params), want = setup, jax_run
    b = to_device(batch, "cpu")
    draws = jax_draws(b["rgb"].shape[0])
    got = {}
    for std in (0.0, 1.0):
        cfg = configs.Config(**{**CFG, "raw_noise_std": std})
        state = _port_state(params, cfg)
        grads = _grads_at_update(state)
        step = loop.select_train_step(cfg, state.model)
        _, stats = step(state, b, draws)
        got[std] = grads
        for k in STATS:
            np.testing.assert_allclose(float(stats[k]),
                                       float(want[std][0][k]), err_msg=k,
                                       rtol=LOSS_RTOL, atol=1e-7)
        _assert_grads(grads, want[std][1], STEP_GRAD_REL)
    assert float(want[1.0][0]["loss"]) != float(want[0.0][0]["loss"])
    term = {k: got[1.0][k] - got[0.0][k] for k in got[0.0]}
    want_term = {k: want[1.0][1][k] - want[0.0][1][k] for k in term}
    _assert_grads(term, want_term, GRAD_REL)


def test_no_noise_at_perturb_zero(setup):
    """perturb 0: the JAX step hands its model no rng, so no noise; the
    port draws none and its forward and step equal the noise-free ones
    bit for bit. The JAX model's deterministic forward at raw_noise_std 1
    is the port's."""
    batch, params = setup
    b = to_device(batch, "cpu")
    cfg = configs.Config(**{**CFG, "perturb": 0.0})
    assert not step_lib.has_raw_noise(cfg)
    draws = step_lib.make_draws(cfg, b["rgb"].shape[0],
                                torch.Generator().manual_seed(0), "cpu")
    assert draws == {}
    stats = []
    for std in (1.0, 0.0):
        c = cfg.replace(raw_noise_std=std)
        state = _port_state(params, c)
        stats.append(loop.select_train_step(c, state.model)(state, b)[1])
    assert float(stats[0]["loss"]) == float(stats[1]["loss"])
    jcfg = JaxConfig(use_tensorboard=False, **{**CFG, "perturb": 0.0})
    rays = jstep.rays_from_batch(batch, jcfg.near, jcfg.far)
    want = jax.jit(jax_make_model(jcfg).apply)(params, None, rays)
    model = _port_state(params, cfg).model
    with torch.no_grad():
        out = model(step_lib.rays_from_batch(b, cfg.near, cfg.far))
    for k in ("rgb", "depth", "rgb0", "depth0"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_make_draws_and_the_ss_reference_renders():
    """make_draws adds the normals where the noise applies (after the
    level draws; the ss reference rays get their own, as the JAX step
    hands their render an rng at perturb > 0), and the eager step feeds
    them to the model: the loss moves with them."""
    cfg = configs.Config(**CFG)
    n = 10
    draws = step_lib.make_draws(cfg, n, torch.Generator().manual_seed(1),
                                "cpu")
    assert draws["noise_c"].shape == (n, 16)
    assert draws["noise_f"].shape == (n, 24)
    quiet = step_lib.make_draws(cfg.replace(raw_noise_std=0.0), n,
                                torch.Generator().manual_seed(1), "cpu")
    assert set(draws) - set(quiet) == {"noise_c", "noise_f"}
    assert torch.equal(draws["t_rand"], quiet["t_rand"])
    ss = step_lib.make_draws(cfg.replace(ss_loss=True), n,
                             torch.Generator().manual_seed(1), "cpu")
    assert {"noise_c", "noise_f"} <= set(ss["ss"])
    assert step_lib.model_draws(ss["ss"])["noise_f"].shape == (n, 24)


def test_dispatch_sends_noise_to_the_eager_step():
    """use_fused_train with noise that applies: the eager step, with a
    warning; the kernel builders refuse it; at perturb 0 (no noise) the
    one-pass step, as without the field."""
    cfg = configs.Config(**CFG, use_fused_train=True, use_onepass_train=True)
    with pytest.warns(UserWarning, match="density noise"):
        step = loop.select_train_step(cfg, None)
    assert step.__qualname__.startswith(
        step_lib.build_vanilla_train_step.__name__ + ".")
    for build in (op.build_onepass_vanilla_train_step,
                  fused_train.build_fused_vanilla_train_step):
        with pytest.raises(ValueError, match="density noise"):
            build(cfg)
    quiet = cfg.replace(perturb=0.0)
    step = loop.select_train_step(quiet, None)
    assert step.__qualname__.startswith(
        op.build_onepass_vanilla_train_step.__name__ + ".")
