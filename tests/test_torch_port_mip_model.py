"""The port's mip backbone vs the JAX package's: `MipNeRF.forward`, the
fused mip forward (`ops/fused_train.fused_mip_forward`, whose kernels run
their plain versions on the CPU) and the mip render, from the same params
and rays, within 2e-4 at fp32. The JAX draws are rebuilt from its keys in
the order each JAX path consumes them and handed to the port as tensors,
density noise included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops.fused_train import \
    fused_mip_forward as jax_fused_mip_forward
from consistentnerf_tpu.train import evaluation as jeval
from consistentnerf_tpu.train import render as jrender
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.ops import fused_mip
from consistentnerf_tpu_torch.ops.fused_train import fused_mip_forward
from consistentnerf_tpu_torch.train import evaluation
from consistentnerf_tpu_torch.train import render as render_lib

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, white_bkgd=True, disable_normals=True,
           density_noise=1.0, render_chunk_size=100)
TOL = dict(atol=2e-4, rtol=2e-4)
EPS = float(np.finfo(np.float32).eps)
KEYS = ("rgb", "distance_mean", "acc", "distance_median")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(0)
    n = 40
    d = rs.randn(n, 3).astype(np.float32)
    o = (-4 * d / np.linalg.norm(d, axis=1, keepdims=True)
         + 0.2 * rs.randn(n, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    ones = np.ones((n, 1), np.float32)
    fields = dict(origins=o, directions=d, viewdirs=v,
                  radii=(0.004 * ones).astype(np.float32), lossmult=ones,
                  near=2 * ones, far=6 * ones)
    jrays = JaxRays(**{k: jnp.asarray(x) for k, x in fields.items()})
    prays = Rays(**{k: torch.tensor(x) for k, x in fields.items()})
    jcfg = JaxConfig(use_tensorboard=False, **CFG)
    jmodel = jax_make_model(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), None, jrays, 0.01,
                                False))
    cfg = configs.Config(**CFG)
    model = make_model(cfg, "cpu")
    model.load_state_dict(interop.mip_params_from_jax(params))
    return jcfg, jmodel, params, jrays, cfg, model, prays


def _model_draws(rng, n, s, levels):
    """The draws MipNeRF.__call__ takes from `rng` (mipnerf.py:52-97): a
    split per level for its sampling, and the MLP's split of what remains
    for the density noise (mlp.py:116-120)."""
    draws = {"jitter": [None], "noise": []}
    for lvl in range(levels):
        key, rng = jax.random.split(rng)
        if lvl == 0:
            draws["t_rand"] = jax.random.uniform(key, (n, s + 1))
        else:
            draws["jitter"].append(jax.random.uniform(
                key, (n, s + 1), maxval=1 / (s + 1) - EPS))
        nkey, _ = jax.random.split(rng)
        draws["noise"].append(jax.random.normal(nkey, (n * s,)).reshape(
            n, s))
    return _torch_draws(draws)


def _fused_draws(rng, n, s, levels):
    """The draws fused_mip_forward takes from `rng` (fused_train.py:
    222-275): a split per level for its sampling, then one for the noise."""
    draws = {"jitter": [None], "noise": []}
    for lvl in range(levels):
        key, rng = jax.random.split(rng)
        if lvl == 0:
            draws["t_rand"] = jax.random.uniform(key, (n, s + 1))
        else:
            draws["jitter"].append(jax.random.uniform(
                key, (n, s + 1), maxval=1 / (s + 1) - EPS))
        nkey, rng = jax.random.split(rng)
        draws["noise"].append(jax.random.normal(nkey, (n * s,)).reshape(
            n, s))
    return _torch_draws(draws)


def _torch_draws(draws):
    def conv(x):
        return None if x is None else torch.tensor(np.asarray(x))

    return {k: [conv(x) for x in v] if isinstance(v, list) else conv(v)
            for k, v in draws.items()}


def _assert_levels(got, want, keys=KEYS):
    assert len(got) == len(want)
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k].detach().numpy(),
                                       np.asarray(w[k]),
                                       err_msg=f"level {lvl} {k}", **TOL)


@pytest.mark.parametrize("randomized", [False, True])
def test_model_forward_matches_jax(setup, randomized):
    jcfg, jmodel, params, jrays, cfg, model, prays = setup
    rng = jax.random.PRNGKey(7) if randomized else None
    want = jmodel.apply(params, rng, jrays, 0.01, True)
    draws = (_model_draws(rng, prays.origins.shape[0], cfg.mip_num_samples,
                          cfg.mip_num_levels) if randomized else None)
    with torch.no_grad():
        got = model(prays, draws, 0.01, compute_extras=True)
    _assert_levels(got, want)


@pytest.mark.parametrize("randomized", [False, True])
def test_fused_mip_forward_matches_jax(setup, randomized):
    """The fused forward (kernels #6 / #7 on the card, their plain
    versions here) against the JAX one in interpret mode."""
    jcfg, jmodel, params, jrays, cfg, model, prays = setup
    rng = jax.random.PRNGKey(8) if randomized else None
    want = jax_fused_mip_forward(params, rng, jrays, jcfg, 0.01, True,
                                 tile=64, interpret=True)
    draws = (_fused_draws(rng, prays.origins.shape[0], cfg.mip_num_samples,
                          cfg.mip_num_levels) if randomized else None)
    with torch.no_grad():
        got = fused_mip_forward(
            fused_mip.flatten_mip_params(model.mlp, cfg.netdepth), draws,
            prays, cfg, 0.01, compute_extras=True)
    _assert_levels(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_render_matches_jax_render(setup, fused):
    """build_render_fn on two views of the synthetic scene, the plain and
    the fused chunk renderers, against the JAX (plain) render: rgb, depth,
    disp, acc and distance_median."""
    jcfg, jmodel, params, _, cfg, model, _ = setup
    scene = jsynth.make_scene(n_views=2, H=12, W=12).to_scene_data()
    jr = jrender.build_render_fn(jmodel, jcfg, params)
    render = render_lib.build_render_fn(
        model.eval(), cfg.replace(use_fused_render=fused))
    for pose in scene.poses:
        want = jr(jeval.camera_rays_for_view(scene, pose))
        got = render(evaluation.camera_rays_for_view(scene, pose,
                                                     device="cpu"))
        assert set(got) == {"rgb", "depth", "disp", "acc",
                            "distance_median"}
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, atol=2e-4, rtol=2e-4)


def test_unported_model_options_raise():
    with pytest.raises(NotImplementedError, match="mip normals"):
        make_model(configs.Config(**{**CFG, "disable_normals": False}),
                   "cpu")
    cfg = configs.Config(**{**CFG, "disable_normals": False})
    with pytest.raises(NotImplementedError, match="mip normals"):
        fused_mip_forward([], None, None, cfg)
