"""The mip backbone without view directions (`use_viewdirs=False`) against
the JAX package's eager model, whose param tree is then Dense_0..D-1
(trunk), Dense_D (density) and Dense_{D+1} (rgb on the trunk's output):
the forward per level within 1e-5 in fp32 (params carried by `interop`),
the eager step's loss within 1e-5 relative and grads within 1e-4 relative
L2 at perturb 0, the dispatch (the kernel configs train on the eager step
and render through the module, with warnings; the kernel builders and
packers raise, where the JAX kernel paths raise KeyError 'Dense_{D+2}'),
checkpoints of the shorter tree and the CLIs."""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli import import_mipnerf_ckpt as jimport
from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import MipBatcher as JaxMipBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_mip as jfused_mip
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import common
from consistentnerf_tpu_torch.cli import import_mipnerf_ckpt as pimport
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.ops import fused_mip, fused_onepass as op
from consistentnerf_tpu_torch.ops import fused_train
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train import render as render_lib
from consistentnerf_tpu_torch.train import step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
from consistentnerf_tpu_torch.train.evaluation import camera_rays_for_view
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_mip_model import _model_draws  # noqa: E402
from test_torch_port_mip_step import (_assert_close_step,  # noqa: E402
                                      _grads_at_update, _keep_grads,
                                      _port_batch, _port_state)

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, use_viewdirs=False, white_bkgd=True,
           disable_normals=True, render_chunk_size=100)
STEP_CFG = dict(CFG, N_rand=64, randomized=False, use_fused_train=False,
                compute_depth_metrics=True, compute_mono_depth_metrics=True,
                use_hardmask=True, dataset_type="blender")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
KEYS = ("rgb", "distance_mean", "acc", "distance_median")
DENSE = ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]


def _rays(n=40, seed=0):
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    o = (-4 * d / np.linalg.norm(d, axis=1, keepdims=True)
         + 0.2 * rs.randn(n, 3)).astype(np.float32)
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    ones = np.ones((n, 1), np.float32)
    f = dict(origins=o, directions=d, viewdirs=v, radii=0.004 * ones,
             lossmult=ones, near=2 * ones, far=6 * ones)
    return (JaxRays(**{k: jnp.asarray(x) for k, x in f.items()}),
            Rays(**{k: torch.tensor(x) for k, x in f.items()}))


@pytest.fixture(scope="module", params=[True, False],
                ids=["no_normals", "normals"])
def setup(request, _params):
    """The JAX and port models, with normals or without, on the same
    params (the tree does not depend on the normals)."""
    kw = dict(CFG, disable_normals=request.param)
    params, jrays, prays = _params
    jmodel = jax_make_model(JaxConfig(use_tensorboard=False, **kw))
    cfg = configs.Config(**kw)
    model = make_model(cfg, "cpu")
    model.load_state_dict(interop.mip_params_from_jax(params))
    return None, jmodel, params, jrays, cfg, model, prays


@pytest.fixture(scope="module")
def _params():
    jrays, prays = _rays()
    jmodel = jax_make_model(JaxConfig(use_tensorboard=False, **CFG))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), None, jrays, 0.01,
                                False))
    return params, jrays, prays


def test_param_tree_is_the_jax_one(setup):
    """Dense_0..Dense_{D+1}: trunk, density (W -> 1), rgb (W -> 3)."""
    *_, params, _, cfg, model, _ = setup
    tree = params["params"]["MipMLP_0"]
    assert sorted(tree) == DENSE
    assert tree["Dense_2"]["kernel"].shape == (32, 1)
    assert tree["Dense_3"]["kernel"].shape == (32, 3)
    names = [n for n, _ in model.mlp.named_parameters()]
    assert names == interop.flat_param_names(2, False, mip=True)
    back = interop.mip_params_to_jax(model.state_dict())
    for k in DENSE:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["params"]["MipMLP_0"][k][leaf],
                                          tree[k][leaf])
    flat = fused_mip.flatten_mip_params(model.mlp, 2)
    assert len(flat) == 8 and not fused_mip.has_view_layer(flat, 2)
    grads = interop.flat_grads_to_named(model.mlp, flat, 2)
    assert list(grads) == names


@pytest.mark.parametrize("randomized", [False, True])
def test_forward_per_level_matches_jax(setup, randomized):
    """MipNeRF.forward per level (rgb, distances, acc; the normals where
    they are on) against the JAX eager model, fp32."""
    jcfg, jmodel, params, jrays, cfg, model, prays = setup
    rng = jax.random.PRNGKey(7) if randomized else None
    want = jmodel.apply(params, rng, jrays, 0.01, True)
    draws = (_model_draws(rng, prays.origins.shape[0], cfg.mip_num_samples,
                          cfg.mip_num_levels) if randomized else None)
    with torch.no_grad():
        got = model(prays, draws, 0.01, compute_extras=True)
    keys = KEYS + (() if cfg.disable_normals else ("normals",))
    assert len(got) == len(want) == 2
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       err_msg=f"level {lvl} {k}",
                                       **FWD_TOL)


@pytest.fixture(scope="module")
def jax_step(request):
    """The JAX eager mip step without view directions: batch, initial
    params, stats and grads."""
    return once_per_run(request, _jax_step)


def _jax_step():
    jcfg = JaxConfig(use_tensorboard=False, **STEP_CFG)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = JaxMipBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    s, st = jstep.build_mip_train_step(model, jcfg, tx=tx, donate=False)(
        state, batch, jax.random.PRNGKey(0))
    grads = interop.mip_params_from_jax(jax.device_get(s.opt_state["g"]))
    return batch, jax.device_get(state.params), (
        {k: np.asarray(v) for k, v in st.items()}, grads)


def test_eager_step_matches_jax(jax_step):
    """The dispatch's step for the config (use_fused_train off) and the
    eager step with explicit draws (perturb 0): loss, stats and grads."""
    batch, params, want = jax_step
    assert sorted(params["params"]["MipMLP_0"]) == DENSE
    cfg = configs.Config(**STEP_CFG)
    b = _port_batch(batch)
    state = _port_state(params, cfg)
    grads = _grads_at_update(state)
    state, stats = loop.select_train_step(cfg, state.model)(state, b)
    assert state.step == 1
    _assert_close_step(stats, grads, *want)
    state = _port_state(params, cfg)
    draws = step_lib.make_mip_step_draws(
        cfg, b, torch.Generator().manual_seed(3), "cpu")
    grads = _grads_at_update(state)
    _, stats = step_lib.build_mip_train_step(state.model, cfg)(state, b,
                                                               draws)
    _assert_close_step(stats, grads, *want)


@pytest.mark.parametrize("onepass", [True, False])
def test_kernel_configs_train_on_the_eager_step(onepass, monkeypatch):
    """use_fused_train (one-pass or two-call) without view directions:
    the JAX gate takes the config and its kernel paths fail in
    flatten_mip_params; the port warns and builds the eager step."""
    kw = dict(STEP_CFG, use_fused_train=True, use_onepass_train=onepass)
    cfg = configs.Config(**kw)
    assert op.mip_onepass_supported(cfg) and jop.mip_onepass_supported(
        JaxConfig(use_tensorboard=False, **kw))
    with pytest.raises(KeyError, match="Dense_4"):
        jfused_mip.flatten_mip_params({"params": {"MipMLP_0": {
            k: {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}
            for k in DENSE}}}, 2)
    monkeypatch.setattr(step_lib, "build_mip_train_step",
                        lambda model, c, mesh=None: ("eager", c))
    with pytest.warns(UserWarning, match="KeyError 'Dense_4'.*eager step"):
        got = loop.select_train_step(cfg, None)
    assert got == ("eager", cfg)


def test_kernel_builders_and_packers_raise(setup):
    *_, cfg, model, prays = setup
    cfg = cfg.replace(disable_normals=True, use_fused_train=True)
    with pytest.raises(ValueError, match="view layer"):
        op.build_onepass_mip_train_step(cfg)
    with pytest.raises(ValueError, match="view layer"):
        fused_train.build_fused_mip_train_step(cfg)
    flat = [w.detach() for w in fused_mip.flatten_mip_params(model.mlp, 2)]
    with pytest.raises(ValueError, match="Dense_4"):
        fused_mip.pack(flat, 2, 4, "float32")
    x = torch.zeros(3, 5)
    for call in (lambda: fused_mip.fwd_T(flat, x, x, x, 2, 4, "float32"),
                 lambda: fused_mip.bwd_T(flat, x, x, x, torch.zeros(4, 5), 2,
                                         4, "float32"),
                 lambda: fused_mip.fused_mip_mlp_normals_T(
                     flat, x, x, x, 2, 4, "float32")):
        with pytest.raises(ValueError, match="view layer"):
            call()


def test_fused_render_goes_through_the_module(setup):
    """use_fused_render renders through the module with a warning, to the
    same images as the plain render."""
    *_, cfg, model, _ = setup
    scene = synthetic.make_scene(n_views=1, H=12, W=10).to_scene_data()
    rays = camera_rays_for_view(scene, scene.poses[0], device="cpu")
    plain = render_lib.build_render_fn(model, cfg)(rays)
    with pytest.warns(UserWarning, match="rendering through the module"):
        fn = render_lib.build_render_fn(model, cfg.replace(
            use_fused_render=True))
    got = fn(rays)
    for k in plain:
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)


def test_cli_trains_checkpoints_and_renders(tmp_path, capsys):
    """`--set use_viewdirs=false` through the CLIs: the kernel flags the
    card's defaults turn on (auto_fused_defaults) land on the eager step
    with the warning; the checkpoints hold the shorter tree and resume;
    the render CLI restores them."""
    sets = ["backbone=mipnerf", "use_viewdirs=false", "dataset_type=synthetic",
            "synthetic_hw=16", "synthetic_views=4", "netdepth=2",
            "netwidth=32", "mip_num_samples=8", "max_deg_point=4",
            "N_rand=32", "white_bkgd=true", "i_print=2",
            "use_tensorboard=false",
            "checkpoint_every=2", f"basedir={tmp_path}", "expname=nv"]
    args = ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]
    card = common.auto_fused_defaults(
        configs.Config(backbone="mipnerf", use_viewdirs=False),
        common.make_parser("x").parse_args(["--device", "cuda", "--set",
                                            "use_viewdirs=false"]))
    assert card.use_fused_train and card.use_onepass_train
    kernel = args + ["--set", "use_fused_train=true", "--set",
                     "use_onepass_train=true"]
    with pytest.warns(UserWarning, match="eager step"):
        res = train_cli.main(kernel + ["--num-steps", "2"])
    assert res.state.step == 2 and np.isfinite(res.stats_history[-1]["loss"])
    ckpt = CheckpointManager(str(tmp_path / "nv" / "checkpoints"))
    sd = ckpt.restore(copy.deepcopy(res.state)).model.state_dict()
    assert sorted(k for k in sd if k.endswith("weight")) == [
        f"mlp.dense.{i}.weight" for i in range(4)]
    for k, v in res.state.model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    res = train_cli.main(args + ["--num-steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert res.state.step == 3
    out = render_cli.main(args + ["--render-test", "--out",
                                  str(tmp_path / "r")])
    assert "restored" in capsys.readouterr().out
    assert sorted(os.listdir(out))[:2] == ["color_000.png", "color_001.png"]


def test_pretrained_importer_raises_as_jax_does():
    """A flax tree without view layers: the JAX importer's remap raises
    KeyError (it expects the D + 4 layers of RegNeRF's MipMLP), and the
    port's does the same."""
    rs = np.random.RandomState(0)
    mlp = {k: {"kernel": rs.rand(2, 2), "bias": rs.rand(2)} for k in DENSE}
    for mod in (jimport, pimport):
        with pytest.raises(KeyError, match="missing layers"):
            mod.pretrained_to_params(
                {"optimizer": {"target": {"params": {"MLP_0": mlp}}}}, 2)
