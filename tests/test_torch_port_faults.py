"""Repairs of the port's faults against the JAX package, each held
against the JAX package itself:

* the train CLI's schedule horizon (`reconcile_schedule_horizon`): both
  CLIs resolve the same config for `--num-steps`;
* the train loop: both `train()`s hand their step the same batches (the
  JAX loop draws an example batch first, so step i trains on batch i + 1)
  and log at the same steps;
* `auto_fused_defaults`: the JAX predicate over a config grid, plus the
  port's own width term;
* a depth-5 NeRFMLP, whose skip after layer 4 feeds the heads [pe | h]:
  the JAX parameter tree loads and the forward matches; the kernels that
  cannot take the widened heads are routed around, and the v1 two-call
  step, which takes them, matches the JAX v1 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli import common as jcommon
from consistentnerf_tpu.cli import train as jtrain_cli
from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.data import loaders as jloaders
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.models.nerf import VanillaNeRF as JaxVanillaNeRF
from consistentnerf_tpu.ops import fused_train as jft
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import common
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import loaders, synthetic
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.models.mlp import NeRFMLP
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train import render as render_lib
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread  # noqa: F401


TINY = ["dataset_type=synthetic", "synthetic_hw=16", "synthetic_views=4"]


# ----------------------- the CLI's schedule horizon ------------------------


class _Stop(Exception):
    """Raised by the stubbed train loops once they hold the config."""


def _resolved_config(cli, loop_mod, loaders_mod, monkeypatch, argv):
    """The config `cli.main(argv)` hands its train loop."""
    got = {}

    def fake_train(cfg, *a, **k):
        got["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(loop_mod, "train", fake_train)
    monkeypatch.setattr(loaders_mod, "load_scene",
                        lambda cfg, *a, **k: got.setdefault("scene", None))
    with pytest.raises(_Stop):
        cli.main(argv)
    return got["cfg"]


SCHEDULES = {
    "horizon_follows": (["backbone=mipnerf", "anneal_nearfar=true"], 300),
    "explicit_anneal": (["anneal_nearfar_steps=700", "lr_delay_steps=0"],
                        1000),
    "explicit_horizon": (["total_iters=5000", "anneal_nearfar=true"], 100),
    "same_steps": (["total_iters=40"], 40),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_cli_schedule_horizon_matches_jax(case, tmp_path, monkeypatch):
    sets, steps = SCHEDULES[case]
    argv = [x for s in TINY + sets + [f"basedir={tmp_path}"]
            for x in ("--set", s)] + ["--num-steps", str(steps)]
    want = _resolved_config(jtrain_cli, jloop, jloaders, monkeypatch, argv)
    got = _resolved_config(train_cli, loop, loaders, monkeypatch,
                           ["--device", "cpu"] + argv)
    if case == "horizon_follows":
        assert got.total_iters == steps and got.anneal_nearfar_steps == 12
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


# --------------------------- the train loop ---------------------------------


def _recording_step(seen, to_numpy):
    def step(state, batch, *rest):
        seen.append(to_numpy(batch["rgb"]))
        return state, {"loss": 0.0, "psnr": 0.0}

    return step


def test_train_loop_hands_the_step_the_jax_batches(tmp_path, monkeypatch):
    """The same batches in the same order (the batcher's counter drives
    precrop here), and the JAX loop's log steps (multiples of i_print
    only, so stats_history has the JAX length)."""
    kw = dict(dataset_type="synthetic", netdepth=2, netwidth=32,
              N_samples=4, N_importance=4, N_rand=16, n_patches=1,
              patch_size=4, precrop_iters=3, i_print=2,
              checkpoint_every=100)
    scene = dict(n_views=4, H=16, W=16)
    jseen, seen = [], []
    monkeypatch.setattr(jloop, "select_train_step", lambda *a, **k:
                        _recording_step(jseen, np.asarray))
    monkeypatch.setattr(loop, "select_train_step", lambda *a, **k:
                        _recording_step(seen, lambda t: t.numpy()))
    want = jloop.train(JaxConfig(basedir=str(tmp_path), expname="jax",
                                 use_tensorboard=False, **kw),
                       jsynth.make_scene(**scene).to_scene_data(),
                       num_steps=5, use_prefetch=False, log_fn=lambda m: 0)
    got = loop.train(configs.Config(basedir=str(tmp_path), expname="port",
                                    **kw),
                     synthetic.make_scene(**scene).to_scene_data(),
                     num_steps=5, device="cpu", log_fn=lambda m: 0)
    assert len(seen) == len(jseen) == 5
    for i, (a, b) in enumerate(zip(seen, jseen)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {i}")
    assert len(got.stats_history) == len(want.stats_history) == 2


# ------------------------- auto_fused_defaults ------------------------------


class _FakeTpu:
    platform = "tpu"


GRID = [dict(backbone=b, multires=mr, multires_views=mv, max_deg_point=dp,
             use_viewdirs=uv, compute_dtype=dt, disable_normals=dn)
        for b in ("vanilla", "mipnerf") for mr, mv in ((10, 4), (20, 20),
                                                       (21, 4), (10, 21))
        for dp in (16, 21) for uv in (True, False)
        for dt in ("float32", "bfloat16") for dn in (True, False)]
KEYS = ("use_fused_train", "use_onepass_train", "use_fused_render",
        "fused_tile")


@pytest.mark.parametrize("width", [256, 48])
def test_auto_fused_defaults_match_jax(width, monkeypatch):
    """On an accelerator (the JAX side sees a faked TPU, the port a CUDA
    device name) both packages turn on the same paths for every config of
    the grid; at a width off the port's kernels (48) the port keeps the
    plain paths, its own term."""
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [_FakeTpu()])

    class Args:
        config, overrides, device = None, [], "cuda"

    changed = 0
    for kw in GRID:
        want = jcommon.auto_fused_defaults(JaxConfig(netwidth=width, **kw),
                                           Args())
        got = common.auto_fused_defaults(configs.Config(netwidth=width, **kw),
                                         Args())
        base = configs.Config(netwidth=width, **kw)
        for k in KEYS:
            expected = getattr(want, k) if width % 32 == 0 else \
                getattr(base, k)
            assert getattr(got, k) == expected, (kw, k)
        changed += got != base
    assert (changed > 0) == (width % 32 == 0)


# ------------------------------- depth 5 -----------------------------------

D5 = dict(num_samples=8, num_importance=8, multires=4, multires_views=2,
          net_depth=5, net_width=32, white_bkgd=True)


def test_depth5_heads_read_pe_and_h():
    """The skip after layer 4 of a depth-5 NeRFMLP feeds the heads: at
    width 32 and multires 10, alpha takes 95 features and feature 95, as
    the JAX kernels (95, 1) and (95, 32); a JAX depth-5 tree loads into the
    port and the forward matches the JAX apply."""
    m = NeRFMLP(net_depth=5, net_width=32, input_ch=63)
    assert m.alpha_linear.weight.shape == (1, 95)
    assert m.feature_linear.weight.shape == (32, 95)
    assert m.pts_linears[4].weight.shape == (32, 32)
    rs = np.random.RandomState(3)
    n = 30
    d = rs.randn(n, 3).astype(np.float32)
    o = (-2.0 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    ones = np.ones((n, 1), np.float32)
    fields = dict(origins=o, directions=d,
                  viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
                  radii=ones * 1e-3, lossmult=ones, near=ones * 0.5,
                  far=ones * 4.5)
    jmodel = JaxVanillaNeRF(**D5)
    jrays = JaxRays(**{k: jnp.asarray(v) for k, v in fields.items()})
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), None, jrays))
    assert params["params"]["fine"]["alpha"]["kernel"].shape == (59, 1)
    model = VanillaNeRF(**D5)
    model.load_state_dict(interop.params_from_jax(params))
    want = jmodel.apply(params, None, jrays)
    with torch.no_grad():
        got = model(Rays(**{k: torch.from_numpy(v)
                            for k, v in fields.items()}))
    for k in ("rgb", "depth", "acc", "rgb0", "depth0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


D5_CFG = dict(backbone="vanilla", netdepth=5, netwidth=32, N_samples=8,
              N_importance=8, multires=4, multires_views=2, N_rand=64,
              n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
              with_depth_loss=True, perturb=0.0, use_fused_train=True,
              use_onepass_train=True, hardmask=False, softLpmask=True)


def test_depth5_dispatch_routes_around_the_v2_kernels():
    """At depth 5 the one-pass and v2 kernels cannot take the widened
    heads: the train dispatch sends v2 kinds to the eager step and v1
    kinds to the two-call step; the fused render takes the v1 forward
    only."""
    cfg = configs.Config(**D5_CFG)
    for kind in ("v2", "v2row", "v2h"):
        with pytest.warns(UserWarning, match=f"fused_kernel='{kind}' at "
                          "netdepth 5: the heads read .* eager step"):
            step = loop.select_train_step(cfg.replace(fused_kernel=kind),
                                          None)
        assert step.__qualname__.startswith("build_vanilla_train_step")
    for kind in fm.V1_KINDS:
        step = loop.select_train_step(cfg.replace(fused_kernel=kind), None)
        assert step.__qualname__.startswith("build_fused_vanilla_train_step")
    r = cfg.replace(use_fused_render=True)
    assert not render_lib.fused_render_takes(r)
    assert render_lib.fused_render_takes(r.replace(fused_kernel="v1"))
    assert not render_lib.fused_render_takes(
        r.replace(fused_kernel="v1", use_onepass_render=True))
    assert render_lib.fused_render_takes(r.replace(netdepth=8))


def test_depth5_reroutes_say_why(recwarn):
    """Each depth-5 reroute of an explicitly asked kernel path warns with
    the route it takes and why: the one-pass train step gives way to the
    v1 two-call step, and a v2 or one-pass render to the module render. A
    route that keeps the kernels warns nothing."""
    cfg = configs.Config(**dict(D5_CFG, softLpmask=False))
    with pytest.warns(UserWarning, match="use_onepass_train at netdepth 5:"
                      " .* one-pass kernel .* v1 two-call step"):
        step = loop.select_train_step(cfg.replace(fused_kernel="v1"), None)
    assert step.__qualname__.startswith("build_fused_vanilla_train_step")
    model = VanillaNeRF(**D5)
    r = cfg.replace(use_fused_render=True)
    for kw in (dict(fused_kernel="v2"),
               dict(fused_kernel="v1", use_onepass_render=True)):
        with pytest.warns(UserWarning, match="use_fused_render .* netdepth "
                          "5: the heads read .* through the module"):
            render_lib.build_render_fn(model, r.replace(**kw))
    recwarn.clear()
    loop.select_train_step(cfg.replace(fused_kernel="v1",
                                       use_onepass_train=False), None)
    render_lib.build_render_fn(model, r.replace(fused_kernel="v1"))
    assert not [w for w in recwarn if "netdepth" in str(w.message)]


def test_depth5_v1_step_matches_jax():
    """The v1 two-call step at depth 5 (the JAX v1 kernels take the skip
    into the heads; its v2 kernels fail there with a shape error) against
    the JAX v1 step: loss and updated params."""
    kw = dict(D5_CFG, fused_kernel="v1")
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **kw)
    jscene = jsynth.make_scene(n_views=4, H=24, W=24).to_scene_data()
    batch = JaxBatcher(jscene, jcfg).next_batch()
    state = jloop.init_state(jcfg, jax_make_model(jcfg), batch)
    jstep = jft.build_fused_vanilla_train_step(jcfg, donate=False, tile=64)
    params = jax.device_get(state.params)
    s, st = jstep(state, batch, jax.random.PRNGKey(0))
    want_sd = interop.params_from_jax(jax.device_get(s.params))
    cfg = configs.Config(**kw)
    pstate = loop.init_state(cfg, "cpu")
    pstate.model.load_state_dict(interop.params_from_jax(params))
    step = loop.select_train_step(cfg, pstate.model)
    pstate, stats = step(pstate, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(stats["loss"]),
                               float(np.asarray(st["loss"])), rtol=2e-4,
                               atol=2e-4)
    sd = pstate.model.state_dict()
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(),
                                   want_sd[k].numpy().reshape(sd[k].shape),
                                   err_msg=k, atol=2e-4, rtol=5e-3)
    # The eager step takes the same config (the route for the v2 kinds).
    eager = step_lib.build_vanilla_train_step(pstate.model, cfg)
    assert eager is not None
