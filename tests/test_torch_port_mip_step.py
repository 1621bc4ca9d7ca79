"""The port's mip train steps vs the JAX package, the mip batcher, the
interop of the mip params, the train and render CLIs, and the options
this slice leaves unported.

The one-pass step (`ops/fused_onepass.py::build_onepass_mip_train_step`,
CPU path: the kernels' plain versions) is held against the JAX one-pass
step, and the eager step (`train/step.py::build_mip_train_step`) against
the JAX `build_mip_train_step`, from the same params and batch at the
small config of tests/test_fused_onepass.py (depth 2, width 32, 8
samples, 4 IPE frequencies, hard mask, depth MSE, Blender scales) with
the MiDaS patch term on: the loss within 1e-5 relative and each
parameter's grad within 1e-4 relative L2, in fp32, also with N_rand=0
(every ray a patch ray). randomized=False: a stochastic level 1
resamples from level 0's weights through an inverse CDF that magnifies
~1e-7 differences (ROADMAP Queue 3 item 4); stochastic draws are tensors,
so the randomized steps (density noise on) are checked against each
other with the same draws. The JAX grads are read from an optimizer that
keeps them; each JAX step runs once per module.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import MipBatcher as JaxMipBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import state as jstate
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.train import loop, state as state_lib
from consistentnerf_tpu_torch.train import step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import checkpoint_steps

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True, N_rand=64,
           white_bkgd=True, randomized=False, use_fused_train=True,
           use_onepass_train=True, compute_depth_metrics=True,
           compute_mono_depth_metrics=True, use_hardmask=True,
           dataset_type="blender")
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STATS = ("loss", "losses", "depth_mses", "mono_depth_mses", "psnr")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's thread pool in each of them would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module", params=[64, 0], ids=["n_rand64", "n_rand0"])
def jax_run(request):
    """Batch, initial params, and the two JAX steps' stats and grads."""
    kw = dict(CFG, N_rand=request.param)
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **kw)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = JaxMipBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    key = jax.random.PRNGKey(0)
    out = {"params": jax.device_get(state.params)}
    for name, fn in (
            ("eager", jstep.build_mip_train_step(model, jcfg, tx=tx,
                                                 donate=False)),
            ("onepass", jop.build_onepass_mip_train_step(
                jcfg, tx=tx, donate=False, tile=256))):
        s, st = fn(state, batch, key)
        grads = interop.mip_params_from_jax(jax.device_get(s.opt_state["g"]))
        out[name] = ({k: np.asarray(v) for k, v in st.items()}, grads)
    return kw, batch, out


def _port_batch(batch):
    rays = Rays(**{f: torch.tensor(np.asarray(getattr(batch["rays"], f)))
                   for f in ("origins", "directions", "viewdirs", "radii",
                             "lossmult", "near", "far")})
    out = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()
           if k != "rays"}
    out["rays"] = rays
    return out


def _port_state(params, cfg):
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.mip_params_from_jax(params))
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


def _assert_close_step(stats, grads, want_stats, want_grads):
    for k in STATS:
        np.testing.assert_allclose(np.asarray(stats[k]), want_stats[k],
                                   err_msg=k, rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(want_stats["grad_norm"]), rtol=1e-4)
    assert grads.keys() == want_grads.keys()
    for k, g in grads.items():
        w = want_grads[k].reshape(g.shape)
        rel = (torch.linalg.norm(g - w) / torch.linalg.norm(w)).item()
        assert rel < GRAD_REL, f"{k}: grad rel L2 {rel:.3e}"


@pytest.mark.parametrize("kind", ["onepass", "eager"])
def test_step_matches_jax_step(jax_run, kind):
    """The port's one-pass step against the JAX one-pass step, its eager
    step against the JAX eager step: loss, stats and grads of one step."""
    kw, batch, out = jax_run
    cfg = configs.Config(**kw)
    if kind == "eager":
        cfg = cfg.replace(use_fused_train=False)
    state = _port_state(out["params"], cfg)
    grads = _grads_at_update(state)
    train_step = loop.select_train_step(cfg, state.model)
    state, stats = train_step(state, _port_batch(batch))
    assert state.step == 1
    _assert_close_step(stats, grads, *out[kind])


def test_onepass_step_matches_eager_step_with_draws(jax_run):
    """randomized with density noise: with the same draws the kernel step
    and the eager step compute the same loss and grads, and a step that
    makes its own draws makes them from (seed, step)."""
    kw, batch, out = jax_run
    cfg = configs.Config(**{**kw, "randomized": True, "density_noise": 1.0})
    state = _port_state(out["params"], cfg)
    b = _port_batch(batch)
    n = b["rgb"].shape[0]
    draws = step_lib.make_mip_draws(cfg, n, torch.Generator().manual_seed(3),
                                    "cpu")
    assert draws["t_rand"].shape == (n, cfg.mip_num_samples + 1)
    assert len(draws["noise"]) == cfg.mip_num_levels
    results = []
    for build in (op.build_onepass_mip_train_step,
                  lambda c: step_lib.build_mip_train_step(state.model, c)):
        s = copy.deepcopy(state)
        grads = _grads_at_update(s)
        _, st = build(cfg)(s, b, draws)
        results.append((st, grads))
    (st1, g1), (st2, g2) = results
    np.testing.assert_allclose(float(st1["loss"]), float(st2["loss"]),
                               rtol=LOSS_RTOL)
    for k in g1:
        rel = (torch.linalg.norm(g1[k] - g2[k])
               / torch.linalg.norm(g2[k])).item()
        assert rel < GRAD_REL, (k, rel)
    quiet = {k: v for k, v in draws.items() if k != "noise"}
    eager = step_lib.build_mip_train_step(state.model, cfg)
    _, st0 = eager(copy.deepcopy(state), b, quiet)
    assert float(st0["loss"]) != float(st2["loss"])  # the noise engaged
    train_step = op.build_onepass_mip_train_step(cfg)
    own = step_lib.make_mip_draws(cfg, n, step_lib.step_generator(
        cfg.seed, 0, "cpu"), "cpu")
    _, st3 = train_step(copy.deepcopy(state), b)
    _, st4 = train_step(copy.deepcopy(state), b, own)
    assert float(st3["loss"]) == float(st4["loss"])


@pytest.mark.parametrize("mode", ["single_image_patch", "single_image",
                                  "all_images"])
def test_mip_batcher_matches_jax(mode):
    cfg = configs.Config(**{**CFG, "batching": mode, "N_rand": 100})
    jcfg = JaxConfig(use_tensorboard=False, **{**CFG, "batching": mode,
                                               "N_rand": 100})
    port = MipBatcher(synthetic.make_scene(n_views=4, H=32,
                                           W=32).to_scene_data(), cfg)
    ref = JaxMipBatcher(jsynth.make_scene(n_views=4, H=32,
                                          W=32).to_scene_data(), jcfg)
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        assert got.keys() == want.keys()
        for k in got:
            if k == "rays":
                for f in ("origins", "directions", "viewdirs", "radii",
                          "lossmult", "near", "far"):
                    np.testing.assert_allclose(
                        getattr(got[k], f), np.asarray(getattr(want[k], f)),
                        atol=1e-6, err_msg=f)
            else:
                np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                           atol=1e-6, err_msg=k)
    dev = to_device(got, "cpu")
    assert isinstance(dev["rays"], Rays) and torch.is_tensor(dev["rgb"])


def test_interop_round_trip_and_lr_schedule(jax_run):
    _, _, out = jax_run
    params = out["params"]
    sd = interop.mip_params_from_jax(params)
    back = interop.mip_params_to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    model = _port_state(params, configs.Config(**CFG)).model
    assert set(model.state_dict()) == set(sd)
    cfg = configs.Config(**CFG)
    jcfg = JaxConfig(use_tensorboard=False, **CFG)
    sched, jsched = state_lib.make_lr_schedule(cfg), \
        jstate.make_lr_schedule(jcfg)
    for step in (0, 1, 300, 512, 20000):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)


def test_train_and_render_clis(tmp_path, capsys):
    """The mip train CLI on the CPU (kernel step, plain versions): 4 steps
    with checkpoints, a resume, and the render CLI restoring the newest
    checkpoint through the fused forward."""
    sets = ["backbone=mipnerf", "dataset_type=synthetic", "synthetic_hw=24",
            "synthetic_views=4", "netdepth=2", "netwidth=32",
            "mip_num_samples=8", "max_deg_point=4", "N_rand=32",
            "white_bkgd=true", "compute_depth_metrics=true",
            "use_fused_train=true", "use_onepass_train=true",
            "use_fused_render=true", "i_print=2", "checkpoint_every=2",
            f"basedir={tmp_path}", "expname=mip"]
    args = ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]
    res = train_cli.main(args + ["--num-steps", "4"])
    assert res.state.step == 4
    assert np.isfinite(res.stats_history[-1]["loss"])
    assert checkpoint_steps(str(tmp_path / "mip" / "checkpoints")) == [2, 4]
    res = train_cli.main(args + ["--num-steps", "5"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert res.state.step == 5
    out_dir = render_cli.main(args + ["--render-test",
                                      "--out", str(tmp_path / "r")])
    assert "restored" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "r").iterdir()) == [
        "color_000.png", "color_001.png", "depth_000.png", "depth_001.png"]
    assert out_dir == str(tmp_path / "r")


def test_unported_mip_options_raise(tmp_path):
    """Each option this slice leaves out raises, naming its ROADMAP item,
    instead of running something else."""
    base = configs.Config(**CFG)
    scene = synthetic.make_scene(n_views=2, H=16, W=16).to_scene_data()
    for kw, match in ((dict(depth_tvnorm_loss_mult=0.1),
                       "mip regularizers"),
                      (dict(depth_tvnorm_decay=True), "mip regularizers"),
                      (dict(load_random_rays=True), "mip regularizers"),
                      (dict(anneal_nearfar=True), "mip regularizers"),
                      (dict(disable_normals=False), "mip normals")):
        cfg = base.replace(**kw)
        with pytest.raises(NotImplementedError, match=match):
            op.mip_onepass_supported(cfg)
        with pytest.raises(NotImplementedError, match=match):
            step_lib.build_mip_train_step(None, cfg)
    for kw in (dict(load_random_rays=True), dict(anneal_nearfar=True)):
        with pytest.raises(NotImplementedError, match="mip regularizers"):
            MipBatcher(scene, base.replace(**kw))
    with pytest.raises(NotImplementedError, match="two-call fused step"):
        loop.select_train_step(base.replace(use_onepass_train=False), None)
    with pytest.raises(NotImplementedError, match="Queue 2 #9"):
        op.build_onepass_mip_train_step(base.replace(use_pdf_kernel=True))(
            _port_state(_params_for(base), base), to_device(
                MipBatcher(scene, base.replace(N_rand=16)).next_batch(),
                "cpu"))
    args = ["--device", "cpu", "--set", "backbone=mipnerf", "--set",
            "dataset_type=synthetic", "--set", f"basedir={tmp_path}"]
    with pytest.raises(NotImplementedError, match="mip regularizers"):
        train_cli.main(args + ["--set", "load_random_rays=true"])
    (tmp_path / "exp").mkdir(exist_ok=True)
    (tmp_path / "exp" / "000100.tar").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="import_mipnerf_ckpt"):
        render_cli.main(args + ["--render-test"])


def _params_for(cfg):
    """Seeded JAX-layout params of `cfg`'s model (for a port state)."""
    model = loop.init_state(cfg, "cpu").model
    return interop.mip_params_to_jax(model.state_dict())
