"""The port's mip train steps vs the JAX package, the mip batcher, the
interop of the mip params, the train and render CLIs, and the options of
the mip steps (normals on the eager step; the fused steps' refusals).

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
other with the same draws. The eager step with normals
(disable_normals=false, compute_normal_metrics) is held against the JAX
eager step the same way. The JAX grads are read from an optimizer that
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
from consistentnerf_tpu_torch.ops import fused_train
from consistentnerf_tpu_torch.train import loop, state as state_lib
from consistentnerf_tpu_torch.train import step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import checkpoint_steps
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True, N_rand=64,
           white_bkgd=True, randomized=False, use_fused_train=True,
           use_onepass_train=True, compute_depth_metrics=True,
           compute_mono_depth_metrics=True, use_hardmask=True,
           dataset_type="blender")
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STATS = ("loss", "losses", "depth_mses", "mono_depth_mses", "psnr")


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
    return once_per_run(request, lambda: _jax_run(request.param))


def _jax_run(n_rand):
    kw = dict(CFG, N_rand=n_rand)
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
    """The options of the mip steps, all ported now: the eager step
    trains with normals (disable_normals=false, compute_normal_metrics),
    which the one-pass gate refuses as the JAX gate does and the fused
    steps refuse (6n has no backward; the JAX two-call step asserts it);
    the RegNeRF regularizers and the two-call step run; a `.tar` in a mip
    experiment is refused, naming the mip importer."""
    base = configs.Config(**CFG)
    scene = synthetic.make_scene(n_views=2, H=16, W=16).to_scene_data()
    for kw in (dict(disable_normals=False),
               dict(compute_normal_metrics=True)):
        cfg = base.replace(**kw)
        jcfg = JaxConfig(use_tensorboard=False, **{**CFG, **kw})
        assert not op.mip_onepass_supported(cfg)
        assert not jop.mip_onepass_supported(jcfg)
        assert step_lib.build_mip_train_step(None, cfg) is not None
        with pytest.raises(ValueError, match="one-pass"):
            op.build_onepass_mip_train_step(cfg)
    normals = base.replace(disable_normals=False)
    with pytest.raises(ValueError, match="disable_normals"):
        fused_train.build_fused_mip_train_step(normals)
    with pytest.raises(ValueError, match="disable_normals"):
        loop.select_train_step(normals, None)
    assert loop.select_train_step(normals.replace(use_fused_train=False),
                                  None) is not None
    # The TV norm, random-pose rays and near/far annealing are ported:
    # the gate accepts them, the batcher makes the random rays, and the
    # dispatch's two-call step (use_onepass_train=false) builds.
    tv = base.replace(depth_tvnorm_loss_mult=0.1, load_random_rays=True,
                      anneal_nearfar=True, batch_size_random=64)
    assert op.mip_onepass_supported(tv)
    batch = MipBatcher(scene, tv, random_poses=scene.poses).next_batch()
    assert batch["rays_random"].origins.shape == (64, 3)
    assert loop.select_train_step(tv.replace(use_onepass_train=False),
                                  None) is not None
    # use_pdf_kernel (kernel #9, its plain version here) is ported: the
    # step computes what the plain resampler's step computes.
    params = _params_for(base)
    b = to_device(MipBatcher(scene, base.replace(N_rand=16)).next_batch(),
                  "cpu")
    st = [op.build_onepass_mip_train_step(base.replace(use_pdf_kernel=k))(
        _port_state(params, base), b)[1] for k in (True, False)]
    np.testing.assert_allclose(float(st[0]["loss"]), float(st[1]["loss"]),
                               rtol=LOSS_RTOL)
    args = ["--device", "cpu", "--set", "backbone=mipnerf", "--set",
            "dataset_type=synthetic", "--set", f"basedir={tmp_path}"]
    (tmp_path / "exp").mkdir(exist_ok=True)
    (tmp_path / "exp" / "000100.tar").write_bytes(b"")
    with pytest.raises(ValueError, match="import_mipnerf_ckpt"):
        render_cli.main(args + ["--render-test"])


@pytest.fixture(scope="module")
def jax_normals_run(request):
    """The JAX eager mip step with normals (disable_normals=false) and
    compute_normal_metrics: batch, initial params, stats and grads."""
    return once_per_run(request, _jax_normals_run)


def _jax_normals_run():
    kw = dict(CFG, disable_normals=False, compute_normal_metrics=True,
              use_fused_train=False)
    jcfg = JaxConfig(use_tensorboard=False, **kw)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = JaxMipBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    tx = _keep_grads()
    state = state.replace(opt_state=tx.init(state.params))
    s, st = jstep.build_mip_train_step(model, jcfg, tx=tx, donate=False)(
        state, batch, jax.random.PRNGKey(0))
    grads = interop.mip_params_from_jax(jax.device_get(s.opt_state["g"]))
    return kw, batch, jax.device_get(state.params), (
        {k: np.asarray(v) for k, v in st.items()}, grads)


def test_eager_step_with_normals_matches_jax(jax_normals_run):
    """The eager mip step at disable_normals=false with
    compute_normal_metrics against the JAX eager step: the model computes
    the normals (no loss reads them), loss, stats and grads agree at the
    file's tolerances, and they equal the step's without normals."""
    kw, batch, params, want = jax_normals_run
    cfg = configs.Config(**kw)
    state = _port_state(params, cfg)
    grads = _grads_at_update(state)
    step = loop.select_train_step(cfg, state.model)
    b = _port_batch(batch)
    with torch.no_grad():
        r = state.model(b["rays"], compute_extras=True)
    assert r[-1]["normals"].shape == (b["rgb"].shape[0], 3)
    assert torch.isfinite(r[-1]["normals"]).all()
    state, stats = step(state, b)
    assert state.step == 1
    _assert_close_step(stats, grads, *want)
    quiet = cfg.replace(disable_normals=True, compute_normal_metrics=False)
    state_q = _port_state(params, quiet)
    grads_q = _grads_at_update(state_q)
    _, stats_q = loop.select_train_step(quiet, state_q.model)(state_q, b)
    np.testing.assert_allclose(float(stats_q["loss"]), float(stats["loss"]),
                               rtol=LOSS_RTOL)
    for k in grads:
        rel = (torch.linalg.norm(grads[k] - grads_q[k])
               / torch.linalg.norm(grads_q[k])).item()
        assert rel < GRAD_REL, (k, rel)


def _params_for(cfg):
    """Seeded JAX-layout params of `cfg`'s model (for a port state)."""
    model = loop.init_state(cfg, "cpu").model
    return interop.mip_params_to_jax(model.state_dict())
