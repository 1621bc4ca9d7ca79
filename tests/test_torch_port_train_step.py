"""The port's vanilla train step vs the JAX package, and the train CLI.

The one-pass kernel step (`ops/fused_onepass.py`, CPU path: the kernels'
plain versions) is held against the JAX one-pass step, and the eager
step (`train/step.py`) against the JAX XLA step, from the same params and
batch, at the small config of tests/test_fused_onepass.py (depth 2, width
32, 16 + 8 samples, multires 4 / 2, 192 + 64 rays, hard mask, depth loss,
patch MiDaS and SSIM terms). perturb=0 as there: multires 4 / 2 keeps the
fine inverse CDF well conditioned (ROADMAP Queue 3 item 4). Stochastic
draws are tensors, so the perturbed steps are checked against themselves.
Each JAX step runs once per module.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core import sampling
from consistentnerf_tpu_torch.data.pipeline import to_device
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.train import loop, step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import checkpoint_steps
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

CFG = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=192,
           n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
           hardmask=True, with_depth_loss=True, perturb=0.0,
           use_fused_train=True, use_onepass_train=True)
# The JAX package's own bounds for its one-pass step against its XLA step
# (tests/test_fused_onepass.py:453-462).
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(atol=2e-4, rtol=5e-3)
STATS = ("loss", "img_loss", "depth_loss", "img_loss0", "depth_loss0",
         "mono_depth_loss", "patch_ssim", "psnr")


@pytest.fixture(scope="module")
def jax_run(request):
    """Batch, initial params and the two JAX steps' results."""
    return once_per_run(request, _jax_run)


def _jax_run():
    jcfg = JaxConfig(use_tensorboard=False, fused_tile=64, **CFG)
    scene = jsynth.make_scene(n_views=6, H=48, W=48).to_scene_data()
    model = jax_make_model(jcfg)
    batch = JaxBatcher(scene, jcfg).next_batch()
    state = jloop.init_state(jcfg, model, batch)
    key = jax.random.PRNGKey(0)
    xla = jstep.build_vanilla_train_step(model, jcfg, donate=False)
    one = jop.build_onepass_vanilla_train_step(jcfg, donate=False, tile=64)
    out = {"params": jax.device_get(state.params)}
    for name, fn in (("xla", xla), ("onepass", one)):
        s, st = fn(state, batch, key)
        out[name] = (interop.params_from_jax(jax.device_get(s.params)),
                     {k: float(np.asarray(v)) for k, v in st.items()})
    return batch, out


def _port_state(params, cfg):
    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(interop.params_from_jax(params))
    return state


def _assert_step(state, stats, want_sd, want_stats):
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


@pytest.mark.parametrize("kind", ["onepass", "xla"])
def test_step_matches_jax_step(jax_run, kind):
    """The port's one-pass step against the JAX one-pass step, its eager
    step against the JAX XLA step: loss, stats and params after one
    step."""
    batch, out = jax_run
    cfg = configs.Config(**CFG)
    if kind == "xla":
        cfg = cfg.replace(use_fused_train=False)
    state = _port_state(out["params"], cfg)
    train_step = loop.select_train_step(cfg, state.model)
    state, stats = train_step(state, to_device(batch, "cpu"))
    _assert_step(state, stats, *out[kind])


def _perturbed(out, **kw):
    cfg = configs.Config(**{**CFG, "perturb": 1.0, **kw})
    return cfg, _port_state(out["params"], cfg)


def test_draws_drive_the_perturbed_step(jax_run, monkeypatch):
    """perturb=1: the same draws give the same step, the coarse depths of
    the kernel level are vanilla_z_vals(t_rand), and a step that makes
    its own draws makes them from (seed, step)."""
    batch, out = jax_run
    cfg, state = _perturbed(out)
    b = to_device(batch, "cpu")
    n = b["rgb"].shape[0]
    draws = step_lib.make_draws(cfg, n, torch.Generator().manual_seed(9),
                                "cpu")
    seen = []
    real = op.onepass_level

    def spy(weights, pts_T, views_T, z, *a, **k):
        seen.append(z.clone())
        return real(weights, pts_T, views_T, z, *a, **k)

    monkeypatch.setattr(op, "onepass_level", spy)
    train_step = op.build_onepass_vanilla_train_step(cfg)
    s1, st1 = train_step(copy.deepcopy(state), b, draws)
    s2, st2 = train_step(copy.deepcopy(state), b, draws)
    assert float(st1["loss"]) == float(st2["loss"])
    for a, c in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(a, c)
    p = cfg.n_patches * cfg.patch_size**2
    ones = torch.ones(n, 1)
    z_c = sampling.vanilla_z_vals(ones * cfg.near, ones * cfg.far,
                                  cfg.N_samples, False, draws["t_rand"])
    assert torch.equal(seen[0], z_c[p:])
    assert not torch.equal(seen[0], sampling.vanilla_z_vals(
        ones * cfg.near, ones * cfg.far, cfg.N_samples, False, None)[p:])
    own = step_lib.make_draws(cfg, n, step_lib.step_generator(cfg.seed, 0,
                                                              "cpu"), "cpu")
    s3, st3 = train_step(copy.deepcopy(state), b)
    s4, st4 = train_step(copy.deepcopy(state), b, own)
    assert float(st3["loss"]) == float(st4["loss"])


@pytest.mark.parametrize("kw", [{}, dict(use_noise=True)])
def test_onepass_step_matches_eager_step_with_draws(jax_run, kw):
    """perturb=1 (and output noise): with the same draws the kernel step
    and the eager step compute the same update."""
    batch, out = jax_run
    cfg, state = _perturbed(out, **kw)
    b = to_device(batch, "cpu")
    draws = step_lib.make_draws(cfg, b["rgb"].shape[0],
                                torch.Generator().manual_seed(3), "cpu")
    s1, st1 = op.build_onepass_vanilla_train_step(cfg)(
        copy.deepcopy(state), b, draws)
    eager = step_lib.build_vanilla_train_step(state.model, cfg)
    s2, st2 = eager(copy.deepcopy(state), b, draws)
    for k in STATS:
        np.testing.assert_allclose(float(st1[k]), float(st2[k]), err_msg=k,
                                   **LOSS_TOL)
    for (k, a), c in zip(s1.model.named_parameters(),
                         s2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_train_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """The train CLI on the CPU (kernel step, plain versions): 6 steps
    with a finite loss and a checkpoint, a resume that continues from step
    6, and the render CLI restoring that checkpoint."""
    sets = ["dataset_type=synthetic", "synthetic_hw=24", "synthetic_views=4",
            "netdepth=2", "netwidth=32", "N_samples=8", "N_importance=8",
            "multires=4", "multires_views=2", "N_rand=64", "n_patches=1",
            "patch_size=8", "white_bkgd=true", "hardmask=true",
            "with_depth_loss=true", "use_fused_train=true",
            "use_onepass_train=true", "i_print=3", "checkpoint_every=3",
            f"basedir={tmp_path}", "expname=tiny"]
    args = ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]
    res = train_cli.main(args + ["--num-steps", "6"])
    assert res.state.step == 6
    assert np.isfinite(res.stats_history[-1]["loss"])
    ckpt_dir = tmp_path / "tiny" / "checkpoints"
    assert checkpoint_steps(str(ckpt_dir)) == [3, 6]
    res = train_cli.main(args + ["--num-steps", "8"])
    assert "resumed from step 6" in capsys.readouterr().out
    # The loop logs at multiples of i_print only (the JAX loop's rule):
    # none in steps 7-8.
    assert res.state.step == 8 and len(res.stats_history) == 0
    out_dir = render_cli.main(args + ["--render-test",
                                      "--out", str(tmp_path / "r")])
    assert "restored" in capsys.readouterr().out
    assert len(os.listdir(out_dir)) == 4  # 2 test views x (color, depth)


def test_train_cli_raises_for_what_is_not_ported(tmp_path):
    base = ["--device", "cpu", "--set", "dataset_type=synthetic",
            "--set", f"basedir={tmp_path}"]
    # --bootstrap-priors is ported (tests/test_torch_port_producer_clis.py),
    # and so are multi-process runs (tests/test_torch_port_parallel.py); a
    # run of several processes without its coordinator and rank raises.
    with pytest.raises(ValueError, match="coordinator_address and "
                       "process_id"):
        train_cli.main(base + ["--set", "num_processes=2"])
    # --eval-after is ported (tests/test_torch_port_eval.py). Weights on
    # disk turn the train-time LPIPS term on, as in the JAX loop
    # (tests/test_torch_port_lpips_term.py holds it against the JAX step):
    # the stats carry a nonzero patch_lpips.
    from consistentnerf_tpu_torch.train import lpips

    weights = str(tmp_path / "lpips.npz")
    lpips.save_weights(weights, lpips.init_params(0))
    sets = ["synthetic_hw=24", "synthetic_views=3", "netdepth=2",
            "netwidth=32", "N_samples=8", "N_importance=8", "multires=4",
            "multires_views=2", "N_rand=32", "n_patches=1", "patch_size=16",
            "i_print=1", "use_tensorboard=false",
            f"lpips_weights_path={weights}"]
    args = base + [x for s_ in sets for x in ("--set", s_)]
    res = train_cli.main(args + ["--num-steps", "1"])
    assert float(res.stats_history[-1]["patch_lpips"]) > 0
    # Smaller patches leave VGG's last block no pixel (NaN in the JAX
    # package): refused.
    with pytest.raises(ValueError, match="at least 16 pixels"):
        train_cli.main(args + ["--set", "patch_size=8", "--set",
                               "expname=small", "--num-steps", "1"])