"""The warmup bootstrap end to end over seeds, in either package, and the
port's train loop against the JAX package's from one init.

    python3 tools/bootstrap_seeds.py port [--device cuda] [--seeds 0 1 2]
    python3 tools/bootstrap_seeds.py jax [--seeds 0 1 2]      # CPU
    python3 tools/bootstrap_seeds.py trajectory [--steps 500]  # CPU
    python3 tools/bootstrap_seeds.py crossed [--seeds 0 1 2]   # CPU

`port` / `jax`: the flow of tests/test_bootstrap.py::
test_bootstrap_priors_end_to_end (the sphere at 48x48, a 2x64 vanilla
model, 500 warmup steps, priors fused, hard masks, 500 consistent retrain
steps) with `cfg.seed` set to each seed; one line a seed: mask share,
prior depth-MSE inside the masks, held-out depth-MSE and PSNR of the
warmup and of the retrain, and whether the test's two retrain bounds hold
(depth-MSE below 1.3x the warmup's, PSNR above the warmup's less 2.5 dB).
The seed sets the init and the batches in both packages and the
perturbation draws in each package's own generator.

`trajectory`: the whole flow at perturb 0 (no draws) in both packages
from the JAX package's initial params carried into the port, on the same
seeded batches: the warmup, its rendered depths fused and masked, and
the retrain on them. The JAX side runs the JAX package's own init, batcher
and step function a step at a time (`jax_flow`), the port side its
`bootstrap_scene_priors` and `loop.train` (`port_flow`). Prints each
stage's losses side by side, where they first part by more than 1e-3,
both stages' held-out depth-MSE and PSNR in both packages, and how far
the priors and masks differ, then the port's retrain on the JAX priors
and masks against the JAX retrain.

`crossed`: the warmup of the `port` / `jax` flow (perturbed, each package
its own draws) from the JAX package's init and from the port's init of
each seed, in both packages: four held-out (depth-MSE, PSNR) pairs a
seed, which say whether the init or the package sets the result. `jax`,
`trajectory` and `crossed` import the JAX package and run on the CPU;
`port` imports torch only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 500
CFG = dict(backbone="vanilla", netdepth=2, netwidth=64, N_samples=16,
           N_importance=8, multires=4, multires_views=2, N_rand=192,
           n_patches=1, patch_size=8, white_bkgd=True, near=2.0, far=6.0,
           hardmask=True, with_depth_loss=True, i_print=1000,
           checkpoint_every=100000, total_iters=STEPS, lrate=5e-3)


def _summary(seed, scene, boot, warm_m, boot_m, seconds):
    tr = np.asarray(scene.i_train)
    m = (boot.masks[tr] > 0) & (scene.depths[tr] > 0)
    prior = (float(np.mean((boot.depths[tr][m] - scene.depths[tr][m]) ** 2))
             if m.any() else float("nan"))
    (w_d, w_p), (b_d, b_p) = warm_m, boot_m
    print(f"seed {seed}: masks {float(boot.masks[tr].mean()):.4f}, prior "
          f"depth-MSE {prior:.4f}; warmup held-out depth-MSE {w_d:.4f} "
          f"PSNR {w_p:.2f}; retrain {b_d:.4f} / {b_p:.2f} (depth x"
          f"{b_d / w_d:.2f}, PSNR {b_p - w_p:+.2f} dB); bounds: depth "
          f"{b_d < 1.3 * w_d}, PSNR {b_p > w_p - 2.5}; {seconds:.1f} s",
          flush=True)


def _metrics(depth, rgb, scene, vid):
    gt = scene.depths[vid]
    sel = gt > 0
    pred = np.clip(rgb, 0, 1)
    return (float(np.mean((depth[sel] - gt[sel]) ** 2)),
            float(-10 * np.log10(np.mean((pred - scene.images[vid]) ** 2))))


def run_port(seeds, device):
    import torch

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.train import bootstrap, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    dev = torch.device(device)
    if dev.type == "cuda":
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()

    def heldout(model, cfg):
        render = render_lib.build_render_fn(model.eval(), cfg)
        vals = []
        for vid in scene.i_test:
            out = render(camera_rays_for_view(scene, scene.poses[vid],
                                              device=dev))
            vals.append(_metrics(out["depth"].cpu().numpy(),
                                 out["rgb"].cpu().numpy(), scene, vid))
        return tuple(np.mean(vals, 0))

    for seed in seeds:
        t0 = time.perf_counter()
        cfg = configs.Config(**CFG, seed=seed, basedir=tempfile.mkdtemp(),
                             expname="boot")
        boot, warm = bootstrap.bootstrap_scene_priors(
            cfg, scene, STEPS, log_fn=lambda s: None, device=dev)
        warm_m = heldout(warm.state.model,
                         bootstrap.warmup_config(cfg, STEPS))
        res = loop.train(cfg, boot, num_steps=STEPS, device=dev,
                         log_fn=lambda s: None)
        _summary(seed, scene, boot, warm_m, heldout(res.state.model, cfg),
                 time.perf_counter() - t0)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def run_jax(seeds):
    jax = _jax()
    from consistentnerf_tpu.configs import Config
    from consistentnerf_tpu.data import synthetic
    from consistentnerf_tpu.models.factory import make_model
    from consistentnerf_tpu.train import loop as loop_lib
    from consistentnerf_tpu.train import render as render_lib
    from consistentnerf_tpu.train.bootstrap import (bootstrap_scene_priors,
                                                    warmup_config)
    from consistentnerf_tpu.train.evaluation import camera_rays_for_view

    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()

    def heldout(model, cfg, params):
        render = render_lib.build_render_fn(model, cfg, params)
        vals = []
        for vid in scene.i_test:
            out = render(camera_rays_for_view(scene, scene.poses[vid]))
            vals.append(_metrics(np.asarray(out["depth"]),
                                 np.asarray(out["rgb"]), scene, vid))
        return tuple(np.mean(vals, 0))

    for seed in seeds:
        t0 = time.perf_counter()
        cfg = Config(**CFG, seed=seed, basedir=tempfile.mkdtemp(),
                     expname="boot", use_tensorboard=False)
        boot, warm = bootstrap_scene_priors(cfg, scene, STEPS,
                                            log_fn=lambda s: None,
                                            use_prefetch=False)
        model = make_model(cfg)
        warm_m = heldout(model, warmup_config(cfg, STEPS),
                         jax.device_get(warm.state).params)
        res = loop_lib.train(cfg, boot, num_steps=STEPS, use_prefetch=False,
                             log_fn=lambda s: None)
        _summary(seed, scene, boot, warm_m,
                 heldout(model, cfg, jax.device_get(res.state).params),
                 time.perf_counter() - t0)


def jax_flow(steps, kw=None, init=None, retrain=True):
    """The JAX package's bootstrap flow on the sphere, stage by stage,
    with its own step functions (`init_state`, `make_batcher`,
    `select_train_step`, then the step applied `steps` times a stage, as
    its `loop.train` applies it): the warmup on the prior-free scene,
    its depths rendered, fused and masked, then (with `retrain`) the
    retrain on them. `init`, a port state_dict (`port_init`), replaces
    the JAX package's own init: the params tree takes its structure from
    `jax.eval_shape` of the model's init, so the init is never computed.
    Returns the init (both stages start from it: one seed, one model),
    each stage's losses and held-out (depth-MSE, PSNR), the fused priors
    and the masks."""
    jax = _jax()
    from consistentnerf_tpu.configs import Config
    from consistentnerf_tpu.consistency import reproject
    from consistentnerf_tpu.data import synthetic
    from consistentnerf_tpu.models.factory import make_model
    from consistentnerf_tpu.parallel import create_mesh, shard_batch
    from consistentnerf_tpu.train import bootstrap
    from consistentnerf_tpu.train import loop as loop_lib
    from consistentnerf_tpu.train import render as render_lib
    from consistentnerf_tpu.train import step as step_lib
    from consistentnerf_tpu.train.evaluation import camera_rays_for_view
    from consistentnerf_tpu.train.state import create_train_state

    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    cfg = Config(**(kw or dict(CFG, perturb=0.0)), use_tensorboard=False)
    out = {}

    def train(cfg_, scene_, stage):
        model = make_model(cfg_)
        mesh = create_mesh(cfg_.mesh_shape, cfg_.mesh_axis_names)
        batcher = loop_lib.make_batcher(scene_, cfg_)
        example = batcher.next_batch()
        if init is None:
            state = loop_lib.init_state(cfg_, model, example)
        else:
            rays = step_lib.rays_from_batch(example, cfg_.near, cfg_.far)
            shapes = jax.eval_shape(
                model.init, jax.random.PRNGKey(cfg_.seed), None,
                jax.tree_util.tree_map(lambda x: x[:8], rays))
            state = create_train_state(cfg_, jax.tree_util.tree_map(
                jax.numpy.asarray, _jax_params(shapes, init)))
        # The step returns its state replicated over the mesh; a first
        # state placed the same way keeps it from compiling twice.
        state = jax.device_put(state, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec()))
        params0 = jax.tree_util.tree_map(np.asarray,
                                         jax.device_get(state.params))
        if not all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(out.setdefault("init", params0)),
                jax.tree_util.tree_leaves(params0))):
            raise AssertionError("the retrain starts from another init")
        step = loop_lib.select_train_step(cfg_, model, mesh=mesh)
        rng = jax.random.PRNGKey(cfg_.seed)
        losses = []
        for _ in range(steps):
            state, stats = step(state, shard_batch(batcher.next_batch(),
                                                   mesh), rng)
            losses.append(stats["loss"])
        out[stage + "_losses"] = [float(x) for x in jax.device_get(losses)]
        params = jax.device_get(state.params)
        render = render_lib.build_render_fn(model, cfg_, params)
        vals = []
        for vid in scene.i_test:
            r = render(camera_rays_for_view(scene, scene.poses[vid]))
            vals.append(_metrics(np.asarray(r["depth"]),
                                 np.asarray(r["rgb"]), scene, vid))
        out[stage] = tuple(np.mean(vals, 0))
        return params

    warm_cfg = bootstrap.warmup_config(cfg, steps)
    shape = scene.images.shape[:3]
    params = train(warm_cfg, dataclasses.replace(
        scene, depths=np.zeros(shape, np.float32),
        masks=np.ones(shape, np.float32)), "warmup")
    depths = bootstrap.render_warmup_depths(warm_cfg, scene, params)
    depths = reproject.fuse_depth_priors(
        scene.poses, depths, scene.K, scene.i_train, scene.H, scene.W,
        threshold=cfg.occlusion_threshold,
        min_consensus=cfg.bootstrap_fuse_min_consensus)
    masks = np.asarray(reproject.compute_hard_masks(
        scene.poses, depths, scene.K, scene.i_train, scene.H, scene.W,
        occlusion_threshold=cfg.occlusion_threshold), np.float32)
    out.update(priors=np.asarray(depths), masks=masks)
    if retrain:
        train(cfg, dataclasses.replace(scene, depths=depths, masks=masks,
                                       depth_is_gt=False), "retrain")
    return out


def _jax_params(template, sd):
    """The port state_dict `sd` in the JAX params tree `template`'s
    structure (torch [out, in] weights to flax [in, out] kernels)."""
    import flax

    from consistentnerf_tpu_torch import interop

    params = flax.core.unfreeze(template)
    for level, sub in params["params"].items():
        names = {v: k for k, v in interop.LINEAR_NAMES.items()}
        for name, entry in sub.items():
            if not isinstance(entry, dict):
                sub[name] = np.asarray(sd[f"{level}.{name}"]).reshape(
                    entry.shape)
                continue
            torch_name = (f"pts_linears.{name[4:]}" if name.startswith("pts_")
                          else names[name])
            entry["kernel"] = np.asarray(sd[f"{level}.{torch_name}.weight"]).T
            entry["bias"] = np.asarray(sd[f"{level}.{torch_name}.bias"])
    return (flax.core.freeze(params)
            if isinstance(template, flax.core.FrozenDict) else params)


def port_init(kw):
    """The port's seeded init of the config `kw` (coarse copied from fine,
    as its loop starts), as a numpy state_dict."""
    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.train import loop

    model = loop.init_state(configs.Config(**kw), "cpu").model
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def carried_init(params):
    """Every model the port's loop makes starts from the JAX params."""
    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.train import loop

    real = loop.make_model

    def make(cfg, device="cuda"):
        model = real(cfg, device)
        model.load_state_dict(interop.params_from_jax(params))
        return model

    loop.make_model = make
    try:
        yield
    finally:
        loop.make_model = real


def port_flow(steps, init=None, kw=None, device="cpu", retrain_on=None,
              retrain=True):
    """The port's bootstrap flow (`bootstrap_scene_priors`, then with
    `retrain` the retrain's `loop.train`) from the JAX params `init` (or
    the port's own init), with the same outputs as `jax_flow`. With
    `retrain_on` = (priors, masks), the retrain runs on those in place of
    the port's own."""
    import torch

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.train import bootstrap, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    dev = torch.device(device)
    scene = synthetic.make_scene(n_views=6, H=48, W=48).to_scene_data()
    cfg = configs.Config(**dict(kw or dict(CFG, perturb=0.0), i_print=1),
                         basedir=tempfile.mkdtemp(), expname="p")
    out = {}

    def heldout(model, cfg_):
        render = render_lib.build_render_fn(model.eval(), cfg_)
        vals = []
        for vid in scene.i_test:
            r = render(camera_rays_for_view(scene, scene.poses[vid],
                                            device=dev))
            vals.append(_metrics(r["depth"].cpu().numpy(),
                                 r["rgb"].cpu().numpy(), scene, vid))
        return tuple(np.mean(vals, 0))

    stages = []
    with (carried_init(init) if init is not None
          else contextlib.nullcontext()):
        boot, warm = bootstrap.bootstrap_scene_priors(
            cfg, scene, steps, log_fn=lambda s: None, device=dev)
        stages.append(("warmup", warm, bootstrap.warmup_config(cfg, steps)))
        if retrain:
            scene_ = boot if retrain_on is None else dataclasses.replace(
                boot, depths=retrain_on[0], masks=retrain_on[1])
            stages.append(("retrain", loop.train(
                cfg, scene_, num_steps=steps, device=dev,
                log_fn=lambda s: None), cfg))
    for stage, r, c in stages:
        out[stage + "_losses"] = [float(h["loss"]) for h in r.stats_history]
        out[stage] = heldout(r.state.model, c)
    out.update(priors=boot.depths, masks=boot.masks,
               i_train=np.asarray(scene.i_train))
    return out


def _compare(stage, j, p):
    lj, lp = j[stage + "_losses"], p[stage + "_losses"]
    rel = [abs(a - b) / abs(a) for a, b in zip(lj, lp)]
    first = next((i + 1 for i, r in enumerate(rel) if r > 1e-3), None)
    print(f"{stage}: {len(rel)} steps, largest relative loss difference "
          f"{max(rel):.2e} at step {int(np.argmax(rel)) + 1}, first above "
          f"1e-3 at step {first}; held-out depth-MSE / PSNR jax "
          f"{j[stage][0]:.5f} / {j[stage][1]:.3f}, port {p[stage][0]:.5f} / "
          f"{p[stage][1]:.3f}", flush=True)


def run_trajectory(steps):
    j = jax_flow(steps)
    p = port_flow(steps, j["init"])
    for stage in ("warmup", "retrain"):
        lj, lp = j[stage + "_losses"], p[stage + "_losses"]
        for i in range(0, len(lj), max(1, len(lj) // 10)):
            print(f"{stage} step {i + 1}: loss jax {lj[i]:.6f} port "
                  f"{lp[i]:.6f}")
        _compare(stage, j, p)
    tr = p["i_train"]
    pj, pp = j["priors"][tr], p["priors"][tr]
    both = (pj > 0) & (pp > 0)
    print(f"priors: largest difference where both keep a pixel "
          f"{float(np.abs(pj - pp)[both].max()):.2e}, kept by one only at "
          f"{float(((pj > 0) != (pp > 0)).mean()):.4f}, masks differ at "
          f"{float((j['masks'] != p['masks'])[tr].mean()):.4f} of the train "
          "views' pixels", flush=True)
    print("the port's retrain on the JAX priors and masks:")
    _compare("retrain", j, port_flow(steps, j["init"],
                                     retrain_on=(j["priors"], j["masks"])))


def run_crossed(seeds):
    for seed in seeds:
        t0 = time.perf_counter()
        kw = dict(CFG, seed=seed)
        j_init = jax_flow(STEPS, kw, retrain=False)
        p_init = port_init(kw)
        rows = [
            ("JAX init: jax", j_init["warmup"]),
            ("port", port_flow(STEPS, j_init["init"], kw,
                               retrain=False)["warmup"]),
            ("port init: jax", jax_flow(STEPS, kw, init=p_init,
                                        retrain=False)["warmup"]),
            ("port", port_flow(STEPS, None, kw, retrain=False)["warmup"]),
        ]
        print(f"seed {seed} warmup held-out depth-MSE / PSNR: " + "; ".join(
            f"{k} {d:.4f} / {p_:.2f}" for k, (d, p_) in rows)
            + f"; {time.perf_counter() - t0:.1f} s", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=["port", "jax", "trajectory",
                                    "crossed"])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args()
    if args.mode == "port":
        run_port(args.seeds, args.device)
    elif args.mode == "jax":
        run_jax(args.seeds)
    elif args.mode == "crossed":
        run_crossed(args.seeds)
    else:
        run_trajectory(args.steps)


if __name__ == "__main__":
    main()
