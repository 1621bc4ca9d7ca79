"""The train steps in eager PyTorch: forward of every level through the
model (`VanillaNeRF.forward`, `MipNeRF.forward`), the losses, autograd,
gradient conditioning and the Adam update. They are the CPU path and the
twins the kernel steps (`ops/fused_onepass.py`) are held against.

Random draws are tensors. Vanilla (`make_draws`): `t_rand`
[N, N_samples] jitters the coarse depths, `u` [N, N_importance] drives
the fine inverse CDF and `noise` holds the standard normals of
`use_noise`. Mip (`make_mip_draws`, when `randomized`): `t_rand`
[N, S+1] jitters the first level's fenceposts, `jitter[l]` drives level
l's resampling and `noise[l]` [N, S] holds the density noise's standard
normals. A step makes them from `step_generator(cfg.seed, step)` unless
the caller passes its own, so a resumed run draws what an uninterrupted
one would.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_mod
from consistentnerf_tpu_torch.core import mathx, sampling
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.train import losses as losses_lib
from consistentnerf_tpu_torch.train.state import TrainState

NOISE_STD = 0.05


def rays_from_batch(batch: Dict[str, torch.Tensor], near, far) -> Rays:
    """A Rays bundle from flat batch tensors."""
    d = batch["directions"]
    ones = torch.ones_like(d[..., :1])
    viewdirs = batch.get("viewdirs")
    if viewdirs is None:
        viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    radii = batch.get("radii")
    return Rays(origins=batch["origins"], directions=d, viewdirs=viewdirs,
                radii=ones * 1e-3 if radii is None else radii,
                lossmult=ones, near=ones * near, far=ones * far)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2**63))
    return g


def make_draws(cfg, n: int, generator: torch.Generator,
               device) -> Dict[str, object]:
    """One step's random draws for n rays."""
    draws: Dict[str, object] = {}
    if cfg.perturb > 0:
        draws["t_rand"] = torch.rand((n, cfg.N_samples),
                                     generator=generator, device=device)
        if cfg.N_importance > 0:
            draws["u"] = torch.rand((n, cfg.N_importance),
                                    generator=generator, device=device)
    if cfg.use_noise:
        draws["noise"] = {
            k: torch.randn(shape, generator=generator, device=device)
            for k, shape in (("rgb", (n, 3)), ("depth", (n,)),
                             ("rgb0", (n, 3)), ("depth0", (n,)))}
    return draws


def make_mip_draws(cfg, n: int, generator: torch.Generator,
                   device) -> Dict[str, object]:
    """One mip step's random draws for n rays (none unless
    `cfg.randomized`)."""
    if not cfg.randomized:
        return {}
    s, levels = cfg.mip_num_samples, cfg.mip_num_levels
    d = 1 if cfg.single_jitter else s + 1
    draws: Dict[str, object] = {
        "t_rand": torch.rand((n, d), generator=generator, device=device),
        "jitter": [None] + [
            sampling.jitter_draws(generator, (n,), s + 1, cfg.single_jitter,
                                  device) for _ in range(1, levels)],
    }
    if cfg.density_noise > 0:
        draws["noise"] = [torch.randn((n, s), generator=generator,
                                      device=device) for _ in range(levels)]
    return draws


def slice_draws(draws: Dict, sl) -> Dict:
    """The draws of the rays `sl` (a slice of the batch)."""
    out = {}
    for k, v in draws.items():
        out[k] = ([None if x is None else x[sl] for x in v]
                  if isinstance(v, list) else v[sl])
    return out


def apply_output_noise(outputs, cfg, noise: Dict[str, torch.Tensor]):
    """Gaussian noise on predictions before the losses
    (run_nerf_view.py:1633-1638): std 0.05 on rgb, far * 0.05 on depth;
    `noise` holds the standard normals."""
    outputs = dict(outputs)
    outputs["rgb"] = outputs["rgb"] + NOISE_STD * noise["rgb"]
    outputs["depth"] = outputs["depth"] + cfg.far * NOISE_STD * noise["depth"]
    if "rgb0" in outputs:
        outputs["rgb0"] = outputs["rgb0"] + NOISE_STD * noise["rgb0"]
        outputs["depth0"] = (outputs["depth0"]
                             + cfg.far * NOISE_STD * noise["depth0"])
    return outputs


def apply_ss_loss(*args, **kwargs):
    raise NotImplementedError(
        "the online-reprojection ss_loss is not ported yet (ROADMAP Queue 1: "
        "consistency)")


def check_supported(cfg) -> None:
    """Options of the vanilla step that this package does not run yet."""
    if cfg.ss_loss:
        apply_ss_loss()
    if cfg.raw_noise_std > 0:
        raise NotImplementedError(
            "raw_noise_std > 0 is not ported yet (ROADMAP Queue 1: raw "
            "noise)")


def finish_step(state: TrainState, stats: Dict, cfg) -> Dict:
    """Grad-norm and lr stats, the optimizer update, the step increment.
    The `.grad`s hold the step's gradients."""
    opt = state.optimizer
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in opt.params]
    stats["grad_norm"] = losses_lib.tree_norm(grads)
    stats["lr"] = opt.schedule(state.step)
    opt.step(state.step)
    opt.zero_grad()
    state.step += 1
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in stats.items()}


def build_vanilla_train_step(model, cfg,
                             lpips_params=None) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats). `batch`
    holds tensors on the model's device; `state` (whose module is
    `model`) is updated in place."""
    check_supported(cfg)

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None):
        rays = rays_from_batch(batch, cfg.near, cfg.far)
        n, device = rays.origins.shape[0], rays.origins.device
        if draws is None:
            draws = make_draws(cfg, n, step_generator(cfg.seed, state.step,
                                                      device), device)
        temp = mask_mod.temp_schedule(state.step, cfg.total_iters,
                                      cfg.temp_start, cfg.temp_end)
        state.optimizer.zero_grad()
        outputs = state.model(rays, t_rand=draws.get("t_rand"),
                              u=draws.get("u"))
        if cfg.use_noise:
            outputs = apply_output_noise(outputs, cfg, draws["noise"])
        loss, stats = losses_lib.vanilla_losses(outputs, batch, cfg, cfg.far,
                                                temp, lpips_params)
        loss.backward()
        return state, finish_step(state, stats, cfg)

    return train_step


def check_mip_supported(cfg) -> None:
    """Options of the mip step that this package does not run yet."""
    losses_lib.check_mip_regularizers(cfg)
    if cfg.load_random_rays or cfg.anneal_nearfar:
        raise NotImplementedError(
            "random-pose rays and anneal_nearfar are not ported yet "
            "(ROADMAP Queue 1: mip regularizers)")
    if not cfg.disable_normals or cfg.compute_normal_metrics:
        raise NotImplementedError(
            "mip normals are not ported yet (ROADMAP Queue 1: mip normals)")


def resample_padding(cfg, step: int) -> float:
    """The annealed blurpool padding of this step (train/step.py)."""
    return mathx.log_lerp(step / cfg.total_iters, cfg.resample_padding_init,
                          cfg.resample_padding_final)


def build_mip_train_step(model, cfg) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats) of the mip
    backbone (RegNeRF/train.py:97-241 through `mip_losses`). `batch`
    holds a `Rays` bundle under 'rays' and tensors on the model's device;
    `state` (whose module is `model`) is updated in place."""
    check_mip_supported(cfg)

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None):
        rays = batch["rays"]
        n, device = rays.origins.shape[0], rays.origins.device
        if draws is None:
            draws = make_mip_draws(cfg, n, step_generator(
                cfg.seed, state.step, device), device)
        state.optimizer.zero_grad()
        renderings = state.model(
            rays, draws, resample_padding=resample_padding(cfg, state.step),
            compute_extras=cfg.compute_disp_metrics)
        loss, stats = losses_lib.mip_losses(renderings, None, batch,
                                            state.model.parameters(), cfg)
        loss.backward()
        return state, finish_step(state, stats, cfg)

    return train_step


def build_train_step(model, cfg, **kw) -> Callable:
    """The eager step of the configured backbone."""
    if cfg.backbone == "vanilla":
        return build_vanilla_train_step(model, cfg, **kw)
    return build_mip_train_step(model, cfg)
