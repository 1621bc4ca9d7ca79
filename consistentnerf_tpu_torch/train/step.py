"""The train steps in eager PyTorch: forward of every level through the
model (`VanillaNeRF.forward`, `MipNeRF.forward`), the losses, autograd,
gradient conditioning and the Adam update. They are the CPU path and the
twins the kernel steps (`ops/fused_onepass.py`) are held against.

Random draws are tensors. Vanilla (`make_draws`): `t_rand`
[N, N_samples] jitters the coarse depths, `u` [N, N_importance] drives
the fine inverse CDF (ascending order statistics with `use_pdf_kernel`,
which kernel #8 needs; the fine depths are the same set in distribution),
`noise_c` [N, N_samples] / `noise_f` [N, N_samples+N_importance] the
density noise's standard normals where it applies (`raw_noise_std > 0`
and `perturb > 0`, `has_raw_noise`), `noise` holds the standard normals
of `use_noise`, and with `ss_loss` `ss` holds the gate of the main RGB
loss and the reference rays' `t_rand` / `u` (and `noise_c` /
`noise_f`). Mip (`make_mip_draws`, when
`randomized`): `t_rand` [N, S+1] jitters the first level's fenceposts,
`jitter[l]` drives level l's resampling and `noise[l]` [N, S] holds the
density noise's standard normals; `random` holds the same draws for the random-pose rays of the
TV norm (`make_mip_step_draws`). A step makes them from
`step_generator(cfg.seed, step)` unless the caller passes its own, so a
resumed run draws what an uninterrupted one would.

Under a mesh (`parallel/mesh.py`; the `mesh` argument of the
`build_*_train_step` functions) every rank takes the same global batch
and makes the same global draws, runs the model on its rows of both
(`shard_step`), gathers the outputs and computes the loss of the global
batch; `finish_step` sums the gradients over the data axis. Without one
the step is the single-process step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_mod
from consistentnerf_tpu_torch.core import mathx, sampling
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.ops import pdf_merge
from consistentnerf_tpu_torch.parallel import mesh as mesh_lib
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


def has_raw_noise(cfg) -> bool:
    """Whether a vanilla train step adds density noise: raw_noise_std > 0,
    and perturb > 0, where the JAX step hands the model an rng
    (train/step.py:126-127; the model draws the noise only with one)."""
    return cfg.raw_noise_std > 0 and cfg.perturb > 0


def _level_draws(cfg, n: int, generator: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """The sampling draws of n rays' two levels and their density-noise
    normals (none at perturb 0)."""
    draws: Dict[str, torch.Tensor] = {}
    if cfg.perturb > 0:
        draws["t_rand"] = torch.rand((n, cfg.N_samples),
                                     generator=generator, device=device)
        if cfg.N_importance > 0 and cfg.use_pdf_kernel:
            draws["u"] = pdf_merge.sorted_uniform(torch.rand(
                (n, cfg.N_importance + 1), generator=generator,
                device=device))
        elif cfg.N_importance > 0:
            draws["u"] = torch.rand((n, cfg.N_importance),
                                    generator=generator, device=device)
    if has_raw_noise(cfg):
        draws["noise_c"] = torch.randn((n, cfg.N_samples),
                                       generator=generator, device=device)
        if cfg.N_importance > 0:
            draws["noise_f"] = torch.randn(
                (n, cfg.N_samples + cfg.N_importance), generator=generator,
                device=device)
    return draws


def model_draws(draws: Dict) -> Dict[str, Optional[torch.Tensor]]:
    """The keyword arguments of `VanillaNeRF.forward` in `draws`."""
    return {k: draws.get(k) for k in ("t_rand", "u", "noise_c", "noise_f")}


def make_draws(cfg, n: int, generator: torch.Generator,
               device) -> Dict[str, object]:
    """One step's random draws for n rays. With `ss_loss`, after the
    others: `ss` = {'gate': the bool that gates the main RGB loss, and
    the reference rays' `t_rand` / `u`}."""
    draws: Dict[str, object] = _level_draws(cfg, n, generator, device)
    if cfg.use_noise:
        draws["noise"] = {
            k: torch.randn(shape, generator=generator, device=device)
            for k, shape in (("rgb", (n, 3)), ("depth", (n,)),
                             ("rgb0", (n, 3)), ("depth0", (n,)))}
    if cfg.ss_loss:
        gate = torch.rand((), generator=generator, device=device) < 0.5
        draws["ss"] = {"gate": gate,
                       **_level_draws(cfg, n, generator, device)}
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


def renders_random(cfg, batch) -> bool:
    """Whether a mip step renders the batch's random-pose rays: the TV
    norm is on and the batcher made them (train/step.py:186-188)."""
    return ((cfg.depth_tvnorm_loss_mult != 0.0 or cfg.depth_tvnorm_decay)
            and "rays_random" in batch)


def tvnorm_weight(cfg, step: int) -> float:
    """The TV norm's weight at this step: annealed with
    depth_tvnorm_decay, else depth_tvnorm_loss_mult."""
    if cfg.depth_tvnorm_decay:
        return float(mathx.compute_tvnorm_weight(
            step, cfg.depth_tvnorm_maxstep, cfg.depth_tvnorm_loss_mult_start,
            cfg.depth_tvnorm_loss_mult_end))
    return cfg.depth_tvnorm_loss_mult


def make_mip_step_draws(cfg, batch, generator: torch.Generator,
                        device) -> Dict[str, object]:
    """A mip step's draws: those of the batch's rays, then (when the step
    renders them) those of its random-pose rays under `random`."""
    draws = make_mip_draws(cfg, batch["rays"].origins.shape[0], generator,
                           device)
    if draws and renders_random(cfg, batch):
        draws["random"] = make_mip_draws(
            cfg, batch["rays_random"].origins.shape[0], generator, device)
    return draws


def slice_draws(draws: Dict, sl) -> Dict:
    """The draws of the rays `sl` (a slice of the batch); the random-pose
    rays' draws are not the batch's and are left out."""
    out = {}
    for k, v in draws.items():
        if k == "random":
            continue
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


def has_ss(cfg, batch) -> bool:
    """Whether a vanilla step adds the ss_loss term: on, and the batch
    carries a reference view (the `use_batching` batches do not)."""
    return bool(cfg.ss_loss) and "ref_image" in batch


def apply_ss_loss(apply_fn, batch, cfg, outputs, loss, stats,
                  ss_draws: Dict):
    """Fold the online-reprojection ss_loss term into (loss, stats)
    (the JAX package's `apply_ss_loss`, run_nerf_view_test.py:944-967).

    `apply_fn(rays, draws)` renders the reference rays (the eager model,
    or a kernel step's differentiable forward) with `ss_draws`' `t_rand`
    / `u`. `ss_draws['gate']` (the reference's random.randint(0, 1))
    swaps the fine RGB term for its consistency-masked variant; the
    coarse term is not gated."""
    from consistentnerf_tpu_torch.consistency import online

    ss, aux = online.online_reprojection_loss(apply_fn, batch, cfg,
                                              ss_draws)
    gated = mask_mod.masked_mse(outputs["rgb"], batch["rgb"],
                                aux["consistency_weight"])
    scale = batch.get("loss_scale", 1.0)
    loss = (loss - scale * stats["img_loss"]
            + scale * torch.where(ss_draws["gate"], gated,
                                  stats["img_loss"])
            + cfg.ss_loss_mult * ss)
    stats["ss_loss"] = ss
    stats["loss"] = loss
    return loss, stats


def check_kernel_step(cfg) -> None:
    """The kernel steps compute no density noise: a config whose eager
    step adds it is refused (`train/loop.py::select_train_step` sends
    it to the eager step)."""
    if has_raw_noise(cfg):
        raise ValueError(
            f"raw_noise_std={cfg.raw_noise_std} at perturb {cfg.perturb}: "
            "the kernel steps add no density noise (the model adds it); "
            "train it on the eager step")


def shard_step(batch, draws: Dict, mesh, n: int):
    """(this rank's rows of the batch, of the draws, their slice) for a
    global batch of n rays; the whole batch without a mesh."""
    sl = mesh_lib.data_slice(n, mesh)
    return (mesh_lib.shard_batch(batch, mesh),
            mesh_lib.shard_tree(draws, n, sl), sl)


def sharded_apply(apply_fn: Callable, mesh, n: int) -> Callable:
    """apply_fn(rays, draws) on this rank's rows of n global rays, its
    outputs gathered: the ss_loss term's reference rays under a mesh."""
    if mesh is None or not mesh.active:
        return apply_fn
    sl = mesh_lib.data_slice(n, mesh)

    def apply(rays, draws):
        out = apply_fn(rays.map(lambda x: x[sl]),
                       mesh_lib.shard_tree(draws, n, sl))
        return mesh_lib.gather_outputs(out, mesh, sl.stop - sl.start)

    return apply


def finish_step(state: TrainState, stats: Dict, cfg, mesh=None) -> Dict:
    """Grad-norm and lr stats, the optimizer update, the step increment.
    The `.grad`s hold this rank's part of the step's gradients; under a
    mesh they are summed over the data axis here, once a step."""
    opt = state.optimizer
    mesh_lib.reduce_grads(opt.params, mesh)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in opt.params]
    stats["grad_norm"] = losses_lib.tree_norm(grads)
    stats["lr"] = opt.schedule(state.step)
    opt.step(state.step)
    opt.zero_grad()
    state.step += 1
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in stats.items()}


def build_vanilla_train_step(model, cfg, lpips_params=None,
                             mesh=None) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats). `batch`
    holds tensors on the model's device (the global batch under a mesh);
    `state` (whose module is `model`) is updated in place."""

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None):
        n, device = batch["rgb"].shape[0], batch["rgb"].device
        if draws is None:
            draws = make_draws(cfg, n, step_generator(cfg.seed, state.step,
                                                      device), device)
        local, d_loc, sl = shard_step(batch, draws, mesh, n)
        rays = rays_from_batch(local, cfg.near, cfg.far)
        temp = mask_mod.temp_schedule(state.step, cfg.total_iters,
                                      cfg.temp_start, cfg.temp_end)
        state.optimizer.zero_grad()
        outputs = state.model(rays, **model_draws(d_loc))
        if cfg.use_noise:
            outputs = apply_output_noise(outputs, cfg, d_loc["noise"])
        outputs = mesh_lib.gather_outputs(outputs, mesh, sl.stop - sl.start)
        loss, stats = losses_lib.vanilla_losses(outputs, batch, cfg, cfg.far,
                                                temp, lpips_params)
        if has_ss(cfg, batch):
            def apply_fn(rays_, d):
                return state.model(rays_, **model_draws(d))

            loss, stats = apply_ss_loss(sharded_apply(apply_fn, mesh, n),
                                        batch, cfg, outputs, loss, stats,
                                        draws["ss"])
        loss.backward()
        return state, finish_step(state, stats, cfg, mesh)

    return train_step


def resample_padding(cfg, step: int) -> float:
    """The annealed blurpool padding of this step (train/step.py)."""
    return mathx.log_lerp(step / cfg.total_iters, cfg.resample_padding_init,
                          cfg.resample_padding_final)


def build_mip_train_step(model, cfg, mesh=None) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats) of the mip
    backbone (RegNeRF/train.py:97-241 through `mip_losses`), with the TV
    norm on the batch's random-pose rays (`rays_random`) when it is on.
    `batch` holds `Rays` bundles and tensors on the model's device;
    `state` (whose module is `model`) is updated in place. With
    `disable_normals=false` the model computes the normals too (no loss
    reads them); `compute_normal_metrics` or `compute_disp_metrics` ask
    it for the extras, as the JAX step does (train/step.py:195-196)."""

    def train_step(state: TrainState, batch, draws: Optional[Dict] = None):
        n, device = batch["rgb"].shape[0], batch["rgb"].device
        if draws is None:
            draws = make_mip_step_draws(cfg, batch, step_generator(
                cfg.seed, state.step, device), device)
        local, d_loc, sl = shard_step(batch, draws, mesh, n)
        padding = resample_padding(cfg, state.step)
        state.optimizer.zero_grad()
        renderings = mesh_lib.gather_outputs(state.model(
            local["rays"], d_loc, resample_padding=padding,
            compute_extras=(cfg.compute_disp_metrics
                            or cfg.compute_normal_metrics)), mesh,
            sl.stop - sl.start)
        renderings_random = None
        if renders_random(cfg, batch):
            def apply_fn(rays_, d):
                return state.model(rays_, d, resample_padding=padding,
                                   compute_extras=True)

            renderings_random = sharded_apply(
                apply_fn, mesh, batch["rays_random"].origins.shape[0])(
                batch["rays_random"], draws.get("random"))
        # The weight decay reads the parameters themselves: every rank
        # computes it, and its gradient is added once.
        loss, stats = losses_lib.mip_losses(
            renderings, renderings_random, batch,
            mesh_lib.once(list(state.model.parameters()), mesh), cfg,
            tvnorm_weight(cfg, state.step))
        loss.backward()
        return state, finish_step(state, stats, cfg, mesh)

    return train_step


def build_train_step(model, cfg, mesh=None, **kw) -> Callable:
    """The eager step of the configured backbone."""
    if cfg.backbone == "vanilla":
        return build_vanilla_train_step(model, cfg, mesh=mesh, **kw)
    return build_mip_train_step(model, cfg, mesh=mesh)
