"""Training harness of both trainers: setup, the step dispatch, the loop,
logging and checkpoints, and the loop's housekeeping as the JAX package
has it (`train/loop.py:113-268`): the threaded prefetch, TensorBoard
scalars, a `torch.profiler` trace of `profile_steps` steps, `gc` pinned
with a collection every `gc_every` steps, and a held-out render every
`train_render_every` steps. Throughput is logged as rays/sec like the
reference (`train.py:416-419`).

Over several ranks (`parallel/mesh.py`; the JAX loop's mesh, l.127-231)
every rank makes the same global batches and draws, the step computes
its rows and the global loss, rank 0's initial or restored state is
broadcast once, and rank 0 alone logs, writes TensorBoard, renders the
held-out view, traces and saves checkpoints (the others wait at a
barrier after each save).
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from consistentnerf_tpu_torch.data.pipeline import (AllImagesBatcher,
                                                    MipBatcher,
                                                    Prefetcher,
                                                    VanillaBatcher,
                                                    to_device)
from consistentnerf_tpu_torch.data.scene import SceneData
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.parallel import mesh as mesh_lib
from consistentnerf_tpu_torch.train import step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
from consistentnerf_tpu_torch.train.state import (create_train_state,
                                                  sync_coarse_from_fine)


@dataclasses.dataclass
class TrainResult:
    state: object
    stats_history: list
    rays_per_sec: float
    metrics: Optional[dict] = None  # the test-set eval (cli/train.py)


def make_batcher(scene: SceneData, cfg, random_poses=None):
    if cfg.backbone == "mipnerf":
        return MipBatcher(scene, cfg, random_poses=random_poses)
    if cfg.use_batching:
        return AllImagesBatcher(scene, cfg)
    return VanillaBatcher(scene, cfg)


def init_state(cfg, device="cuda"):
    """Seeded model (vanilla: coarse copied from fine, the vanilla
    trainer's quirk; mip: one MLP, nothing to copy) and its optimizer."""
    model = make_model(cfg, device)
    if cfg.backbone == "vanilla":
        sync_coarse_from_fine(model)
    return create_train_state(cfg, model)


def select_train_step(cfg, model, lpips_params=None, mesh=None):
    """The production step dispatch (the JAX package's loop.py:68-111):
    with use_fused_train, the one-pass kernel step where the config's
    exact loss is supported (`onepass_supported`,
    `mip_onepass_supported`), else the two-call fused step
    (`ops/fused_train.py`); the eager step when use_fused_train is off.
    Where the heads read [pe | h] (netdepth 5) only the v1 kernels take
    them: the dispatch warns and trains a v2 kind on the eager step and a
    v1 kind on its two-call step instead of the one-pass kernel. The
    kernel steps add no density noise (the JAX package's ignore
    raw_noise_std; its eager step adds it): a config whose eager step
    adds it trains on the eager step, with a warning. `mesh`: the run's
    `parallel.mesh.Mesh` (every step takes the global batch and computes
    its rows; None: a single process)."""
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train

    kw = dict(lpips_params=lpips_params, mesh=mesh)
    if cfg.backbone == "mipnerf":
        return _select_mip_train_step(cfg, model, mesh)
    if not cfg.use_fused_train:
        return step_lib.build_vanilla_train_step(model, cfg, **kw)
    if step_lib.has_raw_noise(cfg):
        warnings.warn(
            f"use_fused_train with raw_noise_std={cfg.raw_noise_std} at "
            f"perturb {cfg.perturb}: the model adds density noise, which "
            "the kernel steps do not compute; training on the eager step",
            stacklevel=2)
        return step_lib.build_vanilla_train_step(model, cfg, **kw)
    onepass = cfg.use_onepass_train and fused_onepass.onepass_supported(cfg)
    if fused_onepass.heads_read_pe(cfg.netdepth):
        # The port's own gate: only the v1 kernels take the widened heads
        # (the JAX package's v2 and one-pass kernels fail there with a
        # shape error).
        if cfg.fused_kernel not in fm.V1_KINDS:
            warnings.warn(
                f"use_fused_train with fused_kernel={cfg.fused_kernel!r} at "
                f"netdepth {cfg.netdepth}: the heads read [pe | h], which "
                "only the v1 kernels take; training on the eager step (set "
                "fused_kernel=v1 or hybrid to train on the kernels)",
                stacklevel=2)
            return step_lib.build_vanilla_train_step(model, cfg, **kw)
        if onepass:
            warnings.warn(
                f"use_onepass_train at netdepth {cfg.netdepth}: the heads "
                "read [pe | h], which the one-pass kernel does not take; "
                f"training on the {cfg.fused_kernel} two-call step",
                stacklevel=2)
            onepass = False
    if onepass:
        return fused_onepass.build_onepass_vanilla_train_step(cfg, **kw)
    return fused_train.build_fused_vanilla_train_step(cfg, **kw)


def _select_mip_train_step(cfg, model, mesh=None):
    """The mip branch of the dispatch (loop.py:92-110). No mip step reads
    ss_loss, in either package: it warns and trains without it. A config
    without view directions trains on the eager step, with a warning."""
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train

    if cfg.ss_loss:
        warnings.warn("ss_loss=true: the mip backbone's steps do not read "
                      "it (as in the JAX package); training without it",
                      stacklevel=3)
    if not cfg.use_fused_train:
        return step_lib.build_mip_train_step(model, cfg, mesh=mesh)
    if not cfg.use_viewdirs:
        # The port's own gate (ROADMAP note E): the JAX package's kernel
        # steps fail here in flatten_mip_params; the port follows the
        # model.
        warnings.warn(
            "use_fused_train with the mip backbone at use_viewdirs=false: "
            "the fused mip kernels read a view layer this MLP lacks (the "
            "JAX package's kernel steps raise KeyError "
            f"'Dense_{cfg.netdepth + 2}' here); training on the eager step",
            stacklevel=3)
        return step_lib.build_mip_train_step(model, cfg, mesh=mesh)
    if not cfg.disable_normals:
        raise ValueError(
            "use_fused_train with the mip backbone requires "
            "disable_normals=true (normals need per-point density grads; "
            "use the eager step for normal metrics)")
    if cfg.use_onepass_train and fused_onepass.mip_onepass_supported(cfg):
        return fused_onepass.build_onepass_mip_train_step(cfg, mesh=mesh)
    return fused_train.build_fused_mip_train_step(cfg, mesh=mesh)


def train_lpips_params(cfg, device, log_fn=print):
    """The params of the train-time patch LPIPS term on `device`, or None
    (the JAX loop's gate, train/loop.py:136-160): the vanilla backbone
    only, and only with calibrated weights, since a random-init trunk
    degrades quality; a path that names no file warns and skips. Patches
    under `lpips.MIN_SIZE` pixels a side are refused."""
    if cfg.backbone != "vanilla" or not cfg.lpips_weights_path:
        return None
    from consistentnerf_tpu_torch.train import lpips as lpips_mod

    lp = lpips_mod.LPIPS(cfg.lpips_weights_path, device=device)
    if lp.is_calibrated:
        if (not cfg.use_batching and cfg.n_patches > 0
                and cfg.patch_size < lpips_mod.MIN_SIZE):
            # VGG's four pools leave no pixel of a smaller patch for the
            # last block: the JAX term is then NaN (ROADMAP Queue 3 E).
            raise ValueError(
                f"the train-time LPIPS term needs patches of at least "
                f"{lpips_mod.MIN_SIZE} pixels a side; patch_size="
                f"{cfg.patch_size} (unset lpips_weights_path)")
        return lp.params
    log_fn(f"WARNING: lpips_weights_path={cfg.lpips_weights_path!r} not "
           "found; SKIPPING the train-time LPIPS term (a random-init "
           "perceptual loss degrades quality; export calibrated weights "
           "with the JAX package's cli/export_lpips_weights.py)")
    return None


def summary_writer(cfg, log_fn=print):
    """TensorBoard's writer under {basedir}/{expname}/runs, or None where
    it is off or cannot be made (no `tensorboard` package), as the JAX
    loop's (train/loop.py:164-173); the loop says why in one line."""
    if not cfg.use_tensorboard:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(os.path.join(cfg.basedir, cfg.expname, "runs"))
    except Exception as e:  # ImportError where tensorboard is missing
        log_fn(f"use_tensorboard: no SummaryWriter ({type(e).__name__}: "
               f"{e}); training without TensorBoard scalars")
        return None


class StepProfiler:
    """`torch.profiler` over steps start+1 ... start+profile_steps (the
    JAX loop's trace window), CPU and, on a card, CUDA activities; the
    Chrome trace goes to `profile_dir`, else {basedir}/{expname}/profile.
    `before(step_i)` runs before each step's batch; `close()` writes an
    open window's trace."""

    def __init__(self, cfg, start_step: int, device, log_fn=print):
        self.first = start_step + 1
        self.last = start_step + cfg.profile_steps
        self.on = cfg.profile_steps > 0
        self.out_dir = cfg.profile_dir or os.path.join(
            cfg.basedir, cfg.expname, "profile")
        self.device = torch.device(device)
        self.log_fn = log_fn
        self.prof = None

    def before(self, step_i: int) -> None:
        if not self.on:
            return
        if step_i == self.first:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        elif step_i == self.last + 1:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir,
                            f"train_steps_{self.first}-{self.last}.json")
        prof.export_chrome_trace(path)
        self.log_fn(f"profile of steps {self.first}-{self.last}: {path}")


def train(cfg, scene: SceneData, num_steps: Optional[int] = None,
          device="cuda", random_poses=None,
          log_fn: Callable[[str], None] = print,
          use_prefetch: bool = True) -> TrainResult:
    """Run (or resume) training; returns the final state and throughput.
    `random_poses` [P, 3, 4]: the mip batcher's random-pose rays. With
    `use_prefetch` a thread makes the batches ahead of the loop
    (`Prefetcher`; the stream is the batcher's either way). In a process
    group (`parallel.mesh.maybe_initialize_distributed`) the ranks train
    the global batch together on `cfg.mesh_shape`; a bare `cuda` device
    is the rank's card."""
    num_steps = num_steps or cfg.total_iters
    device = mesh_lib.rank_device(device)
    mesh = mesh_lib.create_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device)
    lead = mesh.rank == 0
    if not lead:
        log_fn = _quiet
    batcher = make_batcher(scene, cfg, random_poses)
    # The JAX loop draws an example batch to initialise its state before
    # the loop, so step i trains on the batcher's batch i + 1 and the
    # batcher's own counter (precrop_iters, anneal_nearfar) runs one ahead.
    example = batcher.next_batch()
    batch_rays = example["rgb"].shape[0]
    state = init_state(cfg, device)
    ckpt = CheckpointManager(
        os.path.join(cfg.basedir, cfg.expname, "checkpoints"),
        keep=cfg.checkpoint_keep)
    state = ckpt.restore(state)
    mesh_lib.broadcast_state(state, mesh)
    start_step = state.step
    if start_step:
        log_fn(f"resumed from step {start_step}")
    lpips_params = train_lpips_params(cfg, device, log_fn)
    train_step = select_train_step(cfg, state.model,
                                   lpips_params=lpips_params, mesh=mesh)

    source = Prefetcher(batcher) if use_prefetch else batcher
    writer = summary_writer(cfg, log_fn) if lead else None
    profiler = StepProfiler(cfg.replace(profile_steps=cfg.profile_steps
                                        if lead else 0),
                            start_step, device, log_fn)
    stats_history = []
    rays_per_sec = 0.0
    t0, last_log = time.time(), start_step
    # gc off for the loop (RegNeRF train.py:366,407-408), its state
    # restored on the way out, also when a step raises.
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        for step_i in range(start_step, num_steps):
            if cfg.gc_every > 0 and (step_i + 1) % cfg.gc_every == 0:
                gc.collect()
            profiler.before(step_i)
            batch = to_device(next(source), device)
            state, stats = train_step(state, batch)
            if (step_i + 1) % cfg.i_print == 0:
                stats = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                         for k, v in stats.items()}
                rays_per_sec = ((step_i + 1 - last_log) * batch_rays
                                / (time.time() - t0))
                t0, last_log = time.time(), step_i + 1
                stats_history.append(stats)
                log_fn(f"step {step_i + 1}/{num_steps} "
                       f"loss={float(stats['loss']):.4f} "
                       f"psnr={float(stats.get('psnr', np.nan)):.2f} "
                       f"{rays_per_sec:,.0f} rays/sec")
                if writer is not None:
                    for k, v in stats.items():
                        if v.ndim == 0:
                            writer.add_scalar(f"train_{k}", float(v),
                                              step_i + 1)
                    writer.add_scalar("train_rays_per_sec", rays_per_sec,
                                      step_i + 1)
            if (step_i + 1) % cfg.checkpoint_every == 0 or \
                    step_i + 1 == num_steps:
                if lead:
                    ckpt.save(step_i + 1, state)
                mesh_lib.barrier(mesh)
            if (lead and cfg.train_render_every > 0
                    and (step_i + 1) % cfg.train_render_every == 0
                    and len(scene.i_test) > 0):
                held_out_render(cfg, scene, state.model, step_i + 1,
                                writer, log_fn)
    finally:
        profiler.close()
        if source is not batcher:
            source.close()
        if writer is not None:
            writer.close()
        if gc_was_enabled:
            gc.enable()
    return TrainResult(state=state, stats_history=stats_history,
                       rays_per_sec=rays_per_sec)


def _quiet(_msg: str) -> None:
    """The log of ranks other than 0."""


def held_out_render(cfg, scene, model, step: int, writer, log_fn) -> dict:
    """The periodic held-out render (RegNeRF train.py:492-564): the first
    test view through `evaluate()` into {basedir}/{expname}/train_renders,
    logged and written to TensorBoard as test_*."""
    from consistentnerf_tpu_torch.train import evaluation

    metrics = evaluation.evaluate(
        model, cfg, scene,
        out_dir=os.path.join(cfg.basedir, cfg.expname, "train_renders"),
        views=scene.i_test[:1], step=step)
    log_fn(f"  test render @ {step}: " + ", ".join(
        f"{k}={v:.3f}" for k, v in sorted(metrics.items())))
    if writer is not None:
        for k, v in metrics.items():
            writer.add_scalar(f"test_{k}", v, step)
    return metrics
