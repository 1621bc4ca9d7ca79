"""Training harness of both trainers: setup, the step dispatch, the loop,
logging and checkpoints. Throughput is logged as rays/sec like the
reference (`train.py:416-419`).

Not ported yet: the threaded prefetch, TensorBoard, the profiler hook and
the periodic held-out render (ROADMAP Queue 1: train loop).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from consistentnerf_tpu_torch.data.pipeline import (AllImagesBatcher,
                                                    MipBatcher,
                                                    VanillaBatcher,
                                                    to_device)
from consistentnerf_tpu_torch.data.scene import SceneData
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train import step as step_lib
from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
from consistentnerf_tpu_torch.train.state import (create_train_state,
                                                  sync_coarse_from_fine)


@dataclasses.dataclass
class TrainResult:
    state: object
    stats_history: list
    rays_per_sec: float


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


def select_train_step(cfg, model, lpips_params=None):
    """The production step dispatch (the JAX package's loop.py:68-111):
    with use_fused_train, the one-pass kernel step where the config's
    exact loss is supported (`onepass_supported`,
    `mip_onepass_supported`), else the two-call fused step
    (`ops/fused_train.py`); the eager step when use_fused_train is off.
    Where the heads read [pe | h] (netdepth 5) only the v1 kernels take
    them: the dispatch warns and trains a v2 kind on the eager step and a
    v1 kind on its two-call step instead of the one-pass kernel."""
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train

    if cfg.backbone == "mipnerf":
        return _select_mip_train_step(cfg, model)
    if not cfg.use_fused_train:
        return step_lib.build_vanilla_train_step(model, cfg,
                                                 lpips_params=lpips_params)
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
            return step_lib.build_vanilla_train_step(
                model, cfg, lpips_params=lpips_params)
        if onepass:
            warnings.warn(
                f"use_onepass_train at netdepth {cfg.netdepth}: the heads "
                "read [pe | h], which the one-pass kernel does not take; "
                f"training on the {cfg.fused_kernel} two-call step",
                stacklevel=2)
            onepass = False
    if onepass:
        return fused_onepass.build_onepass_vanilla_train_step(
            cfg, lpips_params=lpips_params)
    return fused_train.build_fused_vanilla_train_step(
        cfg, lpips_params=lpips_params)


def _select_mip_train_step(cfg, model):
    """The mip branch of the dispatch (loop.py:92-110)."""
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train

    if not cfg.use_fused_train:
        return step_lib.build_mip_train_step(model, cfg)
    if not cfg.disable_normals:
        raise ValueError(
            "use_fused_train with the mip backbone requires "
            "disable_normals=true (normals need per-point density grads; "
            "use the eager step for normal metrics)")
    if cfg.use_onepass_train and fused_onepass.mip_onepass_supported(cfg):
        return fused_onepass.build_onepass_mip_train_step(cfg)
    return fused_train.build_fused_mip_train_step(cfg)


def train(cfg, scene: SceneData, num_steps: Optional[int] = None,
          device="cuda", random_poses=None,
          log_fn: Callable[[str], None] = print) -> TrainResult:
    """Run (or resume) training; returns the final state and throughput.
    `random_poses` [P, 3, 4]: the mip batcher's random-pose rays."""
    num_steps = num_steps or cfg.total_iters
    device = torch.device(device)
    if cfg.lpips_weights_path:
        # The JAX loop turns the term on when the file exists (calibrated
        # weights) and warns and skips it when it does not.
        if os.path.exists(cfg.lpips_weights_path):
            raise NotImplementedError(
                "the train-time LPIPS term is not ported yet (ROADMAP Queue "
                "1: eval metrics); unset lpips_weights_path")
        log_fn(f"WARNING: lpips_weights_path={cfg.lpips_weights_path!r} "
               "not found; SKIPPING the train-time LPIPS term")
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
    start_step = state.step
    if start_step:
        log_fn(f"resumed from step {start_step}")
    train_step = select_train_step(cfg, state.model)

    stats_history = []
    rays_per_sec = 0.0
    t0, last_log = time.time(), start_step
    for step_i in range(start_step, num_steps):
        batch = to_device(batcher.next_batch(), device)
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
        if (step_i + 1) % cfg.checkpoint_every == 0 or step_i + 1 == num_steps:
            ckpt.save(step_i + 1, state)
    return TrainResult(state=state, stats_history=stats_history,
                       rays_per_sec=rays_per_sec)
