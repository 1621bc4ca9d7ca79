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


def make_batcher(scene: SceneData, cfg):
    if cfg.backbone == "mipnerf":
        return MipBatcher(scene, cfg)
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
    """The production step dispatch: the one-pass kernel step where the
    config's exact loss is supported; the eager step when use_fused_train
    is off. The two-call fused steps (`ops/fused_train.py` in the JAX
    package, which softLpmask and the mip configs outside
    `mip_onepass_supported` need) are not ported and raise."""
    if cfg.backbone == "mipnerf":
        return _select_mip_train_step(cfg, model)
    if cfg.use_fused_train:
        from consistentnerf_tpu_torch.ops import fused_onepass

        if cfg.use_onepass_train and fused_onepass.onepass_supported(cfg):
            return fused_onepass.build_onepass_vanilla_train_step(
                cfg, lpips_params=lpips_params)
        raise NotImplementedError(
            "the two-call fused train step is not ported yet (ROADMAP "
            "Queue 1: two-call fused step); set use_fused_train=false for "
            "the eager step")
    return step_lib.build_vanilla_train_step(model, cfg,
                                             lpips_params=lpips_params)


def _select_mip_train_step(cfg, model):
    """The mip branch of the dispatch (loop.py:92-110)."""
    if not cfg.use_fused_train:
        return step_lib.build_mip_train_step(model, cfg)
    from consistentnerf_tpu_torch.ops import fused_onepass

    if cfg.use_onepass_train and fused_onepass.mip_onepass_supported(cfg):
        return fused_onepass.build_onepass_mip_train_step(cfg)
    raise NotImplementedError(
        "the two-call fused mip train step is not ported yet (ROADMAP "
        "Queue 1: two-call fused step); set use_fused_train=false for the "
        "eager step")


def train(cfg, scene: SceneData, num_steps: Optional[int] = None,
          device="cuda",
          log_fn: Callable[[str], None] = print) -> TrainResult:
    """Run (or resume) training; returns the final state and throughput."""
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
    batcher = make_batcher(scene, cfg)
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
        batch_rays = batch["rgb"].shape[0]
        state, stats = train_step(state, batch)
        if (step_i + 1) % cfg.i_print == 0 or step_i + 1 == num_steps:
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
