"""The depth-prior bootstrap: producer -> depth priors -> fusion -> hard
masks -> the scene for the consistent retrain (port of
`consistentnerf_tpu/train/bootstrap.py`).

The reference takes its priors from an external pretrained MVSNeRF run;
on a fresh scene this module makes them in-framework, with one of two
producers (`cfg.bootstrap_mode`):

* "warmup": train the plain backbone on the train views with every
  consistency term off, then render each train view's expected depth
  (zero where the ray saw nothing, acc <= 0.5);
* "mvs": fit the plane-sweep MVS network of `models/mvs.py` on the scene
  and predict its depths.

The priors are then fused across views (`bootstrap_fuse_priors`: the
occlusion-tested consensus of `consistency/reproject.py`), the hard masks
are computed from them, and both may be written in the reference's
on-disk layout (`depth_%04d.pfm` and `{vid}_mask_boot.jpg`). NDC scenes
are refused: their rendered depth is an NDC distance, while the
reprojection lifts metric depth along the ray.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np

from consistentnerf_tpu_torch.consistency import reproject


def warmup_config(cfg, warmup_steps: int):
    """The stage-1 config: the same model and optics, every consistency
    term off."""
    return dataclasses.replace(
        cfg,
        expname=cfg.expname + "_warmup",
        total_iters=warmup_steps,
        hardmask=False,
        softmask=False,
        softLpmask=False,
        with_depth_loss=False,
        use_test_pseudo_label=False,
        ss_loss=False,
        mono_depth_loss_mult=0.0,
        patch_ssim_loss_mult=0.0,
        patch_lpips_loss_mult=0.0,
        train_render_every=0,
    )


def render_warmup_depths(warm_cfg, scene, model) -> np.ndarray:
    """Expected-termination depth [N, H, W] of each train view under
    `model` (rendered on its device), zero where the ray saw nothing
    (acc <= 0.5) so that the masks treat it as "no prior", the MVS PFMs'
    background convention."""
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    device = next(model.parameters()).device
    render = render_lib.build_render_fn(model, warm_cfg)
    depths = np.zeros(scene.images.shape[:3], np.float32)
    for vid in np.asarray(scene.i_train):
        out = render(camera_rays_for_view(scene, scene.poses[vid],
                                          device=device))
        depths[vid] = (out["depth"] * (out["acc"] > 0.5)).cpu().numpy()
    return depths


def bootstrap_scene_priors(
    cfg,
    scene,
    warmup_steps: int,
    log_fn: Callable[[str], None] = print,
    export_dir: Optional[str] = None,
    device="cuda",
    use_prefetch: bool = True,
) -> Tuple[object, object]:
    """Run the producer stage on `device` and return (scene_with_priors,
    stage_result): the warmup's `TrainResult` or the MVS net's
    `MVSTrainResult`. `warmup_steps` is the step budget of either
    producer. With `export_dir`, the priors and masks are also written
    in the reference's layout."""
    if scene.use_ndc:
        raise ValueError(
            "bootstrap priors need metric depth; NDC (forward-facing "
            "LLFF) scenes are not supported — train with spherify or "
            "provide external priors"
        )
    mode = getattr(cfg, "bootstrap_mode", "warmup")
    if mode == "mvs":
        from consistentnerf_tpu_torch.train import mvs as mvs_train

        # Only ground-truth depth supervises the MVS net (train_mvs_depth
        # reads depth_is_gt); priors riding on the scene never do.
        result = mvs_train.train_mvs_depth(cfg, scene, num_steps=warmup_steps,
                                           log_fn=log_fn, device=device)
        depths = mvs_train.predict_depth_priors(cfg, scene, result.params,
                                                device=device)
    elif mode == "warmup":
        from consistentnerf_tpu_torch.train import loop as loop_lib

        warm_cfg = warmup_config(cfg, warmup_steps)
        # The warmup trains on a prior-free copy (unit masks, zero depths).
        shape = scene.images.shape[:3]
        warm_scene = dataclasses.replace(
            scene, depths=np.zeros(shape, np.float32),
            masks=np.ones(shape, np.float32))
        log_fn(f"bootstrap: warmup training {warmup_steps} steps "
               f"({warm_cfg.expname})")
        result = loop_lib.train(warm_cfg, warm_scene, num_steps=warmup_steps,
                                device=device, log_fn=log_fn,
                                use_prefetch=use_prefetch)
        depths = render_warmup_depths(warm_cfg, scene,
                                      result.state.model.eval())
    else:
        raise ValueError(
            f"Unknown bootstrap_mode {mode!r} (expected 'warmup' or 'mvs')")

    if getattr(cfg, "bootstrap_fuse_priors", True):
        # Cross-view occlusion-tested consensus: keeps the depths other
        # views confirm and averages the agreeing estimates.
        log_fn("bootstrap: cross-view consensus fusion of warmup depths")
        depths = reproject.fuse_depth_priors(
            scene.poses, depths, scene.K, scene.i_train, scene.H, scene.W,
            threshold=cfg.occlusion_threshold,
            min_consensus=getattr(cfg, "bootstrap_fuse_min_consensus", 1),
            device=device)

    log_fn("bootstrap: generating hard masks from warmup depths")
    masks = reproject.compute_hard_masks(
        scene.poses, depths, scene.K, scene.i_train, scene.H, scene.W,
        occlusion_threshold=cfg.occlusion_threshold,
        device=device).astype(np.float32)

    if export_dir:
        from consistentnerf_tpu_torch.data.images import write_jpeg
        from consistentnerf_tpu_torch.data.pfm import write_pfm

        os.makedirs(export_dir, exist_ok=True)
        for vid in np.asarray(scene.i_train):
            write_pfm(os.path.join(export_dir, f"depth_{vid:04d}.pfm"),
                      depths[vid])
            write_jpeg(os.path.join(export_dir, f"{vid}_mask_boot.jpg"),
                       (masks[vid] * 255).astype(np.uint8))
        log_fn(f"bootstrap: exported priors to {export_dir}")

    boot_scene = dataclasses.replace(
        scene, depths=depths, masks=masks,
        depth_is_gt=False)  # produced priors, never ground truth
    return boot_scene, result
