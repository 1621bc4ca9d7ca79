"""Online (in-training) reprojection consistency: the `ss_loss` variant.

Port of `consistentnerf_tpu/consistency/online.py` (`run_nerf_view_test.py:
900-966`): each step, the batch's pixels are lifted to 3D by the depth
prior and projected into a reference train view; the model renders the
reference rays through those pixels and is supervised against the
reference image and depth there; the main RGB loss is gated by the
consistency weight (`train/step.py::apply_ss_loss`).

Every ray keeps a slot: out-of-bounds and occluded points get zero
weight, as in the JAX package. The projection is `reproject.
world_to_ref_pixels` and the occlusion threshold `reproject.
_effective_threshold`, whose quotients by constants are the jitted JAX
program's fp32 reciprocals (ROADMAP Queue 3 note E); the JAX twin runs
jitted inside its step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_losses
from consistentnerf_tpu_torch.consistency import reproject
from consistentnerf_tpu_torch.core.rays import Rays


def build_ref_rays(points_w: torch.Tensor, ref_pose: torch.Tensor,
                   ref_image: torch.Tensor, ref_depth: torch.Tensor,
                   K: torch.Tensor, occlusion_threshold: float = 0.1,
                   use_occlusion: bool = True) -> Dict[str, torch.Tensor]:
    """Project points [N, 3] into the reference view (c2w ref_pose
    [3, 4], image [H, W, 3], depth prior [H, W]) and gather the targets
    there. Returns the reference rays' origins and directions, the
    gathered rgb / depth targets, and the weight: the bounds mask times,
    with `use_occlusion`, the occlusion test under the reference's
    threshold doubling (an empty in-bounds set gives the threshold of
    min(inf), and zero weight)."""
    H, W = ref_depth.shape
    c2w = torch.eye(4, dtype=ref_pose.dtype, device=ref_pose.device)
    c2w[:3, :4] = ref_pose
    w2c = torch.linalg.inv(c2w)
    x, y, z_ref, in_bounds = reproject.world_to_ref_pixels(points_w, w2c, K,
                                                           H, W)
    # Clipped, then truncated to int32 as the JAX package casts; a NaN
    # coordinate (a point on the camera plane) reads pixel 0.
    xi = torch.nan_to_num(x.clamp(0, W - 1), nan=0.0).to(torch.int32).long()
    yi = torch.nan_to_num(y.clamp(0, H - 1), nan=0.0).to(torch.int32).long()
    rgb_ref = ref_image[yi, xi]
    depth_ref = ref_depth[yi, xi]

    weight = in_bounds.to(torch.float32)
    if use_occlusion:
        diff = torch.abs(z_ref - depth_ref)
        diff_for_min = torch.where(in_bounds, diff,
                                   torch.full_like(diff, float("inf")))
        tau = reproject._effective_threshold(diff_for_min.min(),
                                             occlusion_threshold)
        weight = weight * (diff < tau).to(torch.float32)

    # The reference view's rays through the projected pixels, in the
    # get_rays convention ([(x-cx)/fx, -(y-cy)/fy, -1] rotated by c2w), so
    # the rendered ray passes through the pixel whose rgb / depth are its
    # targets (the JAX module's deliberate deviation from get_ref_rays,
    # whose rays are y-mirrored and point behind the camera). A point at
    # the reference camera's centre (a zero depth prior, the reference
    # view drawn as the batch's own) projects to no pixel: it has zero
    # weight, and takes the central ray so that its render stays finite
    # (a NaN there would reach the loss through 0 * NaN).
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, K[0, 2])
    y = torch.where(finite, y, K[1, 2])
    dirs_cam = torch.stack([(x - K[0, 2]) / K[0, 0],
                            -(y - K[1, 2]) / K[1, 1],
                            -torch.ones_like(x)], -1)
    rays_d = dirs_cam @ ref_pose[:3, :3].T
    rays_o = ref_pose[:3, 3].expand(rays_d.shape)
    return {"origins": rays_o, "directions": rays_d, "rgb_target": rgb_ref,
            "depth_target": depth_ref, "weight": weight}


def batch_ref_rays(batch: Dict[str, torch.Tensor],
                   cfg) -> Dict[str, torch.Tensor]:
    """`build_ref_rays` of a batch: its rays lifted by their depth
    priors, projected into the batch's reference view."""
    points_w = (batch["origins"]
                + batch["depth"][..., None] * batch["directions"])
    return build_ref_rays(points_w, batch["ref_pose"], batch["ref_image"],
                          batch["ref_depth"], batch["K"],
                          cfg.occlusion_threshold, use_occlusion=True)


def online_reprojection_loss(
        apply_fn: Callable[[Rays, Optional[Dict]], Dict[str, torch.Tensor]],
        batch: Dict[str, torch.Tensor], cfg,
        draws: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ss_loss term: render the reference rays and supervise them.

    `batch` carries 'ref_image' [H, W, 3], 'ref_depth' [H, W], 'ref_pose'
    [3, 4] and 'K' [3, 3] beside the ray fields. `apply_fn(rays, draws)`
    renders the reference rays (the eager model, or a kernel step's
    differentiable forward) with `draws` (`t_rand`, `u`; None:
    deterministic). Returns (loss, aux); aux['consistency_weight'] gates
    the caller's main RGB loss."""
    ref = batch_ref_rays(batch, cfg)
    d = ref["directions"]
    ones = torch.ones_like(d[..., :1])
    rays = Rays(origins=ref["origins"], directions=d,
                viewdirs=d / torch.linalg.norm(d, dim=-1, keepdim=True),
                radii=ones * 1e-3, lossmult=ones, near=ones * cfg.near,
                far=ones * cfg.far)
    outputs = apply_fn(rays, draws)

    w = ref["weight"]
    loss = mask_losses.masked_mse(outputs["rgb"], ref["rgb_target"], w)
    if cfg.with_depth_loss:
        loss = loss + mask_losses.masked_mse(outputs["depth"],
                                             ref["depth_target"], w)
    if "rgb0" in outputs:
        loss = loss + mask_losses.masked_mse(outputs["rgb0"],
                                             ref["rgb_target"], w)
        if cfg.with_depth_loss:
            loss = loss + mask_losses.masked_mse(outputs["depth0"],
                                                 ref["depth_target"], w)
    return loss, {"consistency_weight": w}
