"""Multi-view reprojection and the hard masks, on the device of the tensors.

Port of `consistentnerf_tpu/consistency/reproject.py`: every target pixel is
lifted to 3D by its view's depth prior, projected into each other train
view (with the reference's y/z-flip camera convention), and kept where its
depth in the reference camera agrees with that view's prior to within a
threshold. The threshold search of the reference (start at
`occlusion_threshold`, double until one pixel of the 5120-pixel chunk
passes, run_nerf_view.py:1014-1029) is the closed form `_effective_threshold`:
the smallest tau0 * 2^k above the chunk's least |depth diff|. A target's
mask is the OR over its reference views (run_nerf_view.py:1041).

The details that decide which pixels pass are the JAX package's: the
5120-pixel chunks, the strict-interior bounds test, round-half-to-even
pixel coordinates (`torch.round`, as `jnp.round`), `w2c` formed as the
fp32 inverse of the 4x4 `c2w`, and the quotients by constants taken as
its jitted program takes them (`_recip`). The work is a few elementwise
passes and one gather per (target, reference) pair, so it runs as plain
tensor code, by default on the card (`compute_hard_masks(device=...)`).

The depth-prior producers fuse their priors with the same test
(`fused_depth_for_target` / `fuse_depth_priors`): a target pixel lifted by
its prior is checked against each other view's prior (|z_ref - ref depth|
< threshold, strict), the agreeing views' estimates re-lifted and read
along the target ray, and the pixel keeps the mean of its own and the
agreeing estimates where at least `min_consensus` views agree, else zero
("no prior"). Its pixel lookups truncate the rounded coordinates clamped
to the image (`clip(...).astype(int32)` in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from consistentnerf_tpu_torch.core import rays as rays_core
from consistentnerf_tpu_torch.ops import fused_mlp as fm

CHUNK = 5120  # reference chunk size (run_nerf_view.py:1014)

# OpenGL camera (y up, z back) -> projection convention (y down, z forward).
_FLIP_YZ = np.diag(np.array([1.0, -1.0, -1.0], np.float32))


def _recip(c: float) -> float:
    """fp32(1 / c). The JAX package makes its masks in one jitted program
    (`hard_mask_for_target`), where XLA turns each division by a constant
    into a product with the constant's fp32 reciprocal; the port computes
    those quotients the same way. It decides pixels: at H or W = 48,
    47 * fp32(1/47) < 1 puts the last row and column inside the bounds."""
    return float(np.float32(1.0) / np.float32(c))


def _project(points_w: torch.Tensor, w2c_ref: torch.Tensor,
             K: torch.Tensor):
    """World points [N, 3] -> (camera points after the y/z flip [N, 3],
    pixel coordinates before rounding [N, 2])."""
    R, T = w2c_ref[:3, :3], w2c_ref[:3, 3]
    flip = torch.as_tensor(_FLIP_YZ, device=points_w.device)
    p_cam = (points_w @ R.T + T) @ flip
    p_pix = p_cam @ K.to(p_cam.dtype).T
    return p_cam, p_pix[..., :2] / p_pix[..., 2:3]


def world_to_ref_pixels(points_w: torch.Tensor, w2c_ref: torch.Tensor,
                        K: torch.Tensor, H: int, W: int):
    """Project world points [N, 3] into a reference camera (w2c [4, 4] or
    [3, 4]). Returns (x, y, z_ref, in_bounds): rounded pixel coordinates
    (float), the depth in the ref camera (positive in front) and the
    strict-interior bounds mask (borders excluded,
    run_nerf_view.py:611-613)."""
    p_cam, q = _project(points_w, w2c_ref, K)
    x, y = torch.round(q[..., 0]), torch.round(q[..., 1])
    x_norm, y_norm = x * _recip(W - 1), y * _recip(H - 1)
    in_bounds = (x_norm > 0.0) & (x_norm < 1.0) & (y_norm > 0.0) & (
        y_norm < 1.0)
    return x, y, p_cam[..., 2], in_bounds


def _effective_threshold(min_diff: torch.Tensor, tau0: float) -> torch.Tensor:
    """Smallest tau0 * 2^k (k >= 0) strictly greater than min_diff: the
    closed form of the reference's doubling loop."""
    tiny = torch.finfo(torch.float32).tiny
    ratio = torch.clamp(min_diff * _recip(tau0), min=tiny)
    k = torch.clamp(torch.floor(torch.log2(ratio)) + 1.0, min=0.0)
    k = torch.where(min_diff < tau0, torch.zeros_like(k), k)
    return tau0 * torch.exp2(k)


def _pair_terms(points_w: torch.Tensor, w2c_ref: torch.Tensor,
                ref_depth: torch.Tensor, K: torch.Tensor,
                occlusion_threshold: float, chunk: int):
    """The terms of one target/reference pair, over the target's points
    padded to whole chunks: (in_bounds [C, chunk], |depth diff|
    [C, chunk], the chunk thresholds [C])."""
    H, W = ref_depth.shape
    P = points_w.shape[0]
    pad = (-P) % chunk
    valid = torch.ones(P, dtype=torch.bool, device=points_w.device)
    if pad:
        points_w = torch.cat([points_w, points_w.new_zeros(pad, 3)], 0)
        valid = torch.cat([valid, valid.new_zeros(pad)], 0)
    x, y, z_ref, in_bounds = world_to_ref_pixels(points_w, w2c_ref, K, H, W)
    in_bounds = in_bounds & valid  # the padded tail must not drive the search
    # Clamped as jnp.clip + the gather's clamp; NaN coordinates (a point on
    # the camera plane) are out of bounds and read pixel 0.
    xi = torch.nan_to_num(x.clamp(0, W - 1), nan=0.0).long()
    yi = torch.nan_to_num(y.clamp(0, H - 1), nan=0.0).long()
    diff = torch.abs(z_ref - ref_depth[yi, xi]).reshape(-1, chunk)
    in_bounds = in_bounds.reshape(-1, chunk)
    min_diff = torch.where(in_bounds, diff,
                           torch.full_like(diff, float("inf"))).min(1).values
    return in_bounds, diff, _effective_threshold(min_diff,
                                                 occlusion_threshold)


def consistency_mask_pair(points_w: torch.Tensor, w2c_ref: torch.Tensor,
                          ref_depth: torch.Tensor, K: torch.Tensor,
                          occlusion_threshold: float = 0.1,
                          chunk: int = CHUNK) -> torch.Tensor:
    """Consistency of target pixels (world points [P, 3]) against one ref
    view with depth prior ref_depth [H, W]. Returns bool [P]."""
    in_bounds, diff, tau = _pair_terms(points_w, w2c_ref, ref_depth, K,
                                       occlusion_threshold, chunk)
    any_valid = in_bounds.any(1)
    mask = in_bounds & (diff < tau[:, None]) & any_valid[:, None]
    return mask.reshape(-1)[: points_w.shape[0]]


def _target_points(tgt_pose, tgt_depth, K, H: int, W: int):
    """The target view's pixels lifted to world points [H W, 3]."""
    rays_o, rays_d = rays_core.get_rays(H, W, K, tgt_pose,
                                        device=tgt_pose.device)
    return rays_o.reshape(-1, 3) + tgt_depth.reshape(-1, 1) * \
        rays_d.reshape(-1, 3)


def hard_mask_for_target(tgt_pose: torch.Tensor, tgt_depth: torch.Tensor,
                         ref_poses: torch.Tensor, ref_depths: torch.Tensor,
                         K: torch.Tensor, H: int, W: int,
                         occlusion_threshold: float = 0.1,
                         chunk: int = CHUNK) -> torch.Tensor:
    """Hard mask of one target view (c2w [3, 4], depth [H, W]) against
    reference views ([R, 3, 4], [R, H, W]): the OR over the references.
    Returns bool [H, W]."""
    points_w = _target_points(tgt_pose, tgt_depth, K, H, W)
    mask = torch.zeros(H * W, dtype=torch.bool, device=tgt_pose.device)
    for w2c, depth in zip(rays_core.world_to_camera(ref_poses),
                          ref_depths):
        mask |= consistency_mask_pair(points_w, w2c, depth, K,
                                      occlusion_threshold, chunk)
    return mask.reshape(H, W)


def _on_device(poses, depths, K, i_train, device):
    device = torch.device(device)
    fm.strict_fp32(device)
    return (torch.as_tensor(np.asarray(poses)[:, :3, :4].astype(np.float32),
                            device=device),
            torch.as_tensor(np.asarray(depths).astype(np.float32),
                            device=device),
            torch.as_tensor(np.asarray(K, np.float32), device=device),
            [int(i) for i in np.asarray(i_train)])


def fused_depth_for_target(tgt_pose: torch.Tensor, tgt_depth: torch.Tensor,
                           ref_poses: torch.Tensor, ref_depths: torch.Tensor,
                           K: torch.Tensor, H: int, W: int,
                           threshold: float = 0.1,
                           min_consensus: int = 1) -> torch.Tensor:
    """Cross-view occlusion-tested depth fusion of one target view (c2w
    [3, 4], depth [H, W]) against reference views ([R, 3, 4], [R, H, W]).
    Returns the fused depth [H, W]: the mean of the target's depth and
    the agreeing references' estimates where at least `min_consensus`
    references agree, zero elsewhere."""
    d_t = tgt_depth.reshape(-1)
    points_w = _target_points(tgt_pose, tgt_depth, K, H, W)
    w2c_t = rays_core.world_to_camera(tgt_pose)
    votes = torch.zeros(H * W, dtype=torch.int32, device=K.device)
    total = torch.zeros(H * W, dtype=torch.float32, device=K.device)
    # The references in order: the vote and estimate sums run as the JAX
    # package's sums over its reference axis.
    for ref_pose, w2c_r, ref_depth in zip(
            ref_poses, rays_core.world_to_camera(ref_poses), ref_depths):
        x, y, z_ref, inb = world_to_ref_pixels(points_w, w2c_r, K, H, W)
        xi = torch.nan_to_num(x.clamp(0, W - 1), nan=0.0).long()
        yi = torch.nan_to_num(y.clamp(0, H - 1), nan=0.0).long()
        d_ref = ref_depth[yi, xi]
        consistent = inb & (d_ref > 0) & (torch.abs(z_ref - d_ref)
                                          < threshold)
        # Re-lift the reference's own estimate of the surface and read its
        # depth along the target ray (z in the target camera).
        ro_r, rd_r = rays_core.get_rays(H, W, K, ref_pose, device=K.device)
        pix = yi * W + xi
        x_back = ro_r.reshape(-1, 3)[pix] + d_ref[:, None] * \
            rd_r.reshape(-1, 3)[pix]
        z_t = world_to_ref_pixels(x_back, w2c_t, K, H, W)[2]
        consistent = consistent & (z_t > 0)
        votes = votes + consistent.to(torch.int32)
        total = total + torch.where(consistent, z_t, torch.zeros_like(z_t))
    keep = (d_t > 0) & (votes >= min_consensus)
    fused = (d_t + total) / (1.0 + votes)
    return torch.where(keep, fused, torch.zeros_like(fused)).reshape(H, W)


def fuse_depth_priors(poses, depths, K, i_train, H: int, W: int,
                      threshold: float = 0.1, min_consensus: int = 1,
                      device="cuda") -> np.ndarray:
    """Occlusion-tested consensus fusion of per-view depth priors
    (`fused_depth_for_target` over every train view, on `device`; zeros
    elsewhere). Returns float32 [N, H, W] in host memory."""
    poses, depths_t, K, i_train = _on_device(poses, depths, K, i_train,
                                             device)
    out = np.zeros(depths_t.shape, np.float32)
    for tgt in i_train:
        refs = [r for r in i_train if r != tgt]
        if not refs:
            out[tgt] = depths_t[tgt].cpu().numpy()
            continue
        out[tgt] = fused_depth_for_target(
            poses[tgt], depths_t[tgt], poses[refs], depths_t[refs], K, H, W,
            threshold, min_consensus).cpu().numpy()
    return out


def compute_hard_masks(poses, depths, K, i_train, H: int, W: int,
                       occlusion_threshold: float = 0.1, chunk: int = CHUNK,
                       device="cuda") -> np.ndarray:
    """Hard masks of all views (zeros for non-train views), computed on
    `device`. poses [N, 3, 4] (or [N, 4, 4]) c2w; depths [N, H, W] depth
    priors. Returns bool [N, H, W] in host memory."""
    poses, depths, K, i_train = _on_device(poses, depths, K, i_train, device)
    masks = np.zeros((poses.shape[0], H, W), dtype=bool)
    for tgt in i_train:
        refs = [r for r in i_train if r != tgt]
        if refs:
            masks[tgt] = hard_mask_for_target(
                poses[tgt], depths[tgt], poses[refs], depths[refs], K, H, W,
                occlusion_threshold, chunk).cpu().numpy()
    return masks


# The boundary rule for comparing masks computed in two places (the card
# against the CPU, the port against the JAX package): a pixel may differ
# only where a rounding decides it.
BOUNDARY_PX = 1e-4  # projected coordinate this close to a half-integer
BOUNDARY_REL = 1e-5  # |depth diff| this close (relative) to the threshold


def boundary_pixels(poses, depths, K, i_train, H: int, W: int,
                    occlusion_threshold: float = 0.1, chunk: int = CHUNK,
                    device="cuda") -> np.ndarray:
    """bool [N, H, W]: train pixels whose mask a rounding decides against
    some reference view: a projected coordinate within BOUNDARY_PX of a
    rounding boundary (x.5), or a |depth diff| within BOUNDARY_REL of its
    chunk's threshold."""
    poses, depths, K, i_train = _on_device(poses, depths, K, i_train, device)
    out = np.zeros((poses.shape[0], H, W), dtype=bool)
    for tgt in i_train:
        refs = [r for r in i_train if r != tgt]
        if not refs:
            continue
        points_w = _target_points(poses[tgt], depths[tgt], K, H, W)
        near = torch.zeros(H * W, dtype=torch.bool, device=K.device)
        for w2c, r in zip(rays_core.world_to_camera(poses[refs]), refs):
            q = _project(points_w, w2c, K)[1]
            near |= ((q - torch.floor(q) - 0.5).abs() < BOUNDARY_PX).any(-1)
            inb, diff, tau = _pair_terms(points_w, w2c, depths[r], K,
                                         occlusion_threshold, chunk)
            close = inb & ((diff - tau[:, None]).abs()
                           < BOUNDARY_REL * tau[:, None])
            near |= close.reshape(-1)[: H * W]
        out[tgt] = near.reshape(H, W).cpu().numpy()
    return out
