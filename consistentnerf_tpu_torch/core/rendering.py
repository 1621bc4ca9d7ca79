"""Alpha compositing: the vanilla renderer's (`run_nerf_view.py:392-438`
semantics) and mip-NeRF's density weights and rendering dict
(`RegNeRF/internal/mip.py:195-294`)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from consistentnerf_tpu_torch.core import mathx


def _composite(rgb, density_logit, z_vals, dnorm, noise, white_bkgd):
    """Shared tail: rgb [N, S, 3], density/z [N, S], dnorm [N, 1]."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * dnorm
    if noise is not None:
        density_logit = density_logit + noise
    alpha = 1.0 - torch.exp(-torch.relu(density_logit) * dists)
    # Exclusive cumprod of transmittance 1-alpha (+1e-10 like the reference).
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  -1), -1
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    disp_map = 1.0 / torch.maximum(
        1e-10 * torch.ones_like(depth_map), depth_map / acc_map
    )
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
):
    """raw: [N, S, 4] (rgb logits + density logit), z_vals: [N, S],
    rays_d: [N, 3]. Returns (rgb_map, disp_map, acc_map, weights,
    depth_map)."""
    dnorm = torch.linalg.norm(rays_d, dim=-1)[..., None]
    return _composite(torch.sigmoid(raw[..., :3]), raw[..., 3], z_vals,
                      dnorm, noise, white_bkgd)


def raw2outputs_T(
    raw_T: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
):
    """raw2outputs on a transposed raw stream raw_T [4, N, S] (the fused
    forward's output layout). Same returns as `raw2outputs`."""
    dnorm = torch.linalg.norm(rays_d, dim=-1)[..., None]
    rgb = torch.sigmoid(raw_T[:3]).permute(1, 2, 0)
    return _composite(rgb, raw_T[3], z_vals, dnorm, noise, white_bkgd)


def compute_alpha_weights(density, t_vals, dirs):
    """mip-NeRF alpha weights from density [N, S] between fenceposts
    t_vals [N, S+1] (mip.py:195-208): (weights, alpha, trans, delta)."""
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(
        dirs[..., None, :], dim=-1)
    density_delta = density * delta
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], -1)], -1))
    return alpha * trans, alpha, trans, delta


def volumetric_rendering(rgbs, weights, normals, t_vals,
                         white_background: bool, vis_num_rays: int,
                         compute_extras: bool,
                         rgbs_T=None) -> Dict[str, torch.Tensor]:
    """mip-NeRF rendering dict (mip.py:211-294): rgb and distance_mean,
    and with `compute_extras` acc, the normals map (when `normals`
    [N, S, 3] is given; None for a `disable_normals` model),
    distance_mean_save, distance_std, the distance percentiles (5, 25, 50
    as distance_median, 75, 95) and the ray visualizations. rgbs
    [N, S, 3], or `rgbs_T` [3, N, S] (the fused kernels' layout) with
    rgbs=None."""
    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    if rgbs_T is not None:
        rgb = (weights[None] * rgbs_T).sum(-1).movedim(0, -1)
    else:
        rgb = (weights[..., None] * rgbs).sum(-2)
    acc = weights.sum(-1)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])
    out = {"rgb": rgb}

    def expectation(x):
        return (weights * x).sum(-1) / acc

    out["distance_mean"] = torch.clamp(
        torch.nan_to_num(expectation(t_mids), nan=float("inf")),
        t_vals[..., 0], t_vals[..., -1])
    if compute_extras:
        eps = torch.finfo(torch.float32).eps
        out["acc"] = acc
        if normals is not None:
            normals_map = (weights[..., None] * normals).sum(-2)
            if white_background:
                normals_map = normals_map + (1.0 - acc[..., None])
            out["normals"] = normals_map
        out["distance_mean_save"] = torch.clamp(
            (weights * t_mids).sum(-1) / torch.clamp(acc, min=eps),
            t_vals[..., 0], t_vals[..., -1])
        out["distance_std"] = torch.nan_to_num(torch.clamp(torch.sqrt(
            expectation(t_mids**2) - out["distance_mean"] ** 2), min=0.0),
            nan=0.0)
        ps = [5, 25, 50, 75, 95]
        pct = mathx.weighted_percentile(t_mids, weights, ps,
                                        assume_sorted=True)
        for i, p in enumerate(ps):
            key = "median" if p == 50 else f"percentile_{p}"
            out["distance_" + key] = pct[..., i]
        t_flat = t_vals.reshape(-1, t_vals.shape[-1])
        w_flat = weights.reshape(-1, weights.shape[-1])
        if rgbs_T is not None:
            ray_rgbs = rgbs_T.reshape(3, -1, rgbs_T.shape[-1])[
                :, :vis_num_rays].movedim(0, -1)
        else:
            ray_rgbs = rgbs.reshape(-1, *rgbs.shape[-2:])[:vis_num_rays]
        out["ray_t_vals"] = t_flat[:vis_num_rays]
        out["ray_weights"] = w_flat[:vis_num_rays]
        out["ray_weights_full"] = w_flat
        out["ray_rgbs"] = ray_rgbs
    return out
