"""Cone and cylinder casting of mip-NeRF: a ray section between two
fenceposts, lifted to a 3D Gaussian (`RegNeRF/internal/mip.py:51-157`,
mip-NeRF eq. 7).

`transposed=True` (diagonal covariances only) returns means and covs as
[3, N, S] streams, the layout the fused kernels read.
"""

from __future__ import annotations

import torch

_EPS = torch.finfo(torch.float32).eps



def lift_gaussian(d, t_mean, t_var, r_var, diag: bool,
                  transposed: bool = False):
    """Lift a 1-D Gaussian along each ray into 3D (mip.py:51-71). d [N, 3];
    t_mean, t_var, r_var [N, S]."""
    if transposed:
        if not diag:
            raise ValueError("transposed lift_gaussian supports diag only")
        dT = d.T  # [3, N]
        mean_T = dT[:, :, None] * t_mean[None]
        d_mag_sq = torch.clamp(torch.sum(d**2, -1), min=1e-10)  # [N]
        d_outer_T = dT**2
        null_outer_T = 1 - d_outer_T / d_mag_sq[None]
        return mean_T, (t_var[None] * d_outer_T[:, :, None]
                        + r_var[None] * null_outer_T[:, :, None])
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, -1, keepdim=True), min=1e-10)
    if diag:
        d_outer = d**2
        null_outer = 1 - d_outer / d_mag_sq
        return mean, (t_var[..., None] * d_outer[..., None, :]
                      + r_var[..., None] * null_outer[..., None, :])
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag: bool,
                                stable: bool = True,
                                transposed: bool = False):
    """Approximate a conical frustum as a Gaussian (mip.py:74-108)."""
    if stable:
        mu = (t0 + t1) / 2
        hw = (t1 - t0) / 2
        denom = torch.clamp(3 * mu**2 + hw**2, min=_EPS)
        t_mean = mu + (2 * mu * hw**2) / denom
        t_var = (hw**2) / 3 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) \
            / denom**2
        r_var = (mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom
    else:
        t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
        r_var = 3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_mosq = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_var = t_mosq - t_mean**2
    r_var = r_var * base_radius**2
    return lift_gaussian(d, t_mean, t_var, r_var, diag,
                         transposed=transposed)


def cylinder_to_gaussian(d, t0, t1, radius, diag: bool,
                         transposed: bool = False):
    """Approximate a cylinder as a Gaussian (mip.py:111-130)."""
    t_mean = (t0 + t1) / 2
    r_var = radius**2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(d, t_mean, t_var, r_var, diag,
                         transposed=transposed)


def cast_rays(t_vals, origins, directions, radii, ray_shape: str,
              diag: bool = True, transposed: bool = False):
    """Gaussians of the ray sections between fenceposts t_vals [N, S+1]
    (mip.py:133-157): (means, covs), [N, S, 3] or, transposed, [3, N, S].
    radii [N, 1]."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    if ray_shape == "cone":
        gaussian_fn = conical_frustum_to_gaussian
    elif ray_shape == "cylinder":
        gaussian_fn = cylinder_to_gaussian
    else:
        raise ValueError(f"ray_shape must be cone|cylinder, got "
                         f"{ray_shape!r}")
    means, covs = gaussian_fn(directions, t0, t1, radii, diag,
                              transposed=transposed)
    if transposed:
        return means + origins.T[:, :, None], covs
    return means + origins[..., None, :], covs
