"""Ray generation: pixel->ray, NDC warp, cone radii, and the Rays bundle.

Camera convention matches the reference (OpenGL-style: x right, y up, z
backwards): a pixel (i, j) maps to the camera-frame direction
[(i-cx)/fx, -(j-cy)/fy, -1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Rays:
    """A bundle of rays. All fields share leading dims."""

    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3] (not normalized)
    viewdirs: torch.Tensor  # [..., 3] (normalized directions)
    radii: torch.Tensor  # [..., 1] base radii for cone casting
    lossmult: torch.Tensor  # [..., 1]
    near: torch.Tensor  # [..., 1]
    far: torch.Tensor  # [..., 1]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rays":
        """Apply `fn` to every field."""
        return Rays(**{f.name: fn(getattr(self, f.name))
                       for f in dataclasses.fields(self)})


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def pixel_dirs(H: int, W: int, K, device="cuda") -> torch.Tensor:
    """Camera-frame direction for every pixel center. Returns [H, W, 3]."""
    K = _as_tensor(K, device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
         -torch.ones_like(i)], -1
    )


def get_rays(H: int, W: int, K, c2w, device="cuda"):
    """World-frame (origins, directions) [H, W, 3] for one camera;
    directions are unnormalized."""
    c2w = _as_tensor(c2w, device)
    dirs = pixel_dirs(H, W, K, device)
    rays_d = torch.einsum("hwc,rc->hwr", dirs, c2w[:3, :3])
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Warp rays into NDC space for forward-facing scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2]
    )
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2]
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def pixel_radii(directions: torch.Tensor) -> torch.Tensor:
    """Cone base radii [H, W, 1] from the x-spacing of neighbouring pixel
    directions [H, W, 3], scaled by 2/sqrt(12)."""
    dx = torch.sqrt(
        torch.sum((directions[:, :-1, :] - directions[:, 1:, :]) ** 2, -1)
    )
    dx = torch.cat([dx, dx[:, -2:-1]], 1)
    return dx[..., None] * 2 / math.sqrt(12)


def camera_rays(
    H: int,
    W: int,
    K,
    c2w,
    near: float,
    far: float,
    *,
    use_ndc: bool = False,
    ndc_focal: Optional[float] = None,
    device="cuda",
) -> Rays:
    """Full Rays bundle [H, W, ...] for one camera, on `device`."""
    rays_o, rays_d = get_rays(H, W, K, c2w, device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    radii = pixel_radii(rays_d)
    if use_ndc:
        focal = ndc_focal if ndc_focal is not None else np.asarray(K)[0, 0]
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        radii = pixel_radii(rays_d)
    ones = torch.ones_like(rays_d[..., :1])
    return Rays(
        origins=rays_o.contiguous(),
        directions=rays_d,
        viewdirs=viewdirs,
        radii=radii,
        lossmult=ones,
        near=ones * near,
        far=ones * far,
    )
