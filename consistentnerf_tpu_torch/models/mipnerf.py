"""The mip-NeRF / RegNeRF backbone (`RegNeRF/internal/models.py:29-122`):
two sampling levels sharing one MLP, cone casting and the IPE, blurpool
inverse-CDF resampling between the levels.

`MipNeRF.forward` is the plain path: the CPU render, the eager train
step's model and the twin the fused paths are held against. Random draws
are explicit tensors (`make_mip_draws` in `train/step.py` makes them from
a generator): `t_rand` [N, S+1] jitters the first level's fenceposts,
`jitter[l]` drives level l's resampling (l >= 1) and `noise[l]` [N, S]
holds the density noise's standard normals. Without draws the forward is
the deterministic (test-time) render.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from consistentnerf_tpu_torch.core import rendering, sampling
from consistentnerf_tpu_torch.models.mlp import MipMLP


class MipNeRF(nn.Module):
    """Two-level cone-cast NeRF with a shared MLP (`self.mlp`)."""

    def __init__(self, num_samples: int = 96, num_levels: int = 2,
                 stop_level_grad: bool = True, use_viewdirs: bool = True,
                 genspace_fn=None, ray_shape: str = "cone",
                 disable_integration: bool = False,
                 white_background: bool = True, vis_num_rays: int = 64,
                 net_depth: int = 8, net_width: int = 256,
                 max_deg_point: int = 16, disable_normals: bool = True,
                 density_noise: float = 0.0, dtype=torch.float32):
        super().__init__()
        if not use_viewdirs:
            raise NotImplementedError(
                "the mip backbone without view directions is not ported "
                "(ROADMAP Queue 1: configs)")
        self.num_samples = num_samples
        self.num_levels = num_levels
        self.stop_level_grad = stop_level_grad
        self.genspace_fn = genspace_fn
        self.ray_shape = ray_shape
        self.disable_integration = disable_integration
        self.white_background = white_background
        self.vis_num_rays = vis_num_rays
        self.mlp = MipMLP(net_depth=net_depth, net_width=net_width,
                          max_deg_point=max_deg_point,
                          disable_normals=disable_normals,
                          density_noise=density_noise, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, rays, draws: Optional[Dict] = None,
                resample_padding: float = 0.01,
                compute_extras: bool = False) -> List[Dict]:
        """Render flat rays ([N, 3] / [N, 1] fields): one rendering dict
        per level, coarse first."""
        draws = draws or {}
        renderings = []
        t_vals = weights = None
        for lvl in range(self.num_levels):
            if lvl == 0:
                t_vals, (means, covs) = sampling.sample_along_rays(
                    draws.get("t_rand"), rays.origins, rays.directions,
                    rays.radii, self.num_samples, rays.near, rays.far,
                    self.genspace_fn, self.ray_shape)
            else:
                jitter = draws.get("jitter")
                t_vals, (means, covs) = sampling.resample_along_rays(
                    None if jitter is None else jitter[lvl], rays.origins,
                    rays.directions, rays.radii, t_vals, weights,
                    self.ray_shape, self.stop_level_grad, resample_padding)
            if self.disable_integration:
                covs = torch.zeros_like(covs)
            n, s = means.shape[:2]
            views = rays.viewdirs[:, None, :].expand(n, s, 3)
            noise = draws.get("noise")
            rgb, density = self.mlp(
                means.reshape(n * s, 3), covs.reshape(n * s, 3),
                views.reshape(n * s, 3),
                None if noise is None else noise[lvl].reshape(n * s))
            weights, _, _, _ = rendering.compute_alpha_weights(
                density.reshape(n, s), t_vals, rays.directions)
            renderings.append(rendering.volumetric_rendering(
                rgb.reshape(n, s, 3), weights, t_vals,
                self.white_background, self.vis_num_rays, compute_extras))
        return renderings
