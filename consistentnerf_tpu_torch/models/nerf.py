"""The vanilla (ConsistentNeRF PyTorch-backbone) model: PE + coarse MLP +
compositing + hierarchical resample + fine MLP + compositing
(`run_nerf_view.py:441-551` semantics).

Random draws are explicit tensors: `t_rand` [N, num_samples] jitters the
coarse depths, `u` [N, num_importance] drives the fine inverse-CDF draws,
and `noise_c` [N, num_samples] / `noise_f` [N, num_samples +
num_importance] are the standard normals of the density noise, added to
each level's density logit at `raw_noise_std` (the JAX package's
`models/nerf.py:138-178`). Without them the forward is the deterministic
(test-time) render.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from consistentnerf_tpu_torch.core import encoding, rendering, sampling
from consistentnerf_tpu_torch.models.mlp import NeRFMLP
from consistentnerf_tpu_torch.ops import fused_mlp as fm


class VanillaNeRF(nn.Module):
    """Coarse/fine PE-MLP NeRF."""

    def __init__(self, num_samples: int = 64, num_importance: int = 128,
                 multires: int = 10, multires_views: int = 4,
                 use_viewdirs: bool = True, white_bkgd: bool = False,
                 lindisp: bool = False, net_depth: int = 8,
                 net_width: int = 256, raw_noise_std: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.raw_noise_std = raw_noise_std
        self.num_samples = num_samples
        self.num_importance = num_importance
        self.multires = multires
        self.multires_views = multires_views
        self.use_viewdirs = use_viewdirs
        self.white_bkgd = white_bkgd
        self.lindisp = lindisp
        self.net_depth = net_depth
        self.dtype = fm.as_dtype(dtype)
        kw = dict(net_depth=net_depth, net_width=net_width,
                  input_ch=3 * (1 + 2 * multires),
                  input_ch_views=3 * (1 + 2 * multires_views),
                  use_viewdirs=use_viewdirs, dtype=dtype)
        self.coarse = NeRFMLP(output_ch=5 if num_importance > 0 else 4, **kw)
        if num_importance > 0:
            self.fine = NeRFMLP(output_ch=5, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mlp in self.children():
            mlp.reset_parameters(generator)

    def _eval_mlp(self, mlp, pts, viewdirs):
        """PE-encode and evaluate one MLP on [N, S, 3] points."""
        n, s = pts.shape[:2]
        pts_embed = encoding.posenc_nerf(pts.reshape(n * s, 3),
                                         self.multires)
        views_embed = None
        if self.use_viewdirs:
            views_flat = viewdirs[:, None, :].expand(n, s, 3)
            views_embed = encoding.posenc_nerf(
                views_flat.reshape(n * s, 3), self.multires_views)
        raw = mlp(pts_embed, views_embed)
        return raw.reshape(n, s, raw.shape[-1])

    def _noise(self, normals: Optional[torch.Tensor]):
        if normals is None or self.raw_noise_std <= 0:
            return None
        return self.raw_noise_std * normals

    def forward(self, rays, t_rand: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                compute_extras: bool = False,
                noise_c: Optional[torch.Tensor] = None,
                noise_f: Optional[torch.Tensor] = None):
        """Render flat rays ([N, 3] / [N, 1] fields). `noise_c` /
        `noise_f`: the levels' density-noise normals (used when
        raw_noise_std > 0).

        Returns fine outputs under 'rgb'/'disp'/'acc'/'depth' and coarse
        outputs under 'rgb0'/'disp0'/'acc0'/'depth0' (+ 'z_std')."""
        origins, directions = rays.origins, rays.directions
        viewdirs = rays.viewdirs if self.use_viewdirs else None

        z_vals = sampling.vanilla_z_vals(
            rays.near, rays.far, self.num_samples, self.lindisp, t_rand
        )
        pts = origins[..., None, :] + directions[..., None, :] * \
            z_vals[..., :, None]
        raw = self._eval_mlp(self.coarse, pts, viewdirs)
        rgb_map, disp_map, acc_map, weights, depth_map = \
            rendering.raw2outputs(raw, z_vals, directions,
                                  self._noise(noise_c), self.white_bkgd)

        ret = {}
        if self.num_importance > 0:
            ret.update(rgb0=rgb_map, disp0=disp_map, acc0=acc_map,
                       depth0=depth_map)
            z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sampling.sample_pdf(
                z_vals_mid, weights[..., 1:-1], self.num_importance, u=u,
                det=u is None,
            ).detach()
            z_vals_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1),
                                       -1)
            pts = origins[..., None, :] + directions[..., None, :] * \
                z_vals_all[..., :, None]
            raw = self._eval_mlp(self.fine, pts, viewdirs)
            rgb_map, disp_map, acc_map, weights, depth_map = \
                rendering.raw2outputs(raw, z_vals_all, directions,
                                      self._noise(noise_f), self.white_bkgd)
            ret["z_std"] = torch.std(z_samples, -1, correction=0)

        ret.update(rgb=rgb_map, disp=disp_map, acc=acc_map, depth=depth_map)
        if compute_extras:
            ret["weights"] = weights
            ret["raw"] = raw
        return ret
