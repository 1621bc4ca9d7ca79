"""Deterministic render through the fused MLP forward.

Replicates `VanillaNeRF.forward`'s test-time pipeline (stratified coarse
depths, coarse MLP, compositing, inverse-CDF fine depths, fine MLP,
compositing) but evaluates both MLPs with `ops/fused_mlp_v2.fwd_T` on
transposed [3, N*S] point streams, so each point costs 6 floats in and 4
out of device memory instead of a 90-float encoding plus every layer's
activations. `kernel` picks the forward as the JAX render does:
"v2" and "v2h" the transposed #1, "v2row" the row-major #10
(`fused_mlp_v2.fwd` on [N*S, 3] streams, compositing by `raw2outputs`),
"v1" and "hybrid" the v1 forward #12 (`fused_mlp.fused_mlp` on row-major
streams, compositing by `raw2outputs`).
With `onepass` each level runs `ops/fused_onepass.render_level_T`
(kernel #4), which composites inside the kernel and writes six per-ray
rows instead of the raw stream, whatever `kernel` names (as in the JAX
render); with `pdf_kernel` the fine depths come from kernel #8
(`pdf_merge.fine_z_vals`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from consistentnerf_tpu_torch.core import rendering, sampling
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import pdf_merge


KERNELS = ("v2", "v2h", "v2row") + fm.V1_KINDS


def fused_render_rays(
    params: Mapping[str, object],
    rays,
    *,
    num_samples: int = 64,
    num_importance: int = 128,
    multires: int = 10,
    multires_views: int = 4,
    net_depth: int = 8,
    skips=(4,),
    white_bkgd: bool = False,
    lindisp: bool = False,
    compute_dtype=torch.float32,
    kernel: str = "v2",
    onepass: bool = False,
    pdf_kernel: bool = False,
) -> Dict[str, torch.Tensor]:
    """Deterministic render of flat rays ([N, 3] / [N, 1] fields).

    `params`: {'coarse': w, 'fine': w} where each w is the flat
    torch-layout weight list or a `fused_mlp_v2.PackedMLP` (packed once by
    the caller, `fused_mlp.pack_for`); 'fine' defaults to 'coarse'."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown fused render kernel {kernel!r}; one of "
                         f"{KERNELS}")
    coarse_w = params["coarse"]
    fine_w = params.get("fine", coarse_w)
    origins, directions, viewdirs = rays.origins, rays.directions, \
        rays.viewdirs
    n = origins.shape[0]

    dnorm = torch.linalg.norm(directions, dim=-1)

    def eval_level(weights, z_vals):
        """(rgb, disp, acc, weights, depth) of one level."""
        s = z_vals.shape[1]
        if not onepass and kernel in ("v2row",) + fm.V1_KINDS:
            pts = (origins[:, None] + directions[:, None] * z_vals[..., None])
            views = viewdirs[:, None].expand(n, s, 3)
            pts = pts.reshape(n * s, 3).contiguous()
            views = views.reshape(n * s, 3).contiguous()
            if kernel == "v2row":
                raw = v2.fwd(weights, pts, views, net_depth, skips, multires,
                             multires_views, compute_dtype)
            else:
                raw = fm.fused_mlp(weights, pts, views, net_depth=net_depth,
                                   skips=skips, multires=multires,
                                   multires_views=multires_views,
                                   compute_dtype=compute_dtype)
            return rendering.raw2outputs(raw.reshape(n, s, 4), z_vals,
                                         directions, None, white_bkgd)
        pts_T, views_T = op._pts_views(origins.T, directions.T, viewdirs.T,
                                       z_vals)
        if not onepass:
            raw_T = v2.fwd_T(weights, pts_T, views_T, net_depth, skips,
                             multires, multires_views, compute_dtype)
            return rendering.raw2outputs_T(raw_T.reshape(4, n, s), z_vals,
                                           directions, None, white_bkgd)
        rows = op.render_level_T(
            weights, pts_T, views_T, z_vals.reshape(1, n * s).contiguous(),
            op._rep_row(dnorm, s).contiguous(), seg=s, net_depth=net_depth,
            skips=skips, multires=multires, multires_views=multires_views,
            white_bkgd=white_bkgd, compute_dtype=compute_dtype)
        per_ray = rows[:, ::s]
        rgb, depth, acc = per_ray[:3].T, per_ray[3], per_ray[4]
        disp = 1.0 / torch.maximum(1e-10 * torch.ones_like(depth),
                                   depth / acc)
        return rgb, disp, acc, rows[5].reshape(n, s), depth

    z_vals = sampling.vanilla_z_vals(rays.near, rays.far, num_samples,
                                     lindisp, None)
    rgb, disp, acc, weights, depth = eval_level(coarse_w, z_vals)
    out = {}
    if num_importance > 0:
        out.update(rgb0=rgb, disp0=disp, acc0=acc, depth0=depth)
        z_all = pdf_merge.fine_z_vals(z_vals, weights, num_importance,
                                      det=True, use_kernel=pdf_kernel)
        rgb, disp, acc, weights, depth = eval_level(fine_w, z_all)
    out.update(rgb=rgb, disp=disp, acc=acc, depth=depth)
    return out
