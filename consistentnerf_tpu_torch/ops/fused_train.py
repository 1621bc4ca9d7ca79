"""The mip forward through the fused MipMLP kernels.

`fused_mip_forward` is the port of `consistentnerf_tpu/ops/fused_train.py::
fused_mip_forward`: `MipNeRF.forward` semantics (models/mipnerf.py) with
the MLP of every level evaluated on transposed [3, N*S] streams by
`fused_mip.fused_mip_mlp_train_T` (forward kernel #6, backward kernel #7
where autograd asks for one). The render takes it for bf16 configs, and
the one-pass mip train step for its MiDaS patch rays. The head
activations, the density noise and the compositing stay in torch, as in
the JAX package.

With `disable_normals=False` every level runs the normals variant
(`fused_mip.fused_mip_mlp_normals_T`, kernel 6n) and the rendering dicts
carry the normals map; that forward has no backward, so it serves the
render (the train steps refuse normals). Not ported here:
`fused_vanilla_forward` and the two-call fused train steps (ROADMAP
Queue 1: two-call fused step).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from consistentnerf_tpu_torch.core import rendering, sampling
from consistentnerf_tpu_torch.models.mlp import softplus
from consistentnerf_tpu_torch.ops import fused_mip


def fused_mip_forward(weights: Sequence[torch.Tensor], draws: Optional[Dict],
                      rays, cfg, resample_padding: float = 0.01,
                      compute_extras: bool = False,
                      packed=None) -> List[Dict[str, torch.Tensor]]:
    """Per-level rendering dicts (coarse first) of flat rays.

    `weights`: the MipMLP's flat torch-layout list
    (`fused_mip.flatten_mip_params`; parameters receive grads through the
    backward kernel); `packed`: the same weights packed, for a CUDA
    caller that packed them once. `draws` as `MipNeRF.forward` takes them
    (None: deterministic)."""
    with_normals = not cfg.disable_normals
    if not cfg.stop_level_grad:
        raise ValueError("the fused mip forward requires stop_level_grad "
                         "(its backward gives the samples no gradient)")
    if cfg.min_deg_point != 0:
        raise ValueError("the fused mip forward requires min_deg_point=0")
    draws = draws or {}
    renderings = []
    t_vals = w_render = None
    n = rays.origins.shape[0]
    for lvl in range(cfg.mip_num_levels):
        if lvl == 0:
            t_vals, (means_T, covs_T) = sampling.sample_along_rays(
                draws.get("t_rand"), rays.origins, rays.directions,
                rays.radii, cfg.mip_num_samples, rays.near, rays.far,
                cfg.genspace_fn, cfg.ray_shape, transposed=True)
        else:
            jitter = draws.get("jitter")
            t_vals, (means_T, covs_T) = sampling.resample_along_rays(
                None if jitter is None else jitter[lvl], rays.origins,
                rays.directions, rays.radii, t_vals, w_render,
                cfg.ray_shape, cfg.stop_level_grad, resample_padding,
                transposed=True, use_kernel=cfg.use_pdf_kernel)
        if cfg.disable_integration:
            covs_T = torch.zeros_like(covs_T)
        s = means_T.shape[-1]
        streams = [x.reshape(3, n * s).contiguous() for x in (
            means_T, covs_T, rays.viewdirs.T[:, :, None].expand(3, n, s))]
        if with_normals:
            raw_T = fused_mip.fused_mip_mlp_normals_T(
                packed if packed is not None else weights, *streams,
                cfg.netdepth, cfg.max_deg_point, cfg.compute_dtype)
        else:
            raw_T = fused_mip.fused_mip_mlp_train_T(
                weights, *streams, cfg.netdepth, cfg.max_deg_point,
                cfg.compute_dtype, packed=packed)
        rgb_T = (torch.sigmoid(raw_T[:3]) * (1 + 2 * fused_mip.RGB_PADDING)
                 - fused_mip.RGB_PADDING).reshape(3, n, s)
        raw_density = raw_T[3]
        noise = draws.get("noise")
        if noise is not None and cfg.density_noise > 0:
            raw_density = raw_density + cfg.density_noise * noise[
                lvl].reshape(n * s)
        density = softplus(raw_density
                           + fused_mip.DENSITY_BIAS).reshape(n, s)
        normals = None
        if with_normals:
            # -normalize(d density / d means): the softplus factor comes
            # before the normalization, as in the JAX package
            # (fused_train.py:275-286).
            g = raw_T[4:7] * torch.sigmoid(raw_density
                                           + fused_mip.DENSITY_BIAS)
            norm = torch.sqrt(torch.clamp((g * g).sum(0, keepdim=True),
                                          min=torch.finfo(torch.float32).eps))
            normals = (-g / norm).reshape(3, n, s).permute(1, 2, 0)
        w_render, _, _, _ = rendering.compute_alpha_weights(
            density, t_vals, rays.directions)
        renderings.append(rendering.volumetric_rendering(
            None, w_render, normals, t_vals, cfg.white_bkgd,
            cfg.vis_num_rays, compute_extras, rgbs_T=rgb_T))
    return renderings
