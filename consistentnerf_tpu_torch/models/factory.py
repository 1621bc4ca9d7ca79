"""Model construction from a Config."""

from __future__ import annotations

import torch

from consistentnerf_tpu_torch.models.mipnerf import MipNeRF
from consistentnerf_tpu_torch.models.nerf import VanillaNeRF


def make_model(cfg, device="cuda"):
    """The configured model on `device`, its weights initialised from
    `cfg.seed`."""
    if cfg.backbone == "vanilla":
        model = VanillaNeRF(
            num_samples=cfg.N_samples,
            num_importance=cfg.N_importance,
            multires=cfg.multires,
            multires_views=cfg.multires_views,
            use_viewdirs=cfg.use_viewdirs,
            white_bkgd=cfg.white_bkgd,
            lindisp=cfg.lindisp,
            net_depth=cfg.netdepth,
            net_width=cfg.netwidth,
            raw_noise_std=cfg.raw_noise_std,
            dtype=cfg.compute_dtype,
        )
    elif cfg.backbone == "mipnerf":
        model = MipNeRF(
            num_samples=cfg.mip_num_samples,
            num_levels=cfg.mip_num_levels,
            stop_level_grad=cfg.stop_level_grad,
            use_viewdirs=cfg.use_viewdirs,
            genspace_fn=cfg.genspace_fn,
            ray_shape=cfg.ray_shape,
            disable_integration=cfg.disable_integration,
            white_background=cfg.white_bkgd,
            vis_num_rays=cfg.vis_num_rays,
            net_depth=cfg.netdepth,
            net_width=cfg.netwidth,
            max_deg_point=cfg.max_deg_point,
            disable_normals=cfg.disable_normals,
            density_noise=cfg.density_noise,
            dtype=cfg.compute_dtype,
        )
    else:
        raise ValueError(f"Unknown backbone {cfg.backbone!r}")
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    return model.to(device)
