"""Full-image rendering in bounded-memory ray chunks.

Rays of any leading shape ([H, W] for a view, [V, H, W] for a stack of
views) are flattened and rendered `render_chunk_size` rays at a time; the
last chunk is simply shorter (the fused kernels mask their ragged tail).
Both backbones render: the vanilla one through `fused_render` or the
module, the mip one through `fused_train.fused_mip_forward` or
`MipNeRF.forward` (its last level's rgb, distance_mean as depth, disp,
acc and distance_median, and the normals map unless `disable_normals`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List

import numpy as np
import torch

from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.ops import fused_mlp as fm


def render_rays_chunked(
    render_chunk_fn: Callable[[Rays], Dict[str, torch.Tensor]],
    rays: Rays,
    chunk_size: int,
) -> Dict[str, torch.Tensor]:
    """Apply `render_chunk_fn` over [N]-flattened rays in chunks and
    concatenate the [N, ...] outputs."""
    flat = rays.map(lambda x: x.reshape(-1, x.shape[-1]))
    n = flat.origins.shape[0]
    outs = [render_chunk_fn(flat.map(lambda x: x[i: i + chunk_size]))
            for i in range(0, n, chunk_size)]
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _image_outputs(out):
    return {
        "rgb": out["rgb"],
        "depth": out["depth"][..., None],
        "disp": out["disp"][..., None],
        "acc": out["acc"][..., None],
    }


def _mip_chunk_fn(model, cfg):
    """The mip backbone's chunk renderer (render.py:105-138). Without view
    directions the fused forward does not take the MLP: the render goes
    through the module, with a warning."""
    if cfg.use_fused_render and not cfg.use_viewdirs:
        warnings.warn(
            "use_fused_render with the mip backbone at use_viewdirs=false: "
            "the fused mip forward reads a view layer this MLP lacks (the "
            "JAX package's raises KeyError "
            f"'Dense_{cfg.netdepth + 2}'); rendering through the module",
            stacklevel=3)
    if cfg.use_fused_render and cfg.use_viewdirs:
        from consistentnerf_tpu_torch.ops import fused_mip
        from consistentnerf_tpu_torch.ops.fused_train import \
            fused_mip_forward

        flat = [w.detach() for w in fused_mip.flatten_mip_params(
            model.mlp, cfg.netdepth)]
        packed = None
        if flat[0].device.type == "cuda":
            packed = fused_mip.pack(flat, cfg.netdepth, cfg.max_deg_point,
                                    cfg.compute_dtype)

        def apply_fn(chunk_rays):
            return fused_mip_forward(
                flat, None, chunk_rays, cfg,
                resample_padding=cfg.resample_padding_final,
                compute_extras=True, packed=packed)
    else:

        def apply_fn(chunk_rays):
            return model(chunk_rays, None,
                         resample_padding=cfg.resample_padding_final,
                         compute_extras=True)

    def chunk_fn(chunk_rays):
        fine = apply_fn(chunk_rays)[-1]
        out = {
            "rgb": fine["rgb"],
            "depth": fine["distance_mean"][..., None],
            "disp": (1.0 / torch.clamp(fine["distance_mean"],
                                       min=1e-6))[..., None],
            "acc": fine["acc"][..., None],
            "distance_median": fine["distance_median"][..., None],
        }
        if "normals" in fine and not cfg.disable_normals:
            out["normals"] = fine["normals"]
        return out

    return chunk_fn


def fused_render_takes(cfg) -> bool:
    """The port's own gate on the vanilla fused render: where the heads
    read [pe | h] (netdepth 5), only the v1 forward (#12) takes the
    widened heads; the v2 forwards (#1, #10) and the one-pass render (#4)
    do not (the JAX package's v2 kernels fail there with a shape error),
    so such a config renders through the module, with a warning that
    says why."""
    from consistentnerf_tpu_torch.ops.fused_onepass import heads_read_pe

    return not heads_read_pe(cfg.netdepth) or (
        cfg.fused_kernel in fm.V1_KINDS and not cfg.use_onepass_render)


def build_render_fn(model, cfg) -> Callable[[Rays], Dict[str, torch.Tensor]]:
    """Deterministic full-image renderer for eval/vis.

    Returns render(rays[..., H, W]) -> dict of [..., H, W(, 3)] images.
    With `cfg.use_fused_render` the MLPs run through the fused kernels,
    their weights packed once here (unless `fused_render_takes` refuses
    the config)."""
    if cfg.backbone == "mipnerf":
        chunk_fn = _mip_chunk_fn(model, cfg)
    elif cfg.use_fused_render and fused_render_takes(cfg):
        from consistentnerf_tpu_torch.ops import fused_render
        from consistentnerf_tpu_torch.ops.fused_onepass import model_skips

        levels = ["coarse"] + (["fine"] if cfg.N_importance > 0 else [])
        skips = model_skips(cfg.netdepth)
        packed = {
            # The one-pass render (#4) takes the v2 packing.
            lvl: fm.pack_for(
                "v2" if cfg.use_onepass_render else cfg.fused_kernel,
                fm.flatten_params(getattr(model, lvl), True, cfg.netdepth),
                cfg.netdepth, skips, cfg.multires, cfg.multires_views,
                cfg.compute_dtype)
            for lvl in levels
        }

        def chunk_fn(chunk_rays):
            return _image_outputs(fused_render.fused_render_rays(
                packed,
                chunk_rays,
                num_samples=cfg.N_samples,
                num_importance=cfg.N_importance,
                multires=cfg.multires,
                multires_views=cfg.multires_views,
                net_depth=cfg.netdepth,
                skips=skips,
                white_bkgd=cfg.white_bkgd,
                lindisp=cfg.lindisp,
                compute_dtype=cfg.compute_dtype,
                kernel=cfg.fused_kernel,
                onepass=cfg.use_onepass_render,
                pdf_kernel=cfg.use_pdf_kernel,
            ))
    else:
        if cfg.use_fused_render:
            warnings.warn(
                f"use_fused_render with fused_kernel={cfg.fused_kernel!r}"
                f" and use_onepass_render={cfg.use_onepass_render} at "
                f"netdepth {cfg.netdepth}: the heads read [pe | h], which "
                "only the v1 forward takes; rendering through the module "
                "(set fused_kernel=v1 or hybrid and use_onepass_render="
                "false to render on the kernel)", stacklevel=2)

        def chunk_fn(chunk_rays):
            return _image_outputs(model(chunk_rays))

    @torch.no_grad()
    def render(rays: Rays) -> Dict[str, torch.Tensor]:
        lead = rays.origins.shape[:-1]
        out = render_rays_chunked(chunk_fn, rays, cfg.render_chunk_size)
        return {
            k: v.reshape(lead) if v.shape[-1] == 1
            else v.reshape(*lead, v.shape[-1])
            for k, v in out.items()
        }

    return render


def stack_rays(rays_list: List[Rays]) -> Rays:
    """Stack per-view Rays ([H, W, C] fields) into [V, H, W, C]."""
    return Rays(**{f.name: torch.stack([getattr(r, f.name)
                                        for r in rays_list], 0)
                   for f in dataclasses.fields(Rays)})


def render_image(model, cfg, rays: Rays) -> Dict[str, np.ndarray]:
    render = build_render_fn(model, cfg)
    return {k: v.cpu().numpy() for k, v in render(rays).items()}
