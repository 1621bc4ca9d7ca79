"""The forwards of both backbones through the fused MLP kernels, and the
two-call fused train steps built on them.

`fused_vanilla_forward` is the port of `consistentnerf_tpu/ops/
fused_train.py::fused_vanilla_forward`: `VanillaNeRF.forward` semantics
with both levels' MLPs through a differentiable fused op picked by
`cfg.fused_kernel`, as the JAX package picks it:
  "v2"     `fused_mlp_v2_train_T` on transposed [3, N*S] streams (forward
           #1, weight grads #2), compositing by `raw2outputs_T`;
  "v2row"  `fused_mlp_v2_train` on row-major [N*S, 3] streams (#10, #11),
           compositing by `raw2outputs`;
  "v2h"    `hybrid_mlp_v2_train`: the plain forward (no kernel, as the
           JAX package's XLA forward) and #11;
  "v1"     `fused_mlp_train.fused_mlp_train` on row-major streams (the v1
           kernels #13, #14), compositing by `raw2outputs`;
  "hybrid" `fused_mlp_train.hybrid_mlp_train`: the plain forward and #14.
The fine depths come from `pdf_merge.fine_z_vals` (kernel #8 with
`use_pdf_kernel`). `build_fused_vanilla_train_step` (the JAX module's
step of the same name) runs it with the losses, autograd and the
optimizer: the "two-call" step, one forward and one backward kernel per
level, where the one-pass step cannot compute the config's loss
(softLpmask) or is switched off.

`fused_mip_forward` is the port of `fused_mip_forward`: `MipNeRF.forward`
semantics with the MLP of every level evaluated on transposed [3, N*S]
streams by `fused_mip.fused_mip_mlp_train_T` (forward kernel #6, backward
kernel #7 where autograd asks for one). The render takes it for bf16
configs, the one-pass mip train step for its MiDaS patch rays and its
random-pose rays, and `build_fused_mip_train_step` (the mip two-call
step) for every ray. The head activations, the density noise and the
compositing stay in torch, as in the JAX package.

With `disable_normals=False` every level runs the normals variant
(`fused_mip.fused_mip_mlp_normals_T`, kernel 6n) and the rendering dicts
carry the normals map; that forward has no backward, so it serves the
render (the fused train steps need disable_normals, as in the JAX
package; the eager mip step trains with normals). Random draws are tensors
(`train/step.py::make_draws`, `make_mip_draws`). Under a mesh
(`parallel/mesh.py`; the JAX module's `_shard_map_kernel`, l.34-55) the
two-call steps run the forward on the rank's rows of the global batch
and compute the global loss on the gathered outputs, as the eager steps
do (`train/step.py::shard_step`); the weight grads are summed over ranks
in `finish_step`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_mod
from consistentnerf_tpu_torch.core import rendering, sampling
from consistentnerf_tpu_torch.models.mlp import softplus
from consistentnerf_tpu_torch.ops import fused_mip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import pdf_merge
from consistentnerf_tpu_torch.ops.fused_onepass import model_skips
from consistentnerf_tpu_torch.parallel import mesh as mesh_lib
from consistentnerf_tpu_torch.train import losses as losses_lib
from consistentnerf_tpu_torch.train import step as step_lib

# fused_kernel -> (differentiable op, transposed streams).
_VANILLA_OPS = {
    "v2": (v2.fused_mlp_v2_train_T, True),
    "v2row": (v2.fused_mlp_v2_train, False),
    "v2h": (v2.hybrid_mlp_v2_train, False),
    "v1": (fmt.fused_mlp_train, False),
    "hybrid": (fmt.hybrid_mlp_train, False),
}


def vanilla_op(kind: str):
    """(op, transposed) of `cfg.fused_kernel`."""
    if kind not in _VANILLA_OPS:
        raise ValueError(f"unknown fused_kernel {kind!r}; one of "
                         f"{sorted(_VANILLA_OPS)}")
    return _VANILLA_OPS[kind]


def fused_vanilla_forward(params: Dict[str, Sequence[torch.Tensor]],
                          draws: Optional[Dict], rays, cfg,
                          packed: Optional[Dict] = None) -> Dict:
    """`VanillaNeRF.forward` outputs (rgb0/disp0/acc0/depth0, z_std,
    rgb/disp/acc/depth) of flat rays with fused MLP evaluations.

    `params`: {'coarse': flat list, 'fine': flat list} of the NeRFMLPs'
    torch-layout parameters (`fused_mlp.flatten_params`; they receive the
    grads); `packed`: the same weights packed per level, for a CUDA caller
    that packed them. `draws`: `t_rand` [N, N_samples] and `u`
    [N, N_importance] as `make_draws` makes them (absent or None: the
    deterministic levels)."""
    op, transposed = vanilla_op(cfg.fused_kernel)
    draws = draws or {}
    packed = packed or {}
    origins, directions, viewdirs = (rays.origins, rays.directions,
                                     rays.viewdirs)
    n = origins.shape[0]
    mlp_kw = dict(net_depth=cfg.netdepth, skips=model_skips(cfg.netdepth),
                  multires=cfg.multires, multires_views=cfg.multires_views,
                  compute_dtype=fm.as_dtype(cfg.compute_dtype))

    def eval_level(lvl, z_vals):
        s = z_vals.shape[1]
        if transposed:
            pts = (origins.T[:, :, None] + directions.T[:, :, None]
                   * z_vals[None]).reshape(3, n * s)
            views = viewdirs.T[:, :, None].expand(3, n, s).reshape(3, n * s)
            raw = op(params[lvl], pts.contiguous(), views.contiguous(),
                     packed=packed.get(lvl), **mlp_kw)
            return rendering.raw2outputs_T(raw.reshape(4, n, s), z_vals,
                                           directions, None, cfg.white_bkgd)
        pts = (origins[:, None] + directions[:, None]
               * z_vals[..., None]).reshape(n * s, 3)
        views = viewdirs[:, None].expand(n, s, 3).reshape(n * s, 3)
        raw = op(params[lvl], pts.contiguous(), views.contiguous(),
                 packed=packed.get(lvl), **mlp_kw)
        return rendering.raw2outputs(raw.reshape(n, s, 4), z_vals,
                                     directions, None, cfg.white_bkgd)

    t_rand = draws.get("t_rand") if cfg.perturb > 0 else None
    z_vals = sampling.vanilla_z_vals(rays.near, rays.far, cfg.N_samples,
                                     cfg.lindisp, t_rand)
    rgb, disp, acc, weights, depth = eval_level("coarse", z_vals)
    out = {}
    if cfg.N_importance > 0:
        out.update(rgb0=rgb, disp0=disp, acc0=acc, depth0=depth)
        u = draws.get("u") if cfg.perturb > 0 else None
        z_all, z_samples = pdf_merge.fine_z_vals(
            z_vals, weights, cfg.N_importance, u=u, det=u is None,
            use_kernel=cfg.use_pdf_kernel, return_samples=True)
        out["z_std"] = torch.std(z_samples, -1, correction=0)
        rgb, disp, acc, weights, depth = eval_level("fine", z_all)
    out.update(rgb=rgb, disp=disp, acc=acc, depth=depth)
    return out


def _levels(cfg) -> tuple:
    return ("coarse", "fine") if cfg.N_importance > 0 else ("coarse",)


def build_fused_vanilla_train_step(cfg, lpips_params=None,
                                   mesh=None) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats): the
    vanilla ConsistentNeRF loss (`train.losses.vanilla_losses`, softLpmask
    included) on `fused_vanilla_forward`'s outputs, autograd through the
    fused ops' backward kernels, output noise with `use_noise`, then the
    optimizer chain and `finish_step`'s stats; with ss_loss the reference
    rays go through the same forward (`step_lib.apply_ss_loss`). `state`
    is updated in place."""
    step_lib.check_kernel_step(cfg)
    vanilla_op(cfg.fused_kernel)
    cdt = fm.as_dtype(cfg.compute_dtype)
    net_depth = cfg.netdepth
    skips = model_skips(net_depth)

    def train_step(state, batch, draws: Optional[Dict] = None):
        model = state.model
        n, dev = batch["rgb"].shape[0], batch["rgb"].device
        if draws is None:
            draws = step_lib.make_draws(cfg, n, step_lib.step_generator(
                cfg.seed, state.step, dev), dev)
        local, d_loc, sl = step_lib.shard_step(batch, draws, mesh, n)
        rays = step_lib.rays_from_batch(local, cfg.near, cfg.far)
        temp = mask_mod.temp_schedule(state.step, cfg.total_iters,
                                      cfg.temp_start, cfg.temp_end)
        state.optimizer.zero_grad()
        params = {lvl: fm.flatten_params(getattr(model, lvl), True,
                                         net_depth) for lvl in _levels(cfg)}
        packed = None
        if dev.type == "cuda":
            packed = {lvl: fm.pack_for(cfg.fused_kernel, w, net_depth,
                                       skips, cfg.multires,
                                       cfg.multires_views, cdt)
                      for lvl, w in params.items()}
        outputs = fused_vanilla_forward(params, d_loc, rays, cfg, packed)
        if cfg.use_noise:
            outputs = step_lib.apply_output_noise(outputs, cfg,
                                                  d_loc["noise"])
        outputs = mesh_lib.gather_outputs(outputs, mesh, sl.stop - sl.start)
        loss, stats = losses_lib.vanilla_losses(outputs, batch, cfg, cfg.far,
                                                temp, lpips_params)
        if step_lib.has_ss(cfg, batch):
            # The reference rays through the step's own differentiable
            # forward: its forward and weight-grad kernels.
            def apply_fn(rays_, d):
                return fused_vanilla_forward(params, d, rays_, cfg, packed)

            loss, stats = step_lib.apply_ss_loss(
                step_lib.sharded_apply(apply_fn, mesh, n), batch, cfg,
                outputs, loss, stats, draws["ss"])
        loss.backward()
        return state, step_lib.finish_step(state, stats, cfg, mesh)

    return train_step


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


def build_fused_mip_train_step(cfg, mesh=None) -> Callable:
    """train_step(state, batch, draws=None) -> (state, stats): the mip
    loss (`train.losses.mip_losses`, the TV norm on the random-pose rays
    included) with every ray through `fused_mip_forward` (#6, and #7 by
    autograd), then the optimizer chain and `finish_step`'s stats. The
    JAX dispatch sends the mip configs here that `mip_onepass_supported`
    refuses (disp metrics) or that set use_onepass_train=false. `state`
    is updated in place. It needs `disable_normals` (the normals forward
    6n has no backward), as the JAX step asserts (fused_train.py:315)."""
    if not cfg.disable_normals:
        raise ValueError("the fused mip train step requires "
                         "disable_normals=true (6n has no backward)")
    if not cfg.use_viewdirs:
        raise ValueError("the fused mip train step needs the view layer "
                         "(use_viewdirs=true); train/loop.py::select_train_step "
                         "sends use_viewdirs=false to the eager step")
    cdt = fm.as_dtype(cfg.compute_dtype)
    net_depth = cfg.netdepth

    def train_step(state, batch, draws: Optional[Dict] = None):
        model = state.model
        n, dev = batch["rgb"].shape[0], batch["rgb"].device
        render_random = step_lib.renders_random(cfg, batch)
        if draws is None:
            draws = step_lib.make_mip_step_draws(
                cfg, batch, step_lib.step_generator(cfg.seed, state.step,
                                                    dev), dev)
        padding = step_lib.resample_padding(cfg, state.step)
        state.optimizer.zero_grad()
        params = fused_mip.flatten_mip_params(model.mlp, net_depth)
        packed = (fused_mip.pack([w.detach() for w in params], net_depth,
                                 cfg.max_deg_point, cdt)
                  if dev.type == "cuda" else None)
        local, d_loc, sl = step_lib.shard_step(batch, draws, mesh, n)
        renderings = mesh_lib.gather_outputs(fused_mip_forward(
            params, d_loc, local["rays"], cfg, resample_padding=padding,
            compute_extras=(cfg.compute_disp_metrics
                            or cfg.compute_normal_metrics), packed=packed),
            mesh, sl.stop - sl.start)
        renderings_random = None
        if render_random:
            def apply_fn(rays_, d):
                return fused_mip_forward(
                    params, d, rays_, cfg, resample_padding=padding,
                    compute_extras=True, packed=packed)

            renderings_random = step_lib.sharded_apply(
                apply_fn, mesh, batch["rays_random"].origins.shape[0])(
                batch["rays_random"], draws.get("random"))
        loss, stats = losses_lib.mip_losses(
            renderings, renderings_random, batch,
            mesh_lib.once(list(model.parameters()), mesh), cfg,
            step_lib.tvnorm_weight(cfg, state.step))
        loss.backward()
        return state, step_lib.finish_step(state, stats, cfg, mesh)

    return train_step
