"""One-pass train kernel of the vanilla step: per level, the MLP forward,
volumetric compositing, the per-ray loss cotangent and the backward in one
launch (`csrc/onepass_level.cu`), and the train step built on it.

`onepass_level_T` is the port of `consistentnerf_tpu/ops/fused_onepass.py::
onepass_level_T`, with its signature and its [6, N*S] output rows (rgb map,
depth, acc broadcast per point; the compositing weight of each point). On
a CUDA tensor it launches the kernel (or raises); on a CPU tensor it runs
the plain version `plain_onepass_level_T`: `_mlp_body`, the kernel's
compositing formulas (`_composite_fwd`) and the per-ray MSE, with
autograd. `packed_onepass_reference_T` walks the packed buffers as the
kernel does, with the explicit compositing VJP (`_composite_bwd`).

The loss cotangent is computable per ray only for terms whose batch-global
denominators do not depend on parameters (the hard-mask / plain-MSE
family, `run_nerf_view.py:1645-1648,1737,1762-1771`): the step computes
those denominators into per-ray coefficients. The patch terms (MiDaS,
SSIM) are patch-global, so the first n_patches*patch_size^2 rays take the
differentiable fused MLP (`fused_mlp_v2.fused_mlp_v2_train_T`) and
autograd, and their weight grads are summed with the kernel's.

Not ported here: the multi-device `_shard_onepass` (ROADMAP Queue 1:
multi-GPU) and the `ss_loss` branch (ROADMAP Queue 1: consistency), which
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import torch

from consistentnerf_tpu_torch import interop
from consistentnerf_tpu_torch.core import rendering, sampling
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import pdf_merge
from consistentnerf_tpu_torch.train import losses as losses_lib
from consistentnerf_tpu_torch.train import step as step_lib

KERNEL = "onepass_level"
# Kernel launches since import (or since the caller last reset it).
launches = 0


def model_skips(net_depth: int, skips=(4,)) -> tuple:
    """The skips that take effect at this depth (a skip after the last
    trunk layer feeds nothing)."""
    return tuple(s for s in skips if s + 1 < net_depth)


def _rep_row(per_ray: torch.Tensor, seg: int) -> torch.Tensor:
    """[N] or [N, C] per-ray values -> [C, N*seg] per-point rows."""
    x = per_ray if per_ray.ndim == 2 else per_ray[:, None]
    n, c = x.shape
    return x.T[:, :, None].expand(c, n, seg).reshape(c, n * seg)


def _composite_fwd(raw: torch.Tensor, z: torch.Tensor, dn: torch.Tensor,
                   white_bkgd: bool):
    """The kernel's compositing. raw [4, N, S] fp32, z [N, S], dn [N].
    Returns (rgb [N, 3], depth [N], acc [N], w [N, S], saved)."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], 1) * dn[:, None]
    c = torch.sigmoid(raw[:3])  # [3, N, S]
    sigma = raw[3]
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    # max, not `1 - alpha + 1e-10`: the last sample's alpha is exactly 1,
    # and the backward divides by v (fused_onepass.py:140-145).
    v = torch.clamp(1.0 - alpha, min=1e-10)
    trans = torch.cumprod(torch.cat([torch.ones_like(v[:, :1]), v[:, :-1]],
                                    1), 1)
    w = alpha * trans
    acc = w.sum(1)
    rgb = (w[None] * c).sum(2).T
    depth = (w * z).sum(1)
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    saved = dict(c=c, sigma=sigma, alpha=alpha, v=v, trans=trans, w=w,
                 dists=dists, z=z)
    return rgb, depth, acc, w, saved


def _composite_bwd(d_rgb: torch.Tensor, d_depth: torch.Tensor, saved,
                   white_bkgd: bool) -> torch.Tensor:
    """VJP of `_composite_fwd` into raw (fused_onepass.py:160-178).
    d_rgb [N, 3], d_depth [N]. Returns d_raw [4, N, S]."""
    c, sigma, alpha = saved["c"], saved["sigma"], saved["alpha"]
    v, trans, w = saved["v"], saved["trans"], saved["w"]
    dists, z = saved["dists"], saved["z"]
    d_acc = -d_rgb.sum(1, keepdim=True) if white_bkgd else 0.0
    d_c = w[None] * d_rgb.T[:, :, None]
    d_w = ((d_rgb.T[:, :, None] * c).sum(0) + d_depth[:, None] * z + d_acc)
    u = d_w * w
    suffix = u.flip(1).cumsum(1).flip(1) - u  # exclusive suffix sum
    d_alpha = d_w * trans - suffix / v
    d_sigma = d_alpha * (1.0 - alpha) * dists * (sigma > 0)
    return torch.cat([d_c * c * (1.0 - c), d_sigma[None]], 0)


def _out_rows(rgb, depth, acc, w, seg) -> torch.Tensor:
    n = rgb.shape[0]
    per_ray = torch.cat([rgb.T, depth[None], acc[None]], 0)  # [5, N]
    return torch.cat([per_ray[:, :, None].expand(5, n, seg).reshape(
        5, n * seg), w.reshape(1, n * seg)], 0)


def _per_ray_loss(rgb, depth, crgb, tgt, cd, prior):
    return (torch.sum(crgb[:, None] / 2 * (rgb - tgt) ** 2)
            + torch.sum(cd / 2 * (depth - prior) ** 2))


def plain_onepass_level(weights, pts_T, views_T, z, dn, crgb, tgt, cd, prior,
                        *, net_depth, skips, multires, multires_views,
                        white_bkgd, compute_dtype):
    """The plain version on per-ray inputs: z [N, S], dn/crgb/cd/prior
    [N], tgt [N, 3]. Returns (out_rows [6, N*S], torch-layout dW)."""
    n, seg = z.shape
    flat = weights.flat if isinstance(weights, v2.PackedMLP) else weights
    ws = [w.detach().float().requires_grad_() for w in flat]
    with torch.enable_grad():
        raw = fm._mlp_body(
            pts_T.T, views_T.T, ws, net_depth=net_depth, skips=tuple(skips),
            multires=multires, multires_views=multires_views,
            compute_dtype=compute_dtype)
        rgb, depth, acc, w, _ = _composite_fwd(raw.T.reshape(4, n, seg), z,
                                               dn, white_bkgd)
        loss = _per_ray_loss(rgb, depth, crgb, tgt, cd, prior)
        grads = torch.autograd.grad(loss, ws)
    return (_out_rows(rgb.detach(), depth.detach(), acc.detach(), w.detach(),
                      seg), list(grads))


def packed_onepass_reference(packed: "v2.PackedMLP", pts_T, views_T, z, dn,
                             crgb, tgt, cd, prior, white_bkgd):
    """The kernel's walk over its packed buffers: forward, compositing,
    cotangent, explicit compositing VJP, backward. Same returns as
    `plain_onepass_level`."""
    n, seg = z.shape
    raw, saved = v2.packed_forward_saved(packed, pts_T, views_T)
    rgb, depth, acc, w, comp = _composite_fwd(raw.reshape(4, n, seg), z, dn,
                                              white_bkgd)
    d_rgb = crgb[:, None] * (rgb - tgt)
    d_depth = cd * (depth - prior)
    d_raw = _composite_bwd(d_rgb, d_depth, comp, white_bkgd)
    dw, db = v2.packed_backward(packed, saved, d_raw.reshape(4, n * seg))
    return (_out_rows(rgb, depth, acc, w, seg),
            v2.unpack_grads(packed, dw, db))


@functools.cache
def _kernel():
    lib = _build.load(KERNEL)
    plan = lib.onepass_level_plan
    plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    fn = lib.onepass_level
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return plan, fn


def onepass_level(weights, pts_T, views_T, z, dn, crgb, tgt, cd, prior, *,
                  net_depth=8, skips=(4,), multires=10, multires_views=4,
                  white_bkgd=False, compute_dtype=torch.float32):
    """One level on per-ray inputs (z [N, S]; dn, crgb, cd, prior [N];
    tgt [N, 3]). Returns (out_rows [6, N*S], torch-layout dW). CPU
    tensors take the plain version; CUDA tensors launch the kernel (and
    its dW reduction) or raise."""
    cd_ = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    kw = dict(net_depth=net_depth, skips=skips, multires=multires,
              multires_views=multires_views, white_bkgd=white_bkgd,
              compute_dtype=cd_)
    if pts_T.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            v2._packed_for(weights, net_depth, skips, multires,
                           multires_views, cd_)
        return plain_onepass_level(weights, pts_T, views_T, z, dn, crgb, tgt,
                                   cd, prior, **kw)
    if pts_T.device.type != "cuda":
        raise ValueError(f"no one-pass kernel for device {pts_T.device}")
    packed = v2._packed_for(weights, net_depth, skips, multires,
                            multires_views, cd_)
    n_rays, seg = z.shape
    npts, dev = n_rays * seg, pts_T.device
    v2._check_stream("pts_T", pts_T, 3, npts, dev)
    v2._check_stream("views_T", views_T, 3, npts, dev)
    v2._check_stream("z", z.reshape(1, npts), 1, npts, dev)
    per_ray = [x.float().contiguous() for x in (dn, crgb, cd, prior)]
    tgt_T = tgt.T.float().contiguous()
    for name, t in zip(("dn", "crgb", "cd", "prior", "tgt"),
                       per_ray + [tgt_T]):
        if t.device != dev or t.shape[-1] != n_rays:
            raise ValueError(f"{name} must hold {n_rays} rays on {dev}")
    for t in (packed.w, packed.b):
        if t.device != dev:
            raise ValueError("packed weights are not on the points' device")
    out = torch.empty((6, npts), dtype=torch.float32, device=dev)
    n_w, n_b = v2.grad_numel(packed)
    if n_rays == 0:
        zeros = torch.zeros(n_w + n_b, device=dev)
        return out, v2.unpack_grads(packed, zeros[:n_w], zeros[n_w:])
    skip_mask = sum(1 << s for s in skips)
    cfg_args = (net_depth, packed.width, skip_mask, multires, multires_views)
    use_bf16 = int(cd_ == torch.bfloat16)
    plan, fn = _kernel()
    ws, part, dw = v2.train_buffers(
        plan, (n_rays, seg, *cfg_args, use_bf16), packed, dev)
    dn_, crgb_, cd__, prior_ = per_ray
    err = fn(pts_T.data_ptr(), views_T.data_ptr(), z.data_ptr(),
             dn_.data_ptr(), crgb_.data_ptr(), tgt_T.data_ptr(),
             cd__.data_ptr(), prior_.data_ptr(), packed.w.data_ptr(),
             packed.b.data_ptr(), out.data_ptr(), ws.data_ptr(),
             part.data_ptr(), dw.data_ptr(), n_rays, seg, *cfg_args,
             int(white_bkgd), use_bf16,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return out, v2.unpack_grads(packed, dw[:n_w], dw[n_w:])


def onepass_level_T(weights: Sequence[torch.Tensor], pts_T, views_T, z_row,
                    dn_row, coeff_rgb, target_rows, coeff_depth, prior_row,
                    *, seg: int, net_depth: int = 8, skips: tuple = (4,),
                    multires: int = 10, multires_views: int = 4,
                    white_bkgd: bool = False, compute_dtype=torch.float32):
    """One-pass fwd + composite + loss cotangent + bwd for one level, with
    the JAX signature: pts/views/target [3, N*S], the other rows [1, N*S]
    (per-ray values broadcast per point). Returns (out_rows [6, N*S],
    torch-layout dW list)."""
    n = pts_T.shape[1]
    if n % seg:
        raise ValueError(f"{n} points are not whole rays of {seg} samples")
    z = z_row.reshape(n // seg, seg)
    return onepass_level(
        weights, pts_T, views_T, z.contiguous(), dn_row[0, ::seg],
        coeff_rgb[0, ::seg], target_rows[:, ::seg].T, coeff_depth[0, ::seg],
        prior_row[0, ::seg], net_depth=net_depth, skips=skips,
        multires=multires, multires_views=multires_views,
        white_bkgd=white_bkgd, compute_dtype=compute_dtype)


def onepass_supported(cfg) -> bool:
    """Whether the one-pass step computes cfg's exact loss: per-ray terms
    with parameter-independent denominators. softLpmask's two
    prediction-dependent denominators cannot share one dW accumulation
    (see the JAX package's docstring); its two-call fused step is not
    ported, so `train/loop.py::select_train_step` raises for it. The
    ss_loss branch is not ported and raises here."""
    if cfg.ss_loss:
        step_lib.apply_ss_loss()
    return (cfg.backbone == "vanilla" and cfg.use_viewdirs
            and cfg.N_importance > 0 and not cfg.softLpmask)


def _grad_branch_dict(d_list: List[torch.Tensor], branch,
                      net_depth: int) -> Dict[str, torch.Tensor]:
    """Torch-layout flat grad list -> {parameter name: grad} of one NeRFMLP
    branch (zeros for the temperature scalars)."""
    return interop.flat_grads_to_named(branch, d_list, net_depth)


def _pts_views(o_T, d_T, v_T, z):
    n, seg = z.shape
    pts = (o_T[:, :, None] + d_T[:, :, None] * z[None]).reshape(3, n * seg)
    views = v_T[:, :, None].expand(3, n, seg).reshape(3, n * seg)
    return pts.contiguous(), views.contiguous()


def build_onepass_vanilla_train_step(cfg, lpips_params=None):
    """train_step(state, batch, draws=None) -> (state, stats): the vanilla
    ConsistentNeRF loss with both MLP levels running the one-pass kernel
    on the non-patch rays and the differentiable fused MLP on the patch
    rays. Loss semantics of `train.losses.vanilla_losses`
    (run_nerf_view.py:1645-1906); the stats are computed by it on the
    assembled outputs. `state` is updated in place."""
    step_lib.check_supported(cfg)
    if not onepass_supported(cfg):
        raise ValueError(
            "the one-pass step needs per-ray losses with parameter-"
            "independent denominators (hardmask / plain families)")
    net_depth = cfg.netdepth
    skips = model_skips(net_depth)
    s_c, s_i = cfg.N_samples, cfg.N_importance
    s_f = s_c + s_i
    has_patches = (not cfg.use_batching) and cfg.n_patches > 0
    n_patch_rays = cfg.n_patches * cfg.patch_size**2 if has_patches else 0
    cdt = fm.as_dtype(cfg.compute_dtype)
    mlp_kw = dict(net_depth=net_depth, skips=skips, multires=cfg.multires,
                  multires_views=cfg.multires_views)
    det = not cfg.perturb
    far = cfg.far

    def train_step(state, batch, draws: Optional[Dict] = None):
        model, opt = state.model, state.optimizer
        rays = step_lib.rays_from_batch(batch, cfg.near, cfg.far)
        n, dev = rays.origins.shape[0], rays.origins.device
        p = n_patch_rays
        if draws is None:
            draws = step_lib.make_draws(
                cfg, n, step_lib.step_generator(cfg.seed, state.step, dev),
                dev)
        t_rand, u = draws.get("t_rand"), draws.get("u")
        ls = torch.as_tensor(batch.get("loss_scale", 1.0), dtype=torch.float32,
                             device=dev)
        mask, target, prior = batch["mask"], batch["rgb"], batch["depth"]
        ones = torch.ones((n,), device=dev)

        # Per-ray loss-cotangent coefficients (global denominators,
        # parameter-independent).
        if cfg.hardmask or cfg.softmask:
            m_sum = mask.sum()
            out_w = torch.where(m_sum == n, torch.zeros_like(m_sum),
                                torch.full_like(m_sum, cfg.hardmask_coef))
            coeff_rgb = ls * 2.0 * (
                mask / torch.clamp(3.0 * m_sum, min=1.0)
                + out_w * (1.0 - mask) / torch.clamp(3.0 * (n - m_sum),
                                                     min=1.0))
        else:
            coeff_rgb = ls * 2.0 / (3.0 * n) * ones
        zero = torch.zeros((n,), device=dev)
        if cfg.with_depth_loss:
            masked_prior = torch.where(mask > 0, prior, zero)
            if cfg.hardmask or cfg.softmask:
                coeff_d = ls * 2.0 * mask / (far**2 * torch.clamp(
                    mask.sum(), min=1.0))
                prior_eff = prior
            elif cfg.with_depth_norm:
                prior_eff, coeff_d = masked_prior, ls * 2.0 / (far**2 * n) * ones
            else:
                prior_eff, coeff_d = masked_prior, ls * 2.0 / float(n) * ones
        else:
            coeff_d, prior_eff = zero, zero

        # Output noise folds into the targets: the per-ray MSE cotangent
        # coeff*(rgb + n - t) is coeff*(rgb - (t - n)).
        noise = draws.get("noise") if cfg.use_noise else None
        if noise is not None:
            sd = step_lib.NOISE_STD
            tgt_f = target - sd * noise["rgb"]
            pri_f = prior_eff - far * sd * noise["depth"]
            tgt_c = target - sd * noise["rgb0"]
            pri_c = prior_eff - far * sd * noise["depth0"]
        else:
            tgt_f = tgt_c = target
            pri_f = pri_c = prior_eff

        z_c = sampling.vanilla_z_vals(rays.near, rays.far, s_c, cfg.lindisp,
                                      t_rand)
        dnorm = torch.linalg.norm(rays.directions, dim=-1)
        o_T = rays.origins.T.contiguous()
        d_T = rays.directions.T.contiguous()
        v_T = rays.viewdirs.T.contiguous()
        flat_c = fm.flatten_params(model.coarse, True, net_depth)
        flat_f = fm.flatten_params(model.fine, True, net_depth)
        if dev.type == "cuda":
            src_c = v2.pack(flat_c, compute_dtype=cdt, **mlp_kw)
            src_f = v2.pack(flat_f, compute_dtype=cdt, **mlp_kw)
        else:
            src_c = [w.detach() for w in flat_c]
            src_f = [w.detach() for w in flat_f]

        # ---- one-pass kernel: rays [p:] ----
        def mega(src, z_sub, tgt, pri):
            pts, views = _pts_views(o_T[:, p:], d_T[:, p:], v_T[:, p:],
                                    z_sub)
            return onepass_level(
                src, pts, views, z_sub.contiguous(), dnorm[p:],
                coeff_rgb[p:], tgt[p:], coeff_d[p:], pri[p:],
                white_bkgd=cfg.white_bkgd, compute_dtype=cdt, **mlp_kw)

        with torch.no_grad():
            out_c, dw_c = mega(src_c, z_c[p:], tgt_c, pri_c)
            z_f_r = pdf_merge.fine_z_vals(
                z_c[p:], out_c[5].reshape(n - p, s_c), s_i,
                u=None if det else u[p:], det=det,
                use_kernel=cfg.use_pdf_kernel)
            out_f, dw_f = mega(src_f, z_f_r, tgt_f, pri_f)

        def maps(out_rows, seg):
            per_ray = out_rows[:, ::seg]
            return per_ray[:3].T, per_ray[3], per_ray[4]

        rgb_r, depth_r, _ = maps(out_f, s_f)
        rgb0_r, depth0_r, _ = maps(out_c, s_c)

        # ---- patch rays [:p]: differentiable fused MLP + autograd ----
        opt.zero_grad()
        if p > 0:
            def level(flat, src, z_sub):
                pts, views = _pts_views(o_T[:, :p], d_T[:, :p], v_T[:, :p],
                                        z_sub)
                raw = v2.fused_mlp_v2_train_T(
                    flat, pts, views, compute_dtype=cdt,
                    packed=src if isinstance(src, v2.PackedMLP) else None,
                    **mlp_kw)
                return rendering.raw2outputs_T(
                    raw.reshape(4, p, z_sub.shape[1]), z_sub,
                    rays.directions[:p], None, cfg.white_bkgd)

            rgb0, _, _, w_p, depth0 = level(flat_c, src_c, z_c[:p])
            z_all = pdf_merge.fine_z_vals(
                z_c[:p], w_p, s_i, u=None if det else u[:p], det=det,
                use_kernel=cfg.use_pdf_kernel)
            rgb, _, _, _, depth = level(flat_f, src_f, z_all)

            def share(rgb_l, depth_l, tgt, pri):
                return (torch.sum(coeff_rgb[:p, None] / 2.0
                                  * (rgb_l - tgt[:p]) ** 2)
                        + torch.sum(coeff_d[:p] / 2.0
                                    * (depth_l - pri[:p]) ** 2))

            loss = (share(rgb, depth, tgt_f, pri_f)
                    + share(rgb0, depth0, tgt_c, pri_c))
            batch_p = {"rgb": target[:p], "mono_disp": batch["mono_disp"][:p]}
            for rgb_l, depth_l, nk in ((rgb, depth, ""), (rgb0, depth0, "0")):
                if noise is not None:
                    rgb_l = rgb_l + step_lib.NOISE_STD * noise["rgb" + nk][:p]
                    depth_l = depth_l + far * step_lib.NOISE_STD * noise[
                        "depth" + nk][:p]
                mono, ssim_v, lp = losses_lib._patch_terms(
                    rgb_l, depth_l, batch_p, cfg, lpips_params)
                loss = (loss + cfg.mono_depth_loss_mult * mono
                        - cfg.patch_ssim_loss_mult * ssim_v
                        + cfg.patch_lpips_loss_mult * lp)
            loss.backward()
            rgb_full = torch.cat([rgb.detach(), rgb_r], 0)
            depth_full = torch.cat([depth.detach(), depth_r], 0)
            rgb0_full = torch.cat([rgb0.detach(), rgb0_r], 0)
            depth0_full = torch.cat([depth0.detach(), depth0_r], 0)
        else:
            rgb_full, depth_full = rgb_r, depth_r
            rgb0_full, depth0_full = rgb0_r, depth0_r

        # The kernel's explicit weight grads join autograd's.
        interop.add_flat_grads(model.coarse, dw_c, net_depth)
        interop.add_flat_grads(model.fine, dw_f, net_depth)

        with torch.no_grad():
            outputs = {"rgb": rgb_full, "depth": depth_full,
                       "rgb0": rgb0_full, "depth0": depth0_full}
            if noise is not None:
                outputs = step_lib.apply_output_noise(outputs, cfg, noise)
            _, stats = losses_lib.vanilla_losses(outputs, batch, cfg, far,
                                                 1.0, lpips_params)
        return state, step_lib.finish_step(state, stats, cfg)

    return train_step
