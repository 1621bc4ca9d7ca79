"""One-pass kernels: per level, the MLP forward, volumetric compositing,
the per-ray loss cotangent and the backward in one launch, and the train
steps built on them: the vanilla level (`csrc/onepass_level.cu`, kernel
#3) and the mip level (`csrc/onepass_mip_level.cu`, kernel #5, at the end
of this module); and the render's forward-only level
(`csrc/render_level.cu`, kernel #4, `render_level_T`).

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
from consistentnerf_tpu_torch.models import mlp as mlp_lib
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops import fused_mip
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
from consistentnerf_tpu_torch.ops import pdf_merge
from consistentnerf_tpu_torch.train import losses as losses_lib
from consistentnerf_tpu_torch.train import step as step_lib

KERNEL = "onepass_level"
# Kernel launches since import (or since the caller last reset it).
launches = 0


def model_skips(net_depth: int, skips=(4,)) -> tuple:
    """The skips that take effect at this depth. A skip after the last
    trunk layer feeds the heads [pe | h], as in the JAX NeRFMLP."""
    return tuple(s for s in skips if s < net_depth)


def heads_read_pe(net_depth: int, skips=(4,)) -> bool:
    """Whether a skip follows the last trunk layer, so the heads read
    [pe | h] (netdepth 5 with the NeRFMLP's skip after layer 4). Only the
    v1 kernels (#12-#14) take that shape; the v2 walks (#1-#4, #10, #11)
    read heads on h alone, and the JAX package's v2 kernels fail on it
    with a shape error, so the dispatch sends such a config elsewhere."""
    return net_depth - 1 in model_skips(net_depth, skips)


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
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
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
    ws, part, gpart, dw = v2.level_buffers(
        plan, (n_rays, seg, *cfg_args, use_bf16), packed, dev)
    dn_, crgb_, cd__, prior_ = per_ray
    err = fn(pts_T.data_ptr(), views_T.data_ptr(), z.data_ptr(),
             dn_.data_ptr(), crgb_.data_ptr(), tgt_T.data_ptr(),
             cd__.data_ptr(), prior_.data_ptr(), packed.w.data_ptr(),
             packed.b.data_ptr(), out.data_ptr(), ws.data_ptr(),
             part.data_ptr(), gpart.data_ptr(), dw.data_ptr(), n_rays, seg,
             *cfg_args, int(white_bkgd), use_bf16,
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


RENDER_KERNEL = "render_level"
# Launches of the render level kernel since import (or since the caller
# last reset it).
render_launches = 0


def plain_render_level_T(weights, pts_T, views_T, z_row, dn_row, *,
                         seg: int, net_depth: int = 8, skips: tuple = (4,),
                         multires: int = 10, multires_views: int = 4,
                         white_bkgd: bool = False,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """The plain version of `render_level_T` on any device: the plain
    forward (`fused_mlp_v2.plain_fwd_T`) and `_composite_fwd`."""
    n = pts_T.shape[1] // seg
    raw = v2.plain_fwd_T(weights, pts_T, views_T, net_depth, skips,
                         multires, multires_views, fm.as_dtype(compute_dtype))
    rgb, depth, acc, w, _ = _composite_fwd(
        raw.reshape(4, n, seg), z_row.reshape(n, seg), dn_row[0, ::seg],
        white_bkgd)
    return _out_rows(rgb, depth, acc, w, seg)


@functools.cache
def _render_kernel():
    fn = _build.load(RENDER_KERNEL).render_level
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def render_level_T(weights, pts_T: torch.Tensor, views_T: torch.Tensor,
                   z_row: torch.Tensor, dn_row: torch.Tensor, *, seg: int,
                   net_depth: int = 8, skips: tuple = (4,),
                   multires: int = 10, multires_views: int = 4,
                   white_bkgd: bool = False,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """The render's level (kernel #4): MLP forward and compositing of
    whole rays, no gradients. pts/views [3, N*S], z and ||d|| rows
    [1, N*S] (||d|| per ray, broadcast per point). Returns out_rows
    [6, N*S] fp32: rgb map 0-2, depth 3 and acc 4 broadcast per ray, each
    point's compositing weight 5. `weights`: the flat torch-layout list
    or a `fused_mlp_v2.PackedMLP`. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    npts = pts_T.shape[1]
    if npts % seg:
        raise ValueError(f"{npts} points are not whole rays of {seg} samples")
    kw = dict(seg=seg, net_depth=net_depth, skips=skips, multires=multires,
              multires_views=multires_views, white_bkgd=white_bkgd,
              compute_dtype=cd)
    if pts_T.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            v2._packed_for(weights, net_depth, skips, multires,
                           multires_views, cd)
        return plain_render_level_T(weights, pts_T, views_T, z_row, dn_row,
                                    **kw)
    if pts_T.device.type != "cuda":
        raise ValueError(f"no render level kernel for device {pts_T.device}")
    packed = v2._packed_for(weights, net_depth, skips, multires,
                            multires_views, cd)
    dev, n_rays = pts_T.device, npts // seg
    v2._check_stream("pts_T", pts_T, 3, npts, dev)
    v2._check_stream("views_T", views_T, 3, npts, dev)
    v2._check_stream("z_row", z_row, 1, npts, dev)
    v2._check_stream("dn_row", dn_row, 1, npts, dev)
    for t in (packed.w, packed.b):
        if t.device != dev:
            raise ValueError("packed weights are not on the points' device")
    out = torch.empty((6, npts), dtype=torch.float32, device=dev)
    if n_rays == 0:
        return out
    dn = dn_row[0, ::seg].contiguous()
    err = _render_kernel()(
        pts_T.data_ptr(), views_T.data_ptr(), z_row.data_ptr(),
        dn.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
        out.data_ptr(), n_rays, seg, net_depth, packed.width,
        sum(1 << s for s in skips), multires, multires_views,
        int(white_bkgd), int(cd == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{RENDER_KERNEL} launch failed: cudaError_t "
                           f"{err}")
    global render_launches
    render_launches += 1
    return out


def onepass_supported(cfg) -> bool:
    """Whether the one-pass step computes cfg's exact loss: per-ray terms
    with parameter-independent denominators (the JAX predicate,
    fused_onepass.py:590-615, term for term). softLpmask's two
    prediction-dependent denominators cannot share one dW accumulation;
    `train/loop.py::select_train_step` sends it to the two-call step. The
    lane limits on multires are the TPU kernel's; the CUDA kernel could
    run past them, but a config must pick the counterpart step in both
    packages. (The step itself still raises for ss_loss: ROADMAP Queue 1,
    consistency.)"""
    return (cfg.backbone == "vanilla" and cfg.use_viewdirs
            and cfg.N_importance > 0 and not cfg.softLpmask
            and 3 * cfg.multires <= 60 and 3 * cfg.multires_views <= 60)


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


# ---------------------------------------------------------------------------
# The mip level (kernel #5) and the mip train step built on it
# ---------------------------------------------------------------------------

MIP_KERNEL = "onepass_mip_level"
# Launches of the mip level kernel since import (or since the caller last
# reset it).
mip_launches = 0


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, -1) - x


def _mip_composite_fwd(raw, tmid, delta, tlo, thi, white_bkgd: bool,
                       rgb_padding: float, density_bias: float,
                       noise=None):
    """The kernel's mip compositing (fused_onepass.py:307-350, the
    semantics of `compute_alpha_weights` + `volumetric_rendering`'s rgb
    and distance_mean) with the head activations. raw [4, N, S]; tmid,
    delta [N, S]; tlo, thi [N]; `noise` [N, S] is added to the density
    logit. Returns (rgb [N, 3], dist [N], acc [N], w [N, S], saved)."""
    s_rgb = torch.sigmoid(raw[:3])
    c = s_rgb * (1.0 + 2.0 * rgb_padding) - rgb_padding
    x_d = raw[3] + density_bias
    if noise is not None:
        x_d = x_d + noise
    density = mlp_lib.softplus(x_d)
    dd = density * delta
    alpha = 1.0 - torch.exp(-dd)
    trans = torch.exp(-_excl_cumsum(dd))
    w = alpha * trans
    acc = w.sum(1)
    rgb = (w[None] * c).sum(2).T
    if white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    acc_s = torch.clamp(acc, min=1e-37)
    valid = acc > 0
    # acc == 0: 0/0 -> nan -> inf -> clipped to thi in the XLA chain.
    dist_u = torch.where(valid, (w * tmid).sum(1) / acc_s, thi)
    in_rng = (dist_u > tlo) & (dist_u < thi) & valid
    # The clip passes the cotangent only strictly inside its range.
    dist = torch.where(in_rng, dist_u,
                       torch.clamp(dist_u, tlo, thi).detach())
    saved = dict(s_rgb=s_rgb, c=c, sigd=torch.sigmoid(x_d), alpha=alpha,
                 trans=trans, w=w, delta=delta, tmid=tmid, acc_s=acc_s,
                 dist_u=dist_u, in_rng=in_rng)
    return rgb, dist, acc, w, saved


def _mip_composite_bwd(d_rgb, d_dist, saved, white_bkgd: bool,
                       rgb_padding: float) -> torch.Tensor:
    """VJP of `_mip_composite_fwd` into the raw heads
    (fused_onepass.py:353-371). d_rgb [N, 3], d_dist [N] -> [4, N, S]."""
    c, w, trans, alpha = saved["c"], saved["w"], saved["trans"], \
        saved["alpha"]
    d_acc = -d_rgb.sum(1, keepdim=True) if white_bkgd else 0.0
    d_su = torch.where(saved["in_rng"], d_dist, torch.zeros_like(d_dist))
    d_w = ((d_rgb.T[:, :, None] * c).sum(0)
           + d_su[:, None] * (saved["tmid"] - saved["dist_u"][:, None])
           / saved["acc_s"][:, None] + d_acc)
    u = d_w * w
    d_dd = d_w * trans * (1.0 - alpha) - (u.flip(1).cumsum(1).flip(1) - u)
    d_raw_d = d_dd * saved["delta"] * saved["sigd"]
    d_raw_rgb = (w[None] * d_rgb.T[:, :, None] * (1.0 + 2.0 * rgb_padding)
                 * saved["s_rgb"] * (1.0 - saved["s_rgb"]))
    return torch.cat([d_raw_rgb, d_raw_d[None]], 0)


def _mip_loss(rgb, dist, crgb, tgt, cd, prior):
    return (torch.sum(crgb[:, None] / 2 * (rgb - tgt) ** 2)
            + torch.sum(cd / 2 * (dist - prior) ** 2))


def plain_onepass_mip_level(weights, means_T, covs_T, views_T, tmid, delta,
                            tlo, thi, crgb, tgt, cd, prior, noise=None, *,
                            net_depth, num_freqs, white_bkgd, compute_dtype,
                            rgb_padding=fused_mip.RGB_PADDING,
                            density_bias=fused_mip.DENSITY_BIAS):
    """The plain version of the mip level on per-ray inputs: the MipMLP
    body, `_mip_composite_fwd` and the per-ray MSE, with autograd.
    tmid, delta (and noise) [N, S]; tlo, thi, crgb, cd, prior [N]; tgt
    [N, 3]. Returns (out_rows [6, N*S], torch-layout dW)."""
    n, seg = tmid.shape
    ws = [w.detach().float().requires_grad_()
          for w in fused_mip._flat(weights)]
    with torch.enable_grad():
        raw = fused_mip._mip_body(
            means_T.T, covs_T.T, views_T.T, ws, net_depth=net_depth,
            num_freqs=num_freqs, compute_dtype=compute_dtype)
        rgb, dist, acc, w, _ = _mip_composite_fwd(
            raw.T.reshape(4, n, seg), tmid, delta, tlo, thi, white_bkgd,
            rgb_padding, density_bias, noise)
        grads = torch.autograd.grad(
            _mip_loss(rgb, dist, crgb, tgt, cd, prior), ws)
    return (_out_rows(rgb.detach(), dist.detach(), acc.detach(), w.detach(),
                      seg), list(grads))


def packed_onepass_mip_reference(packed: "v2.PackedMLP", means_T, covs_T,
                                 views_T, tmid, delta, tlo, thi, crgb, tgt,
                                 cd, prior, noise=None, white_bkgd=False,
                                 rgb_padding=fused_mip.RGB_PADDING,
                                 density_bias=fused_mip.DENSITY_BIAS):
    """The kernel's walk over its packed buffers: forward, compositing,
    cotangent, explicit compositing VJP, backward. Same returns as
    `plain_onepass_mip_level`."""
    n, seg = tmid.shape
    raw, saved = v2.packed_forward_saved(packed, means_T, views_T, covs_T)
    rgb, dist, acc, w, comp = _mip_composite_fwd(
        raw.reshape(4, n, seg), tmid, delta, tlo, thi, white_bkgd,
        rgb_padding, density_bias, noise)
    d_raw = _mip_composite_bwd(crgb[:, None] * (rgb - tgt),
                               cd * (dist - prior), comp, white_bkgd,
                               rgb_padding)
    dw, db = v2.packed_backward(packed, saved, d_raw.reshape(4, n * seg))
    return (_out_rows(rgb, dist, acc, w, seg),
            v2.unpack_grads(packed, dw, db))


@functools.cache
def _mip_kernel():
    lib = _build.load(MIP_KERNEL)
    plan = lib.onepass_mip_level_plan
    plan.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    fn = lib.onepass_mip_level
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return plan, fn


def onepass_mip_level(weights, means_T, covs_T, views_T, tmid, delta, tlo,
                      thi, crgb, tgt, cd, prior, noise=None, *,
                      net_depth=8, num_freqs=16, white_bkgd=False,
                      compute_dtype=torch.float32,
                      rgb_padding=fused_mip.RGB_PADDING,
                      density_bias=fused_mip.DENSITY_BIAS):
    """One mip level on per-ray inputs (kernel #5): means/covs/views
    [3, N*S]; tmid, delta, noise (or None) [N, S]; tlo, thi, crgb, cd,
    prior [N]; tgt [N, 3]. Returns (out_rows [6, N*S]: rgb, distance_mean
    and acc broadcast per point, then each point's weight; torch-layout
    dW). CPU tensors take the plain version; CUDA tensors launch the
    kernel (and its dW reduction) or raise."""
    cd_ = fm.as_dtype(compute_dtype)
    kw = dict(white_bkgd=white_bkgd, rgb_padding=rgb_padding,
              density_bias=density_bias)
    if means_T.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            fused_mip._packed_for(weights, net_depth, num_freqs,
                                  fused_mip.DEG_VIEW, cd_)
        return plain_onepass_mip_level(
            weights, means_T, covs_T, views_T, tmid, delta, tlo, thi, crgb,
            tgt, cd, prior, noise, net_depth=net_depth, num_freqs=num_freqs,
            compute_dtype=cd_, **kw)
    if means_T.device.type != "cuda":
        raise ValueError(f"no one-pass kernel for device {means_T.device}")
    packed = fused_mip._packed_for(weights, net_depth, num_freqs,
                                   fused_mip.DEG_VIEW, cd_)
    n_rays, seg = tmid.shape
    npts, dev = n_rays * seg, means_T.device
    fused_mip._check_inputs(packed, dev, npts, means_T=means_T,
                            covs_T=covs_T, views_T=views_T)
    per_point = [x.float().contiguous() for x in (tmid, delta)] + (
        [] if noise is None else [noise.float().contiguous()])
    for name, t in zip(("tmid", "delta", "noise"), per_point):
        v2._check_stream(name, t.reshape(1, -1), 1, npts, dev)
    per_ray = [x.float().contiguous() for x in (tlo, thi, crgb, cd, prior)]
    tgt_T = tgt.T.float().contiguous()
    for name, t, shape in zip(("tlo", "thi", "crgb", "cd", "prior", "tgt"),
                              per_ray + [tgt_T], [(n_rays,)] * 5
                              + [(3, n_rays)]):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must hold {n_rays} rays on {dev}")
    out = torch.empty((6, npts), dtype=torch.float32, device=dev)
    n_w, n_b = v2.grad_numel(packed)
    if n_rays == 0:
        zeros = torch.zeros(n_w + n_b, device=dev)
        return out, v2.unpack_grads(packed, zeros[:n_w], zeros[n_w:])
    cfg_args = fused_mip._cfg_args(packed)
    plan, fn = _mip_kernel()
    ws, part, gpart, dw = v2.level_buffers(plan, (n_rays, seg, *cfg_args),
                                        packed, dev)
    tmid_, delta_ = per_point[:2]
    noise_ptr = per_point[2].data_ptr() if noise is not None else None
    tlo_, thi_, crgb_, cd__, prior_ = per_ray
    err = fn(means_T.data_ptr(), covs_T.data_ptr(), views_T.data_ptr(),
             tmid_.data_ptr(), delta_.data_ptr(), noise_ptr,
             tlo_.data_ptr(), thi_.data_ptr(), crgb_.data_ptr(),
             tgt_T.data_ptr(), cd__.data_ptr(), prior_.data_ptr(),
             packed.w.data_ptr(), packed.b.data_ptr(), out.data_ptr(),
             ws.data_ptr(), part.data_ptr(), gpart.data_ptr(),
             dw.data_ptr(), n_rays, seg,
             *cfg_args[:-1], int(white_bkgd), cfg_args[-1],
             1.0 + 2.0 * rgb_padding, rgb_padding, density_bias,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{MIP_KERNEL} launch failed: cudaError_t {err}")
    global mip_launches
    mip_launches += 1
    return out, v2.unpack_grads(packed, dw[:n_w], dw[n_w:])


def onepass_mip_level_T(weights, means_T, covs_T, views_T, tmid_row,
                        delta_row, tlo_row, thi_row, coeff_rgb, target_rows,
                        coeff_depth, prior_row, noise_row=None, *, seg: int,
                        net_depth: int = 8, num_freqs: int = 16,
                        white_bkgd: bool = False,
                        rgb_padding: float = fused_mip.RGB_PADDING,
                        density_bias: float = fused_mip.DENSITY_BIAS,
                        compute_dtype=torch.float32):
    """One-pass fwd + composite + loss cotangent + bwd of one mip level,
    with the JAX signature: means/covs/views/target [3, N*S], the other
    rows [1, N*S] (per-ray values broadcast per point). Returns (out_rows
    [6, N*S], torch-layout dW list)."""
    n = means_T.shape[1]
    if n % seg:
        raise ValueError(f"{n} points are not whole rays of {seg} samples")
    r = n // seg

    def per_point(row):
        return row.reshape(r, seg).contiguous()

    return onepass_mip_level(
        weights, means_T, covs_T, views_T, per_point(tmid_row),
        per_point(delta_row), tlo_row[0, ::seg], thi_row[0, ::seg],
        coeff_rgb[0, ::seg], target_rows[:, ::seg].T, coeff_depth[0, ::seg],
        prior_row[0, ::seg],
        None if noise_row is None else per_point(noise_row),
        net_depth=net_depth, num_freqs=num_freqs, white_bkgd=white_bkgd,
        compute_dtype=compute_dtype, rgb_padding=rgb_padding,
        density_bias=density_bias)


def mip_onepass_supported(cfg) -> bool:
    """Whether the mip one-pass step computes cfg's exact loss (the JAX
    predicate, fused_onepass.py:1104-1125, term for term): per-ray data
    terms in the kernel, the MiDaS patch rays and the TV norm's
    random-pose rays on the differentiable fused path; extras (disp and
    normal metrics) change the kernel's output contract. The IPE lane
    limit is the TPU kernel's, kept so both packages pick the same
    step."""
    return (cfg.backbone == "mipnerf" and cfg.disable_normals
            and cfg.stop_level_grad and cfg.min_deg_point == 0
            and 3 * cfg.max_deg_point <= 60
            and not cfg.compute_disp_metrics
            and not cfg.compute_normal_metrics)


def build_onepass_mip_train_step(cfg):
    """train_step(state, batch, draws=None) -> (state, stats): the mip
    loss (`train.losses.mip_losses`) with every level of the data rays
    running the one-pass kernel, and the 4x16x16 MiDaS patch rays and the
    TV norm's random-pose rays the differentiable fused forward
    (`ops/fused_train.fused_mip_forward`), their weight grads summed into
    the one MLP's. The stats are `mip_losses` on the assembled outputs.
    `state` is updated in place."""
    from consistentnerf_tpu_torch.ops.fused_train import fused_mip_forward

    step_lib.check_mip_supported(cfg)
    if not mip_onepass_supported(cfg):
        raise ValueError("the mip one-pass step needs disable_normals, "
                         "stop_level_grad, min_deg_point=0, "
                         "max_deg_point <= 20 and no disp or normal "
                         "metrics")
    n_levels, s = cfg.mip_num_levels, cfg.mip_num_samples
    level_mults = [cfg.coarse_loss_mult] * (n_levels - 1) + [1.0]
    # The MiDaS term reads exactly the first 4x16^2 rays.
    p_rays = 4 * 16 * 16 if cfg.compute_mono_depth_metrics else 0
    cdt = fm.as_dtype(cfg.compute_dtype)
    net_depth = cfg.netdepth

    def train_step(state, batch, draws: Optional[Dict] = None):
        model, opt = state.model, state.optimizer
        rays = batch["rays"]
        n, dev = rays.origins.shape[0], rays.origins.device
        p = p_rays
        if n < p:
            raise ValueError(f"a mip batch needs the {p} MiDaS patch rays "
                             f"first; got {n} rays")
        render_random = step_lib.renders_random(cfg, batch)
        if draws is None:
            draws = step_lib.make_mip_step_draws(
                cfg, batch, step_lib.step_generator(cfg.seed, state.step,
                                                    dev), dev)
        padding = step_lib.resample_padding(cfg, state.step)

        lossmult = rays.lossmult[:, 0]
        if cfg.disable_multiscale_loss:
            lossmult = torch.ones_like(lossmult)
        base_crgb = 2.0 * lossmult / (lossmult.sum() + 1e-4)
        if cfg.compute_depth_metrics:
            mask, scale = losses_lib.depth_scale_and_mask(batch, cfg, n, dev)
            base_cd = 2.0 * mask * mask / (scale**2 * n)
            prior = batch["dpts"]
        else:
            base_cd = prior = torch.zeros((n,), device=dev)
        target = batch["rgb"][:, :3]

        params = fused_mip.flatten_mip_params(model.mlp, net_depth)
        flat = [w.detach() for w in params]
        packed = (fused_mip.pack(flat, net_depth, cfg.max_deg_point, cdt)
                  if dev.type == "cuda" else None)

        # ---- one-pass kernel: data rays [p:] ----
        nr = n - p
        rays_r = rays.map(lambda x: x[p:])
        d_r = step_lib.slice_draws(draws, slice(p, n))
        dnorm_r = torch.linalg.norm(rays_r.directions, dim=-1)
        views_r = rays_r.viewdirs.T[:, :, None].expand(3, nr, s).reshape(
            3, nr * s).contiguous()
        mega_out, dw_total = [], None
        t_vals = w_render = None
        with torch.no_grad():
            for lvl in range(n_levels if nr > 0 else 0):
                if lvl == 0:
                    t_vals, (means_T, covs_T) = sampling.sample_along_rays(
                        d_r.get("t_rand"), rays_r.origins,
                        rays_r.directions, rays_r.radii, s, rays_r.near,
                        rays_r.far, cfg.genspace_fn, cfg.ray_shape,
                        transposed=True)
                else:
                    jitter = d_r.get("jitter")
                    t_vals, (means_T, covs_T) = \
                        sampling.resample_along_rays(
                            None if jitter is None else jitter[lvl],
                            rays_r.origins, rays_r.directions, rays_r.radii,
                            t_vals, w_render, cfg.ray_shape,
                            cfg.stop_level_grad, padding, transposed=True,
                            use_kernel=cfg.use_pdf_kernel)
                if cfg.disable_integration:
                    covs_T = torch.zeros_like(covs_T)
                noise = d_r.get("noise")
                if noise is not None and cfg.density_noise > 0:
                    noise = cfg.density_noise * noise[lvl]
                else:
                    noise = None
                lw = level_mults[lvl]
                out_rows, dws = onepass_mip_level(
                    packed if packed is not None else flat,
                    means_T.reshape(3, nr * s).contiguous(),
                    covs_T.reshape(3, nr * s).contiguous(), views_r,
                    0.5 * (t_vals[:, :-1] + t_vals[:, 1:]),
                    (t_vals[:, 1:] - t_vals[:, :-1]) * dnorm_r[:, None],
                    t_vals[:, 0], t_vals[:, -1], lw * base_crgb[p:],
                    target[p:], 0.1 * lw * base_cd[p:], prior[p:], noise,
                    net_depth=net_depth, num_freqs=cfg.max_deg_point,
                    white_bkgd=cfg.white_bkgd, compute_dtype=cdt)
                w_render = out_rows[5].reshape(nr, s)
                per_ray = out_rows[:, ::s]
                mega_out.append(dict(rgb=per_ray[:3].T,
                                     distance_mean=per_ray[3]))
                dw_total = dws if dw_total is None else [
                    a + b for a, b in zip(dw_total, dws)]

        # ---- patch rays [:p]: differentiable fused forward + autograd ----
        opt.zero_grad()
        loss = None
        patch_out = None
        if p > 0:
            patch_out = fused_mip_forward(
                params, step_lib.slice_draws(draws, slice(0, p)),
                rays.map(lambda x: x[:p]), cfg, resample_padding=padding,
                packed=packed)
            loss = 0.0
            for lvl, r in enumerate(patch_out):
                lw = level_mults[lvl]
                loss = loss + torch.sum(lw * base_crgb[:p, None] / 2.0
                                        * (r["rgb"] - target[:p]) ** 2)
                loss = loss + torch.sum(0.1 * lw * base_cd[:p] / 2.0
                                        * (r["distance_mean"] - prior[:p])
                                        ** 2)
                mono = losses_lib.midas_patch_loss(
                    r["distance_mean"].reshape(-1),
                    batch["mono_dpts"].reshape(-1), 16, 4)
                if cfg.dataset_type == "blender":
                    mono = mono * 0.01
                loss = loss + 0.1 * lw * mono
        renders_r = None
        if render_random:
            renders_r = fused_mip_forward(
                params, draws.get("random"), batch["rays_random"], cfg,
                resample_padding=padding, compute_extras=True,
                packed=packed)
            tvw = [cfg.coarse_loss_mult] * (n_levels - 1) + [
                step_lib.tvnorm_weight(cfg, state.step)]
            for lvl, r in enumerate(renders_r):
                tv = tvw[lvl] * losses_lib.tv_level_loss(r, cfg)
                loss = tv if loss is None else loss + tv
        if cfg.weight_decay_mult != 0:
            all_params = list(model.parameters())
            wd = cfg.weight_decay_mult * sum(
                torch.sum(q**2) for q in all_params) / sum(
                q.numel() for q in all_params)
            loss = wd if loss is None else loss + wd
        if loss is not None:
            loss.backward()
        if dw_total is not None:
            interop.add_flat_grads(model.mlp, dw_total, net_depth)

        with torch.no_grad():
            renderings = []
            for lvl in range(n_levels):
                parts = [patch_out[lvl]] if p > 0 else []
                parts += [mega_out[lvl]] if nr > 0 else []
                renderings.append({k: torch.cat([x[k].detach()
                                                 for x in parts], 0)
                                   for k in ("rgb", "distance_mean")})
            _, stats = losses_lib.mip_losses(
                renderings, renders_r, batch, model.parameters(), cfg,
                step_lib.tvnorm_weight(cfg, state.step))
        return state, step_lib.finish_step(state, stats, cfg)

    return train_step
