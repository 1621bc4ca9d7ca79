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

With `ss_loss` (`consistency/online.py`) the vanilla step also runs the
reference rays (all N of them) through a coarse and a fine launch of the
level kernel, with the masked-MSE coefficient rows of the ss term, and
the gate of the main RGB loss swaps the fine level's rgb coefficient
rows; their weight grads join the main levels'.

Under a mesh (`parallel/mesh.py`) each rank launches the levels on its
rows of the global batch: the counterpart of the JAX `_shard_onepass`.
"""

from __future__ import annotations

import ctypes
import functools
import math
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
from consistentnerf_tpu_torch.parallel import mesh as mesh_lib
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
                             crgb, tgt, cd, prior, white_bkgd,
                             mm=torch.matmul):
    """The kernel's walk over its packed buffers: forward, compositing,
    cotangent, explicit compositing VJP, backward (`mm`: the backward's
    products, `v2.six_products` for the fp32 walk). Same returns as
    `plain_onepass_level`."""
    n, seg = z.shape
    raw, saved = v2.packed_forward_saved(packed, pts_T, views_T)
    rgb, depth, acc, w, comp = _composite_fwd(raw.reshape(4, n, seg), z, dn,
                                              white_bkgd)
    d_rgb = crgb[:, None] * (rgb - tgt)
    d_depth = cd * (depth - prior)
    d_raw = _composite_bwd(d_rgb, d_depth, comp, white_bkgd)
    dw, db = v2.packed_backward(packed, saved, d_raw.reshape(4, n * seg),
                                mm)
    return (_out_rows(rgb, depth, acc, w, seg),
            v2.unpack_grads(packed, dw, db))


@functools.cache
def _kernel():
    lib = _build.load(KERNEL)
    plan = lib.onepass_level_plan
    plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    fn = lib.onepass_level
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
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
    v2.check_planes(packed)
    v2.check_tma_weights(packed)
    plan, fn = _kernel()
    ws, part, gpart, dw = v2.level_buffers(
        plan, (n_rays, seg, *cfg_args, use_bf16), packed, dev)
    dn_, crgb_, cd__, prior_ = per_ray
    err = fn(pts_T.data_ptr(), views_T.data_ptr(), z.data_ptr(),
             dn_.data_ptr(), crgb_.data_ptr(), tgt_T.data_ptr(),
             cd__.data_ptr(), prior_.data_ptr(), packed.w.data_ptr(),
             None if packed.w3 is None else packed.w3.data_ptr(),
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


# `render_level_plan`'s slots: the Hopper walk (1) or the old kernel (0),
# points, tiles and rays a group (the old kernel: a chunk's points, 0, its
# rays), shared memory, blocks, ring slots, groups.
RENDER_PLAN_SLOTS = ("hopper", "group_points", "group_tiles", "group_rays",
                     "smem_bytes", "blocks", "stages", "groups")
FH_TILE = 128  # points a tile of the Hopper walk (csrc/fwd_hopper.cuh)


def render_group(seg: int) -> tuple:
    """#4's group on the Hopper walk (`csrc/render_level.cu::
    group_points`): (points, tiles, rays) of lcm(seg, 128) points, whole
    rays in whole tiles."""
    gp = seg // math.gcd(seg, FH_TILE) * FH_TILE
    return gp, gp // FH_TILE, gp // seg


def render_smem_bytes(packed: "v2.PackedMLP", seg: int):
    """The shared memory of #4's Hopper walk for `packed` (a NeRFMLP) and
    groups of `render_group(seg)` points, as `csrc/fwd_hopper.cuh::FhSmem`
    lays it out, with `fh_plan`'s choice (two pe buffers, else one; a
    3-slot weight ring, else 2): (bytes, ring slots, pe buffers), or None
    where nothing fits `fused_mlp.SMEM_LIMIT` (the old kernel runs)."""
    w, h, depth = packed.width, packed.width // 2, packed.net_depth
    p = v2._pad16(v2.enc_widths("pe", packed.multires,
                                packed.multires_views)[0])
    na, pp = max(w // 64, -(-h // 64)), -(-p // 64)
    gp = render_group(seg)[0]
    panel, box = FH_TILE * 128, 8192
    bias = 4 * ((depth + 1) * w + -(-h // 64) * 64)
    for npe in (2, 1):
        for stages in (3, 2):
            total = (stages * na * box + na * panel + npe * pp * panel
                     + panel + bias + -(-2 * w // 16) * 16
                     + -(-6 * h // 16) * 16 + (2 * stages + 6) * 8
                     + 20 * 12 + 16 * gp + 16 + 1024)
            if total <= fm.SMEM_LIMIT:
                return total, stages, npe
    return None


def render_plan(packed: "v2.PackedMLP", n_rays: int, seg: int) -> dict:
    """The walk that #4 takes for n_rays rays of seg samples of `packed`,
    decided by shapes alone (`render_level_plan`; `RENDER_PLAN_SLOTS`);
    needs the card."""
    out = (ctypes.c_longlong * len(RENDER_PLAN_SLOTS))()
    err = v2._entry(RENDER_KERNEL, RENDER_KERNEL + "_plan", 0, 8)(
        n_rays, seg, *v2._cfg_ints(packed), out)
    if err != 0:
        raise RuntimeError(f"{RENDER_KERNEL} plan failed: cudaError_t {err}")
    return dict(zip(RENDER_PLAN_SLOTS, list(out)))


def render_launch(packed: "v2.PackedMLP", pts_T, views_T, z_row, dn_row,
                  seg: int, white_bkgd: bool) -> torch.Tensor:
    """Kernel #4 on the device's streams (no plain version): checks them,
    launches and returns out_rows [6, N*S]."""
    dev, npts = pts_T.device, pts_T.shape[1]
    n_rays = npts // seg
    v2._check_stream("pts_T", pts_T, 3, npts, dev)
    v2._check_stream("views_T", views_T, 3, npts, dev)
    v2._check_stream("z_row", z_row, 1, npts, dev)
    v2._check_stream("dn_row", dn_row, 1, npts, dev)
    v2._check_weights(packed, dev)
    v2.check_tma_weights(packed)
    out = torch.empty((6, npts), dtype=torch.float32, device=dev)
    if n_rays == 0:
        return out
    dn = dn_row[0, ::seg].contiguous()
    err = v2._entry(RENDER_KERNEL, RENDER_KERNEL, 7, 9)(
        pts_T.data_ptr(), views_T.data_ptr(), z_row.data_ptr(),
        dn.data_ptr(), packed.w.data_ptr(), packed.b.data_ptr(),
        out.data_ptr(), n_rays, seg, *v2._cfg_ints(packed)[:5],
        int(white_bkgd), int(packed.compute_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{RENDER_KERNEL} launch failed: cudaError_t "
                           f"{err}")
    global render_launches
    render_launches += 1
    return out


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
    return render_launch(packed, pts_T, views_T, z_row, dn_row, seg,
                         white_bkgd)


def onepass_supported(cfg) -> bool:
    """Whether the one-pass step computes cfg's exact loss: per-ray terms
    with parameter-independent denominators (the JAX predicate,
    fused_onepass.py:590-615, term for term). softLpmask's two
    prediction-dependent denominators cannot share one dW accumulation;
    `train/loop.py::select_train_step` sends it to the two-call step. The
    lane limits on multires are the TPU kernel's; the CUDA kernel could
    run past them, but a config must pick the counterpart step in both
    packages. The ss_loss term is supported: its consistency weight is a
    function of the batch alone, so its gate swaps coefficient rows and
    its reference rays take their own pair of level launches."""
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


def build_onepass_vanilla_train_step(cfg, lpips_params=None, mesh=None):
    """train_step(state, batch, draws=None) -> (state, stats): the vanilla
    ConsistentNeRF loss with both MLP levels running the one-pass kernel
    on the non-patch rays and the differentiable fused MLP on the patch
    rays. Loss semantics of `train.losses.vanilla_losses`
    (run_nerf_view.py:1645-1906); the stats are computed by it on the
    assembled outputs, and with ss_loss assembled again through
    `step_lib.apply_ss_loss`. `state` is updated in place.

    Under a mesh (the JAX package's `_shard_onepass`, fused_onepass.py:
    649-672) `batch` is the global batch: each rank launches the levels
    on its rows (`parallel/mesh.py::data_slice`) with the per-ray
    coefficients of the global batch, runs its part of the patch rays on
    the fused MLP, and computes the patch terms on the gathered patch
    outputs, whose cotangents reach the rank that owns each ray; the
    weight grads are summed over ranks in `finish_step`."""
    from consistentnerf_tpu_torch.consistency import online

    step_lib.check_kernel_step(cfg)
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
        n, dev = batch["rgb"].shape[0], batch["rgb"].device
        p = n_patch_rays
        if draws is None:
            draws = step_lib.make_draws(
                cfg, n, step_lib.step_generator(cfg.seed, state.step, dev),
                dev)
        ls = torch.as_tensor(batch.get("loss_scale", 1.0), dtype=torch.float32,
                             device=dev)
        mask, target, prior = batch["mask"], batch["rgb"], batch["depth"]
        ones = torch.ones((n,), device=dev)

        # Per-ray loss-cotangent coefficients of the global batch (global
        # denominators, parameter-independent; every rank holds the
        # global batch, so a rank without a mask-true ray gets them too).
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

        # ss_loss (run_nerf_view_test.py:944-967): the consistency weight
        # is a function of the batch alone, so the gate swaps the fine
        # level's rgb coefficient rows for the masked-MSE ones, and the
        # reference rays get their own level launches below.
        ss_on = step_lib.has_ss(cfg, batch)
        coeff_rgb_f = coeff_rgb
        if ss_on:
            ss_draws = draws["ss"]
            ref = online.batch_ref_rays(batch, cfg)
            w_ss = ref["weight"]
            s1 = w_ss.sum()
            gated_coeff = torch.where(
                3.0 * s1 > 0, 2.0 * w_ss / torch.clamp(3.0 * s1, min=1.0),
                zero)
            coeff_rgb_f = torch.where(ss_draws["gate"], ls * gated_coeff,
                                      coeff_rgb)

        # This rank's rows [a, a + nl): its first pl rows are patch rays.
        sl = mesh_lib.data_slice(n, mesh)
        nl = sl.stop - sl.start
        pl = min(max(p - sl.start, 0), nl)
        nr = nl - pl
        coeff_rgb, coeff_rgb_f, coeff_d, tgt_f, tgt_c, pri_f, pri_c = (
            x[sl] for x in (coeff_rgb, coeff_rgb_f, coeff_d, tgt_f, tgt_c,
                            pri_f, pri_c))
        d_loc = mesh_lib.shard_tree(draws, n, sl)
        t_rand, u = d_loc.get("t_rand"), d_loc.get("u")
        rays = step_lib.rays_from_batch(mesh_lib.shard_batch(batch, mesh),
                                        cfg.near, cfg.far)

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

        # ---- one-pass kernel: local rays [pl:] ----
        def level(src, rays_T, z_sub, dn, crgb, tgt, cd, pri):
            pts, views = _pts_views(*rays_T, z_sub)
            return onepass_level(
                src, pts, views, z_sub.contiguous(), dn, crgb, tgt, cd, pri,
                white_bkgd=cfg.white_bkgd, compute_dtype=cdt, **mlp_kw)

        def mega(src, z_sub, crgb, tgt, pri):
            q = pl
            return level(src, (o_T[:, q:], d_T[:, q:], v_T[:, q:]), z_sub,
                         dnorm[q:], crgb[q:], tgt[q:], coeff_d[q:], pri[q:])

        def maps(out_rows, seg):
            per_ray = out_rows[:, ::seg]
            return per_ray[:3].T, per_ray[3], per_ray[4]

        dw_c = dw_f = None
        if nr > 0:
            with torch.no_grad():
                out_c, dw_c = mega(src_c, z_c[pl:], coeff_rgb, tgt_c, pri_c)
                z_f_r = pdf_merge.fine_z_vals(
                    z_c[pl:], out_c[5].reshape(nr, s_c), s_i,
                    u=None if det else u[pl:], det=det,
                    use_kernel=cfg.use_pdf_kernel)
                out_f, dw_f = mega(src_f, z_f_r, coeff_rgb_f, tgt_f, pri_f)
            rgb_r, depth_r, _ = maps(out_f, s_f)
            rgb0_r, depth0_r, _ = maps(out_c, s_c)

        # ---- ss_loss: the reference rays, one launch a level ----
        ref_outputs = None
        if ss_on:
            with torch.no_grad():
                d_ref = ref["directions"][sl]
                dn_ref = torch.linalg.norm(d_ref, dim=-1)
                v_ref = d_ref / torch.clamp(dn_ref[:, None], min=1e-12)
                ref_T = (ref["origins"][sl].T.contiguous(),
                         d_ref.T.contiguous(), v_ref.T.contiguous())
                mult = cfg.ss_loss_mult
                cr_ref = mult * gated_coeff  # the masked-MSE rgb rows
                if cfg.with_depth_loss:
                    cd_ref = mult * torch.where(
                        s1 > 0, 2.0 * w_ss / torch.clamp(s1, min=1.0), zero)
                    pri_ref = ref["depth_target"]
                else:
                    cd_ref, pri_ref = zero, zero
                cr_ref, cd_ref, pri_ref, tgt_ref = (
                    x[sl] for x in (cr_ref, cd_ref, pri_ref,
                                    ref["rgb_target"]))
                ss_loc = d_loc["ss"]
                ones_r = torch.ones((nl, 1), device=dev)
                z_c_ref = sampling.vanilla_z_vals(
                    ones_r * cfg.near, ones_r * cfg.far, s_c, cfg.lindisp,
                    ss_loc.get("t_rand"))
                out_rc, dw_rc = level(src_c, ref_T, z_c_ref, dn_ref, cr_ref,
                                      tgt_ref, cd_ref, pri_ref)
                z_f_ref = pdf_merge.fine_z_vals(
                    z_c_ref, out_rc[5].reshape(nl, s_c), s_i,
                    u=None if det else ss_loc["u"], det=det,
                    use_kernel=cfg.use_pdf_kernel)
                out_rf, dw_rf = level(src_f, ref_T, z_f_ref, dn_ref, cr_ref,
                                      tgt_ref, cd_ref, pri_ref)
            dw_c = dw_rc if dw_c is None else [
                a + b for a, b in zip(dw_c, dw_rc)]
            dw_f = dw_rf if dw_f is None else [
                a + b for a, b in zip(dw_f, dw_rf)]
            rgb_rf, depth_rf, _ = maps(out_rf, s_f)
            rgb_rc, depth_rc, _ = maps(out_rc, s_c)
            ref_outputs = mesh_lib.gather_outputs(
                {"rgb": rgb_rf, "depth": depth_rf, "rgb0": rgb_rc,
                 "depth0": depth_rc}, mesh, nl)

        # ---- patch rays [:pl]: differentiable fused MLP + autograd ----
        opt.zero_grad()
        loss = None
        if pl > 0:
            def level(flat, src, z_sub):
                pts, views = _pts_views(o_T[:, :pl], d_T[:, :pl],
                                        v_T[:, :pl], z_sub)
                raw = v2.fused_mlp_v2_train_T(
                    flat, pts, views, compute_dtype=cdt,
                    packed=src if isinstance(src, v2.PackedMLP) else None,
                    **mlp_kw)
                return rendering.raw2outputs_T(
                    raw.reshape(4, pl, z_sub.shape[1]), z_sub,
                    rays.directions[:pl], None, cfg.white_bkgd)

            rgb0, _, _, w_p, depth0 = level(flat_c, src_c, z_c[:pl])
            z_all = pdf_merge.fine_z_vals(
                z_c[:pl], w_p, s_i, u=None if det else u[:pl], det=det,
                use_kernel=cfg.use_pdf_kernel)
            rgb, _, _, _, depth = level(flat_f, src_f, z_all)

            def share(rgb_l, depth_l, crgb, tgt, pri):
                return (torch.sum(crgb[:pl, None] / 2.0
                                  * (rgb_l - tgt[:pl]) ** 2)
                        + torch.sum(coeff_d[:pl] / 2.0
                                    * (depth_l - pri[:pl]) ** 2))

            loss = (share(rgb, depth, coeff_rgb_f, tgt_f, pri_f)
                    + share(rgb0, depth0, coeff_rgb, tgt_c, pri_c))
            local = {"rgb": rgb, "depth": depth, "rgb0": rgb0,
                     "depth0": depth0}
            if nr > 0:
                local = {k: torch.cat([v, r], 0) for (k, v), r in zip(
                    local.items(), (rgb_r, depth_r, rgb0_r, depth0_r))}
        else:
            local = {"rgb": rgb_r, "depth": depth_r, "rgb0": rgb0_r,
                     "depth0": depth0_r}
        # Every rank's rows; the patch terms read the first p of them,
        # whose cotangents flow back to the rank that owns each ray.
        full = mesh_lib.gather_outputs(local, mesh, nl)
        if p > 0:
            batch_p = {"rgb": target[:p], "mono_disp": batch["mono_disp"][:p]}
            for nk in ("", "0"):
                rgb_l, depth_l = full["rgb" + nk][:p], full["depth" + nk][:p]
                if noise is not None:
                    rgb_l = rgb_l + step_lib.NOISE_STD * noise["rgb" + nk][:p]
                    depth_l = depth_l + far * step_lib.NOISE_STD * noise[
                        "depth" + nk][:p]
                mono, ssim_v, lp = losses_lib._patch_terms(
                    rgb_l, depth_l, batch_p, cfg, lpips_params)
                terms = (cfg.mono_depth_loss_mult * mono
                         - cfg.patch_ssim_loss_mult * ssim_v
                         + cfg.patch_lpips_loss_mult * lp)
                loss = terms if loss is None else loss + terms
        if loss is not None and loss.requires_grad:
            loss.backward()

        # The kernel's explicit weight grads join autograd's.
        if dw_c is not None:
            interop.add_flat_grads(model.coarse, dw_c, net_depth)
            interop.add_flat_grads(model.fine, dw_f, net_depth)

        with torch.no_grad():
            outputs = {k: v.detach() for k, v in full.items()}
            if noise is not None:
                outputs = step_lib.apply_output_noise(outputs, cfg, noise)
            loss, stats = losses_lib.vanilla_losses(outputs, batch, cfg,
                                                    far, 1.0, lpips_params)
            if ss_on:
                # The gated loss and stats through apply_ss_loss itself;
                # its "forward" returns the reference levels' maps.
                step_lib.apply_ss_loss(lambda _rays, _d: ref_outputs, batch,
                                       cfg, outputs, loss, stats, ss_draws)
        return state, step_lib.finish_step(state, stats, cfg, mesh)

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
                                 density_bias=fused_mip.DENSITY_BIAS,
                                 mm=torch.matmul):
    """The kernel's walk over its packed buffers: forward, compositing,
    cotangent, explicit compositing VJP, backward (`mm`: the backward's
    products, `v2.six_products` for the fp32 walk). Same returns as
    `plain_onepass_mip_level`."""
    n, seg = tmid.shape
    raw, saved = v2.packed_forward_saved(packed, means_T, views_T, covs_T)
    rgb, dist, acc, w, comp = _mip_composite_fwd(
        raw.reshape(4, n, seg), tmid, delta, tlo, thi, white_bkgd,
        rgb_padding, density_bias, noise)
    d_raw = _mip_composite_bwd(crgb[:, None] * (rgb - tgt),
                               cd * (dist - prior), comp, white_bkgd,
                               rgb_padding)
    dw, db = v2.packed_backward(packed, saved, d_raw.reshape(4, n * seg),
                                mm)
    return (_out_rows(rgb, dist, acc, w, seg),
            v2.unpack_grads(packed, dw, db))


@functools.cache
def _mip_kernel():
    lib = _build.load(MIP_KERNEL)
    plan = lib.onepass_mip_level_plan
    plan.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    plan.restype = ctypes.c_int
    fn = lib.onepass_mip_level
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 10
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
    v2.check_planes(packed)
    v2.check_tma_weights(packed)
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
             packed.w.data_ptr(),
             None if packed.w3 is None else packed.w3.data_ptr(),
             packed.b.data_ptr(), out.data_ptr(),
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


def build_onepass_mip_train_step(cfg, mesh=None):
    """train_step(state, batch, draws=None) -> (state, stats): the mip
    loss (`train.losses.mip_losses`) with every level of the data rays
    running the one-pass kernel, and the 4x16x16 MiDaS patch rays and the
    TV norm's random-pose rays the differentiable fused forward
    (`ops/fused_train.fused_mip_forward`), their weight grads summed into
    the one MLP's. The stats are `mip_losses` on the assembled outputs.
    `state` is updated in place.

    Under a mesh (JAX fused_onepass.py:1147-1295 under its mesh) `batch` is
    the global batch: each rank runs its rows with the coefficients of the
    global `lossmult.sum()`, its rows of the random-pose rays, and the
    MiDaS and TV terms on the gathered outputs; the weight decay's
    gradient is added once."""
    from consistentnerf_tpu_torch.ops.fused_train import fused_mip_forward

    if not mip_onepass_supported(cfg):
        raise ValueError("the mip one-pass step needs disable_normals, "
                         "stop_level_grad, min_deg_point=0, "
                         "max_deg_point <= 20 and no disp or normal "
                         "metrics")
    if not cfg.use_viewdirs:
        raise ValueError("the mip one-pass step needs the view layer "
                         "(use_viewdirs=true); train/loop.py::select_train_step "
                         "sends use_viewdirs=false to the eager step")
    n_levels, s = cfg.mip_num_levels, cfg.mip_num_samples
    level_mults = [cfg.coarse_loss_mult] * (n_levels - 1) + [1.0]
    # The MiDaS term reads exactly the first 4x16^2 rays.
    p_rays = 4 * 16 * 16 if cfg.compute_mono_depth_metrics else 0
    cdt = fm.as_dtype(cfg.compute_dtype)
    net_depth = cfg.netdepth

    def train_step(state, batch, draws: Optional[Dict] = None):
        model, opt = state.model, state.optimizer
        n, dev = batch["rgb"].shape[0], batch["rgb"].device
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

        # Per-ray coefficients of the global batch: the RGB term's
        # denominator lossmult.sum() + 1e-4 is the global one.
        lossmult = batch["rays"].lossmult[:, 0]
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

        # This rank's rows [a, a + nl): its first pl rows are patch rays.
        sl = mesh_lib.data_slice(n, mesh)
        nl = sl.stop - sl.start
        pl = min(max(p - sl.start, 0), nl)
        base_crgb, base_cd, prior, target = (
            x[sl] for x in (base_crgb, base_cd, prior, target))
        rays = batch["rays"].map(lambda x: x[sl])
        d_loc = mesh_lib.shard_tree(draws, n, sl)

        params = fused_mip.flatten_mip_params(model.mlp, net_depth)
        flat = [w.detach() for w in params]
        packed = (fused_mip.pack(flat, net_depth, cfg.max_deg_point, cdt)
                  if dev.type == "cuda" else None)

        # ---- one-pass kernel: data rays [pl:] ----
        nr = nl - pl
        rays_r = rays.map(lambda x: x[pl:])
        d_r = step_lib.slice_draws(d_loc, slice(pl, nl))
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
                    t_vals[:, 0], t_vals[:, -1], lw * base_crgb[pl:],
                    target[pl:], 0.1 * lw * base_cd[pl:], prior[pl:], noise,
                    net_depth=net_depth, num_freqs=cfg.max_deg_point,
                    white_bkgd=cfg.white_bkgd, compute_dtype=cdt)
                w_render = out_rows[5].reshape(nr, s)
                per_ray = out_rows[:, ::s]
                mega_out.append(dict(rgb=per_ray[:3].T,
                                     distance_mean=per_ray[3]))
                dw_total = dws if dw_total is None else [
                    a + b for a, b in zip(dw_total, dws)]

        # ---- patch rays [:pl]: differentiable fused forward + autograd ----
        opt.zero_grad()
        loss = None
        patch_out = None
        if pl > 0:
            patch_out = fused_mip_forward(
                params, step_lib.slice_draws(d_loc, slice(0, pl)),
                rays.map(lambda x: x[:pl]), cfg, resample_padding=padding,
                packed=packed)
            loss = 0.0
            for lvl, r in enumerate(patch_out):
                lw = level_mults[lvl]
                loss = loss + torch.sum(lw * base_crgb[:pl, None] / 2.0
                                        * (r["rgb"] - target[:pl]) ** 2)
                loss = loss + torch.sum(0.1 * lw * base_cd[:pl] / 2.0
                                        * (r["distance_mean"] - prior[:pl])
                                        ** 2)
        renderings = []
        for lvl in range(n_levels):
            parts = [patch_out[lvl]] if pl > 0 else []
            parts += [mega_out[lvl]] if nr > 0 else []
            renderings.append({k: torch.cat([x[k] for x in parts], 0)
                               for k in ("rgb", "distance_mean")})
        # Every rank's rows; the MiDaS term reads the first p of them,
        # whose cotangents flow back to the rank that owns each ray.
        renderings = mesh_lib.gather_outputs(renderings, mesh, nl)
        if p > 0:
            for lvl, r in enumerate(renderings):
                mono = losses_lib.midas_patch_loss(
                    r["distance_mean"][:p].reshape(-1),
                    batch["mono_dpts"][:p].reshape(-1), 16, 4)
                if cfg.dataset_type == "blender":
                    mono = mono * 0.01
                term = 0.1 * level_mults[lvl] * mono
                loss = term if loss is None else loss + term
        renders_r = None
        if render_random:
            def apply_fn(rays_, d):
                return fused_mip_forward(
                    params, d, rays_, cfg, resample_padding=padding,
                    compute_extras=True, packed=packed)

            renders_r = step_lib.sharded_apply(
                apply_fn, mesh, batch["rays_random"].origins.shape[0])(
                batch["rays_random"], draws.get("random"))
            tvw = [cfg.coarse_loss_mult] * (n_levels - 1) + [
                step_lib.tvnorm_weight(cfg, state.step)]
            for lvl, r in enumerate(renders_r):
                tv = tvw[lvl] * losses_lib.tv_level_loss(r, cfg)
                loss = tv if loss is None else loss + tv
        if cfg.weight_decay_mult != 0:
            # Every rank computes it; its gradient is added once.
            all_params = mesh_lib.once(list(model.parameters()), mesh)
            wd = cfg.weight_decay_mult * sum(
                torch.sum(q**2) for q in all_params) / sum(
                q.numel() for q in all_params)
            loss = wd if loss is None else loss + wd
        if loss is not None and torch.is_tensor(loss) and loss.requires_grad:
            loss.backward()
        if dw_total is not None:
            interop.add_flat_grads(model.mlp, dw_total, net_depth)

        with torch.no_grad():
            renderings = [{k: v.detach() for k, v in r.items()}
                          for r in renderings]
            _, stats = losses_lib.mip_losses(
                renderings, renders_r, batch, model.parameters(), cfg,
                step_lib.tvnorm_weight(cfg, state.step))
        return state, step_lib.finish_step(state, stats, cfg, mesh)

    return train_step
