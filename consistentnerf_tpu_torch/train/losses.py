"""Loss assembly of the vanilla trainer: `vanilla_losses` reproduces the
ConsistentNeRF PyTorch trainer's total loss (`run_nerf_view.py:1577-1906`):
masked RGB MSE, the MiDaS patch loss (x0.001), patch SSIM (x-0.005) and
patch LPIPS (x+0.005), masked depth MSE, each on fine and coarse outputs.
`mip_losses` is the mip / RegNeRF trainer's (`RegNeRF/train.py:97-241`),
with the depth TV norm on random-pose patches (`tv_level_loss`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_losses
from consistentnerf_tpu_torch.consistency.monodepth import midas_patch_loss
from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.train import image_metrics
from consistentnerf_tpu_torch.train import lpips as lpips_mod


def tree_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a collection of tensors."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def _rgb_loss(pred, target, mask, cfg, temp):
    if cfg.hardmask or cfg.softmask:
        # The reference folds softmask into the hardmask branch at
        # run_nerf_view.py:1645 (`if args.hardmask or args.softmask`).
        return mask_losses.hardmask_rgb_loss(pred, target, mask,
                                             cfg.hardmask_coef)
    if cfg.softLpmask:
        return mask_losses.img2mse_softLpmask(pred, target, cfg.Lp_coef)
    return mask_losses.img2mse(pred, target)


def _depth_loss(pred_depth, prior_depth, mask, cfg, far, temp):
    if cfg.hardmask or cfg.softmask:
        return mask_losses.hardmask_depth_loss(pred_depth, prior_depth, mask,
                                               far)
    if cfg.softLpmask:
        return mask_losses.img2mse_softLpmask(pred_depth / far,
                                              prior_depth / far, cfg.Lp_coef)
    if cfg.with_depth_norm:
        return mask_losses.unmasked_depth_loss(pred_depth, prior_depth, mask,
                                               normalize_far=far)
    return mask_losses.unmasked_depth_loss(pred_depth, prior_depth, mask)


def _patch_terms(rgb_pred, depth_pred, batch, cfg, lpips_params):
    """MiDaS + SSIM + LPIPS patch terms (run_nerf_view.py:1679-1728).
    The LPIPS term (`lpips_params` given: calibrated weights on the
    predictions' device) is the mean distance of the n_patches patches
    in [-1, 1], differentiable through the VGG trunk; else 0."""
    ps, npatch = cfg.patch_size, cfg.n_patches
    p2 = ps * ps
    mono = midas_patch_loss(depth_pred, batch["mono_disp"], ps, npatch)
    img_pred = rgb_pred[: npatch * p2].reshape(npatch, ps, ps, 3)
    img_gt = batch["rgb"][: npatch * p2].reshape(npatch, ps, ps, 3)
    ssim_val = torch.mean(image_metrics.ssim(img_pred, img_gt))
    if lpips_params is None:
        lp = torch.zeros((), device=rgb_pred.device)
    else:
        lp = torch.mean(lpips_mod.lpips(lpips_params, img_pred * 2 - 1,
                                        img_gt * 2 - 1))
    return mono, ssim_val, lp


def vanilla_losses(outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg, far: float,
                   temp: float = 1.0, lpips_params: Optional[Any] = None):
    """Total loss + stats for the vanilla backbone.

    batch keys: 'rgb' [N,3], 'depth' [N] (MVS prior), 'mask' [N],
    'mono_disp' [N]; the first n_patches*patch_size^2 rays are patches."""
    target = batch["rgb"]
    mask = batch["mask"]
    # Pseudo-label batches downweight the reconstruction terms x0.1
    # (run_nerf_view.py:1670-1673); regular batches carry scale 1.
    loss_scale = batch.get("loss_scale", 1.0)
    stats = {}
    # Patch terms need coherent patches: not in use_batching mode, whose
    # rays are independent draws (run_nerf.py:680-701 has none either).
    has_patches = (not cfg.use_batching) and cfg.n_patches > 0

    img_loss = _rgb_loss(outputs["rgb"], target, mask, cfg, temp)
    loss = loss_scale * img_loss
    stats["img_loss"] = img_loss
    stats["psnr"] = mathx.mse_to_psnr(
        mask_losses.img2mse(outputs["rgb"], target))
    if has_patches:
        mono, ssim_val, lp = _patch_terms(outputs["rgb"], outputs["depth"],
                                          batch, cfg, lpips_params)
        loss = (loss + cfg.mono_depth_loss_mult * mono
                - cfg.patch_ssim_loss_mult * ssim_val
                + cfg.patch_lpips_loss_mult * lp)
        stats["mono_depth_loss"] = mono
        stats["patch_ssim"] = ssim_val
        stats["patch_lpips"] = lp
    if cfg.with_depth_loss:
        depth_loss = _depth_loss(outputs["depth"], batch["depth"], mask, cfg,
                                 far, temp)
        loss = loss + loss_scale * depth_loss
        stats["depth_loss"] = depth_loss

    # Coarse level (mirrors the fine-level terms, run_nerf_view.py:1785-1906).
    if "rgb0" in outputs:
        img_loss0 = _rgb_loss(outputs["rgb0"], target, mask, cfg, temp)
        loss = loss + loss_scale * img_loss0
        stats["img_loss0"] = img_loss0
        stats["psnr0"] = mathx.mse_to_psnr(
            mask_losses.img2mse(outputs["rgb0"], target))
        if has_patches:
            mono0, ssim0, lp0 = _patch_terms(
                outputs["rgb0"], outputs["depth0"], batch, cfg, lpips_params)
            loss = (loss + cfg.mono_depth_loss_mult * mono0
                    - cfg.patch_ssim_loss_mult * ssim0
                    + cfg.patch_lpips_loss_mult * lp0)
            stats["mono_depth_loss0"] = mono0
        if cfg.with_depth_loss:
            depth_loss0 = _depth_loss(outputs["depth0"], batch["depth"],
                                      mask, cfg, far, temp)
            loss = loss + loss_scale * depth_loss0
            stats["depth_loss0"] = depth_loss0

    stats["loss"] = loss
    return loss, stats


def tv_level_loss(rendering: Dict[str, torch.Tensor], cfg) -> torch.Tensor:
    """The mean TV norm of one level's random-pose patches: the selected
    depth (`depth_tvnorm_selector`) of each random_patch_size^2 patch,
    weighted by the detached opacity (losses.py:247-281)."""
    ps = cfg.random_patch_size
    depth = rendering[cfg.depth_tvnorm_selector].reshape(-1, ps, ps, 1)
    opacity_w = (rendering["acc"].reshape(-1, ps, ps, 1)[:, :-1, :-1]
                 .detach() * cfg.depth_tvnorm_mask_weight)
    return mathx.compute_tv_norm(depth, cfg.depth_tvnorm_type,
                                 opacity_w).mean()


def depth_scale_and_mask(batch, cfg, n: int, device):
    """(per-ray mask, scale) of the mip depth MSE: DTU and hard-mask runs
    supervise mask-valid pixels only; LLFF normalizes by the scene bound,
    Blender by far (losses.py:214-228)."""
    if cfg.dataset_type == "dtu" or cfg.use_hardmask:
        mask = batch["masks"]
        if cfg.dataset_type == "llff":
            scale = batch["bounds"].max()
        elif cfg.dataset_type == "blender":
            scale = cfg.far
        else:
            scale = 1.0
    else:
        mask = torch.ones((n,), device=device)
        scale = batch["bounds"].max() if cfg.dataset_type == "llff" else 1.0
    return mask, scale


def mip_losses(renderings, renderings_random, batch: Dict[str, Any],
               params: Iterable[torch.Tensor], cfg,
               tvnorm_loss_weight: float = 0.0):
    """Total loss + stats for the mip backbone (RegNeRF/train.py:97-241):
    lossmult-weighted RGB MSE per level, the dataset-normalized masked
    depth MSE, the MiDaS patch term (x0.01 on Blender), the mean-square
    weight decay, and the TV norm of the random-pose renderings (the
    last level at `tvnorm_loss_weight` with depth_tvnorm_decay, else at
    depth_tvnorm_loss_mult; earlier levels at coarse_loss_mult, as the
    JAX package weighs them); the last level at full weight, earlier ones
    at coarse_loss_mult. `params`: every parameter of the model."""
    rays = batch["rays"]
    lossmult = rays.lossmult
    if cfg.disable_multiscale_loss:
        lossmult = torch.ones_like(lossmult)
    params = list(params)
    param_sq = sum(torch.sum(p.float() ** 2) for p in params)
    count = sum(p.numel() for p in params)
    weight_l2 = torch.nan_to_num(param_sq / count) if count else \
        torch.zeros(())

    def rgb_mse(r):
        sq_err = lossmult * (r["rgb"] - batch["rgb"][..., :3]) ** 2
        return sq_err.sum() / (lossmult.sum() + 0.0001)

    def depth_mse(r):
        pred = r["distance_mean"]
        if not cfg.compute_depth_metrics:
            return torch.zeros((), device=pred.device)
        prior = batch["dpts"]
        mask, scale = depth_scale_and_mask(batch, cfg, pred.shape[0],
                                           pred.device)
        if cfg.dataset_type == "dtu" or cfg.use_hardmask:
            pred, prior = pred * mask, prior * mask
        return (((prior - pred) / scale) ** 2).mean()

    def mono_term(r):
        pred = r["distance_mean"]
        if not cfg.compute_mono_depth_metrics:
            return torch.zeros((), device=pred.device)
        term = midas_patch_loss(pred.reshape(-1),
                                batch["mono_dpts"].reshape(-1), 16, 4)
        return term * 0.01 if cfg.dataset_type == "blender" else term

    rgb_v = torch.stack([rgb_mse(r) for r in renderings])
    depth_v = torch.stack([depth_mse(r) for r in renderings])
    mono_v = torch.stack([mono_term(r) for r in renderings])
    wants_tv = cfg.depth_tvnorm_loss_mult != 0.0 or cfg.depth_tvnorm_decay
    if not wants_tv or renderings_random is None:
        tv_v = torch.zeros((1,), device=rgb_v.device)
    else:
        tv_v = torch.stack([tv_level_loss(r, cfg)
                            for r in renderings_random])
    tv_weight = (tvnorm_loss_weight if cfg.depth_tvnorm_decay
                 else cfg.depth_tvnorm_loss_mult)

    def final_plus_coarse(v, mult=1.0):
        return mult * v[-1] + mult * cfg.coarse_loss_mult * v[:-1].sum()

    loss = (final_plus_coarse(rgb_v) + final_plus_coarse(depth_v, 0.1)
            + final_plus_coarse(mono_v, 0.1)
            + cfg.weight_decay_mult * weight_l2
            + tv_weight * tv_v[-1] + cfg.coarse_loss_mult * tv_v[:-1].sum())
    stats = {
        "loss": loss,
        "losses": rgb_v,
        "depth_mses": depth_v,
        "mono_depth_mses": mono_v,
        "patch_tv_losses": tv_v,
        "weight_l2": weight_l2,
        "psnr": mathx.mse_to_psnr(rgb_v[-1]),
        "psnrs": mathx.mse_to_psnr(rgb_v),
    }
    return loss, stats
