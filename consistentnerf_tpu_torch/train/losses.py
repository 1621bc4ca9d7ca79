"""Loss assembly of the vanilla trainer: `vanilla_losses` reproduces the
ConsistentNeRF PyTorch trainer's total loss (`run_nerf_view.py:1577-1906`):
masked RGB MSE, the MiDaS patch loss (x0.001), patch SSIM (x-0.005) and
patch LPIPS (x+0.005), masked depth MSE, each on fine and coarse outputs.
`mip_losses` comes with the mip slice (ROADMAP Queue 1: mip backbone).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from consistentnerf_tpu_torch.consistency import masks as mask_losses
from consistentnerf_tpu_torch.consistency.monodepth import midas_patch_loss
from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.train import image_metrics


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
    """MiDaS + SSIM + LPIPS patch terms (run_nerf_view.py:1679-1728)."""
    if lpips_params is not None:
        raise NotImplementedError(
            "the patch LPIPS term is not ported yet (ROADMAP Queue 1: eval "
            "metrics); leave lpips_weights_path unset")
    ps, npatch = cfg.patch_size, cfg.n_patches
    p2 = ps * ps
    mono = midas_patch_loss(depth_pred, batch["mono_disp"], ps, npatch)
    img_pred = rgb_pred[: npatch * p2].reshape(npatch, ps, ps, 3)
    img_gt = batch["rgb"][: npatch * p2].reshape(npatch, ps, ps, 3)
    ssim_val = torch.mean(image_metrics.ssim(img_pred, img_gt))
    return mono, ssim_val, torch.zeros((), device=rgb_pred.device)


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
