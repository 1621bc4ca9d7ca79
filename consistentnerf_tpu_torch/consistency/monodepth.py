"""Single-view (MiDaS) depth consistency patch loss: scale/shift-invariant
disparity MSE on patches (`run_nerf_view.py:1679-1728`)."""

from __future__ import annotations

import torch


def midas_patch_loss(pred_depth: torch.Tensor, mono_disp: torch.Tensor,
                     patch_size: int = 16,
                     num_patches: int = 4) -> torch.Tensor:
    """pred_depth: [>= num_patches*patch_size^2] per-ray depth, the patch
    rays first; mono_disp: the same-shaped MiDaS disparity prior.
    Returns a scalar."""
    p2 = patch_size * patch_size
    pred_disp_all = 1.0 / torch.where(pred_depth <= 0,
                                      torch.full_like(pred_depth, 1e-4),
                                      pred_depth)
    pred = torch.nan_to_num(pred_disp_all[: num_patches * p2]).reshape(
        num_patches, p2)
    gt = torch.nan_to_num(mono_disp[: num_patches * p2]).reshape(
        num_patches, p2)
    mask = (gt > 0).to(pred.dtype)
    big = torch.full_like(gt, 1e5)

    gt_min = torch.amin(torch.where(gt > 0, gt, big), -1, keepdim=True)
    gt_max = torch.amax(gt, -1, keepdim=True)
    gt_n = mask * (gt - gt_min) / (gt_max - gt_min + 1e-4)

    pred_min = torch.amin(torch.where(mask * pred > 0, pred, big), -1,
                          keepdim=True)
    pred_max = torch.amax(mask * pred, -1, keepdim=True)
    pred_n = mask * (pred - pred_min) / (pred_max - pred_min + 1e-4)

    alpha = torch.mean(pred_n - gt_n, -1, keepdim=True)
    per_patch = torch.mean((gt_n - pred_n + alpha) ** 2, -1)
    return torch.sum(per_patch) / num_patches / 2
