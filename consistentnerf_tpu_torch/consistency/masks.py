"""Mask-weighted reconstruction losses (`run_nerf_view.py:35-58,80-100,
1645-1666` semantics), static-shaped: boolean indexing becomes weighted
sums. The canny/sobel mask makers come with the consistency slice
(ROADMAP Queue 1: consistency)."""

from __future__ import annotations

import torch


def img2mse(x, y):
    return torch.mean((x - y) ** 2)


def masked_mse(pred, target, mask):
    """Mean squared error over elements where mask==1 (0 if mask empty).
    `mask` broadcasts against pred's leading dims."""
    mask = mask.reshape(mask.shape + (1,) * (pred.ndim - mask.ndim))
    se = (pred - target) ** 2 * mask
    denom = torch.sum(mask.expand(pred.shape))
    return torch.where(denom > 0, torch.sum(se) / torch.clamp(denom, min=1),
                       torch.zeros_like(denom))


def hardmask_rgb_loss(pred, target, mask, hardmask_coef: float):
    """mse(masked) + coef * mse(unmasked); the second term only when some
    rays are unmasked (run_nerf_view.py:1645-1648)."""
    n = mask.shape[0]
    in_term = masked_mse(pred, target, mask)
    out_term = masked_mse(pred, target, 1.0 - mask)
    all_masked = torch.sum(mask) == n
    return in_term + torch.where(all_masked, torch.zeros_like(out_term),
                                 hardmask_coef * out_term)


def hardmask_depth_loss(pred_depth, prior_depth, mask, far: float):
    """Masked depth MSE, normalized by far (run_nerf_view.py:1737)."""
    return masked_mse(pred_depth / far, prior_depth / far, mask)


def unmasked_depth_loss(pred_depth, prior_depth, mask, normalize_far=None):
    """Prior depth zeroed where unmasked, then plain MSE (optionally /far)
    (run_nerf_view.py:1762-1771)."""
    prior = torch.where(mask > 0, prior_depth, torch.zeros_like(prior_depth))
    if normalize_far is not None:
        return img2mse(pred_depth / normalize_far, prior / normalize_far)
    return img2mse(pred_depth, prior)


def img2mse_softLpmask(x, y, coef):
    """Lp-soft-mask reweighted MSE (run_nerf_view.py:58)."""
    w = torch.abs(x - y) ** coef + 1
    return torch.sum(w * (x - y) ** 2) / torch.sum(w).detach()


def temp_schedule(step, total_steps, base_temp, temp_min):
    """Linear temperature decay (Temp_Scheduler, run_nerf_view.py:80-100)."""
    t = (1 - step / total_steps) * (base_temp - temp_min) + temp_min
    return max(t, temp_min)
