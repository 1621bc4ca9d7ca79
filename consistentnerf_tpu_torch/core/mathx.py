"""Math utilities shared by the rendering core."""

from __future__ import annotations

import math

import numpy as np
import torch

# 100*pi rounded to fp32, as the reference computes it.
_TRIG_RANGE = float(torch.tensor(100 * math.pi, dtype=torch.float32))


def _remainder(x: torch.Tensor, t: float) -> torch.Tensor:
    """Floored remainder via the exact fmod (torch.remainder rounds)."""
    r = torch.fmod(x, t)
    return torch.where((r != 0) & ((r < 0) != (t < 0)), r + t, r)


def safe_trig_helper(x: torch.Tensor, fn, t: float = _TRIG_RANGE):
    """Range-reduce x past |x| >= 100*pi before sin/cos."""
    return fn(torch.where(torch.abs(x) < t, x, _remainder(x, t)))


def safe_cos(x):
    return safe_trig_helper(x, torch.cos)


def safe_sin(x):
    return safe_trig_helper(x, torch.sin)


def mse_to_psnr(mse):
    """PSNR assuming max pixel value 1."""
    return -10.0 / math.log(10.0) * torch.log(torch.as_tensor(mse))


def psnr_to_mse(psnr):
    return torch.exp(-0.1 * math.log(10.0) * torch.as_tensor(psnr))


def compute_avg_error(psnr, ssim, lpips):
    """geomean(MSE, sqrt(1 - SSIM), LPIPS), the paper's 'average' error."""
    mse = psnr_to_mse(psnr)
    dssim = torch.sqrt(1 - torch.as_tensor(ssim))
    return torch.exp(torch.mean(torch.log(torch.stack(
        [mse, dssim, torch.as_tensor(lpips)]))))


def compute_ternary_census(im: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Ternary census transform of one [H, W, C] image: the sign of each
    pixel's difference to its 8 neighbours (edge padding), zero within
    +-epsilon (RegNeRF/internal/math.py:70). Returns int8 [H, W, C, 8]."""
    assert im.dim() == 3 and epsilon >= 0
    padded = torch.nn.functional.pad(
        im.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate"
    )[0].permute(1, 2, 0)
    codes = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if (di, dj) == (0, 0):
                continue
            neighbor = torch.roll(torch.roll(padded, di, -2), dj,
                                  -3)[1:-1, 1:-1, :]
            diff = im - neighbor
            codes.append(torch.where(diff.abs() <= epsilon,
                                     torch.zeros_like(diff),
                                     torch.sign(diff)).to(torch.int8))
    return torch.stack(codes, -1)


def compute_census_err(im0: torch.Tensor, im1: torch.Tensor,
                       epsilon: float) -> torch.Tensor:
    """Share of opposite-signed census codes between two images
    (RegNeRF/internal/math.py:87: |c0 - c1| > 1, the signs disagree)."""
    c0 = compute_ternary_census(im0, epsilon).to(torch.int16)
    c1 = compute_ternary_census(im1, epsilon).to(torch.int16)
    return torch.mean(((c0 - c1).abs() > 1).to(torch.float32))


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 linear -> sRGB (exact rational constants)."""
    eps = torch.finfo(torch.float32).eps
    below = 323 / 25 * linear
    above = (211 * torch.clamp(linear, min=eps) ** (5 / 12) - 11) / 200
    return torch.where(linear <= 0.0031308, below, above)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 sRGB -> linear (exact rational constants)."""
    eps = torch.finfo(torch.float32).eps
    below = 25 / 323 * srgb
    above = torch.clamp((200 * srgb + 11) / 211, min=eps) ** (12 / 5)
    return torch.where(srgb <= 0.04045, below, above)


def exp_lr_decay(step, lr_init, decay_rate=0.1, decay_steps=250_000):
    """The vanilla trainer's lr schedule: lr * decay^(step/decay_steps)
    (run_nerf_view.py:1989-1993)."""
    return lr_init * (decay_rate ** (step / decay_steps))


def log_lerp(t, v0, v1):
    """Log-linear interpolation from v0 (t=0) to v1 (t=1), on Python
    floats."""
    if v0 <= 0 or v1 <= 0:
        raise ValueError(f"Interpolants {v0} and {v1} must be positive.")
    lv0, lv1 = math.log(v0), math.log(v1)
    return math.exp(min(max(t, 0.0), 1.0) * (lv1 - lv0) + lv0)


def learning_rate_decay(step, lr_init, lr_final, max_steps,
                        lr_delay_steps=0, lr_delay_mult=1):
    """The mip trainer's lr: log-linear decay with an optional
    quarter-sine warmup ramp (RegNeRF/internal/math.py:134)."""
    warmup = 1.0
    if lr_delay_steps > 0:
        ramp = math.sin(0.5 * math.pi
                        * min(max(step / lr_delay_steps, 0.0), 1.0))
        warmup = lr_delay_mult + (1 - lr_delay_mult) * ramp
    return warmup * log_lerp(step / max_steps, lr_init, lr_final)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """Row-wise `jnp.interp`: x [R, Q], xp (non-decreasing) and fp [R, K];
    constant outside [xp[0], xp[-1]]."""
    k = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, k - 1)
    x0, x1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = x1 - x0
    eps = math.ulp(torch.finfo(xp.dtype).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, f0, f0 + (x - x0) / torch.where(
        dx0, torch.ones_like(dx), dx) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def weighted_percentile(x: torch.Tensor, w: torch.Tensor, ps,
                        assume_sorted: bool = False) -> torch.Tensor:
    """Weighted percentiles of each row of x [..., K] under weights w:
    [..., len(ps)] (RegNeRF/internal/math.py:52, interpolated against the
    cumulative weight)."""
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    w = w.reshape(-1, w.shape[-1])
    if not assume_sorted:
        order = torch.argsort(x.detach(), -1)
        x, w = torch.gather(x, -1, order), torch.gather(w, -1, order)
    cum_w = torch.cumsum(w, -1)
    q = torch.as_tensor(ps, dtype=x.dtype, device=x.device)[None] * (
        cum_w[:, -1:] / 100)
    return _interp(q, cum_w, x).reshape(*lead, len(ps))


def compute_tv_norm(values: torch.Tensor, losstype: str = "l2",
                    weighting=None) -> torch.Tensor:
    """Total-variation norm over patch values [P, H, W, ...]: per-pixel
    horizontal + vertical neighbour differences, L1 or squared, times
    `weighting` (RegNeRF/internal/math.py:237)."""
    center = values[:, :-1, :-1]
    dx = center - values[:, :-1, 1:]
    dy = center - values[:, 1:, :-1]
    if losstype == "l2":
        tv = dx**2 + dy**2
    elif losstype == "l1":
        tv = torch.abs(dx) + torch.abs(dy)
    else:
        raise ValueError("Not supported losstype.")
    if weighting is not None:
        tv = tv * weighting
    return tv


def compute_tvnorm_weight(step, max_step, weight_start=0.0,
                          weight_end=0.0) -> np.float32:
    """The TV norm's weight, linear from weight_start to weight_end over
    max_step steps (RegNeRF/internal/math.py:259), in fp32 as the JAX
    package computes it."""
    frac = np.float32(np.clip(step * 1.0 / (1 if max_step < 1 else max_step),
                              0, 1))
    return weight_start * (np.float32(1) - frac) + frac * weight_end
