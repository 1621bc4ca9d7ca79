"""Math utilities shared by the rendering core."""

from __future__ import annotations

import math

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


def exp_lr_decay(step, lr_init, decay_rate=0.1, decay_steps=250_000):
    """The vanilla trainer's lr schedule: lr * decay^(step/decay_steps)
    (run_nerf_view.py:1989-1993)."""
    return lr_init * (decay_rate ** (step / decay_steps))
