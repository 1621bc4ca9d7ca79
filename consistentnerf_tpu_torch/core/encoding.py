"""Positional encodings in their two orderings, and mip-NeRF's IPE.

* vanilla / torch Embedder ordering (`posenc_nerf`):
  [x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...];
* mip ordering (`pos_enc`, `RegNeRF/internal/mip.py:27-36`):
  [x, sin(all freqs * x), sin(all freqs * x + pi/2)];
* the integrated positional encoding of a Gaussian (`integrated_pos_enc`,
  diagonal covariances, `mip.py:160-192`).
"""

from __future__ import annotations

import math

import torch

from consistentnerf_tpu_torch.core import mathx


def posenc_nerf(x: torch.Tensor, num_freqs: int,
                include_identity: bool = True) -> torch.Tensor:
    """Freq bands 2^0..2^(num_freqs-1). Output dim d * (1 + 2*num_freqs)
    with the identity."""
    if num_freqs == 0:
        return x
    scales = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]  # [..., F, d]
    four = torch.stack([mathx.safe_sin(xb), mathx.safe_cos(xb)], -2)
    four = four.reshape(*x.shape[:-1], -1)
    if include_identity:
        return torch.cat([x, four], -1)
    return four


def pos_enc(x: torch.Tensor, min_deg: int, max_deg: int,
            append_identity: bool = True) -> torch.Tensor:
    """mip-NeRF-ordered PE (mip.py:27-36)."""
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=x.dtype, device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
    four = mathx.safe_sin(torch.cat([xb, xb + 0.5 * math.pi], -1))
    if append_identity:
        return torch.cat([x, four], -1)
    return four


def expected_sin(x: torch.Tensor, x_var: torch.Tensor) -> torch.Tensor:
    """E[sin(z)] for z ~ N(x, x_var) (mip.py:39)."""
    return torch.exp(-0.5 * x_var) * mathx.safe_sin(x)


def integrated_pos_enc(means: torch.Tensor, covs_diag: torch.Tensor,
                       min_deg: int, max_deg: int) -> torch.Tensor:
    """IPE of Gaussians with diagonal covariances (mip.py:160-192): the
    features are [sin(y), sin(y + pi/2)] damped by exp(-var/2), y = x 2^k
    in frequency-major, coordinate-minor order. The full-covariance form
    is not ported (only `diag=True` configs exist)."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=means.dtype,
                                 device=means.device)
    shape = (*means.shape[:-1], -1)
    y = (means[..., None, :] * scales[:, None]).reshape(shape)
    y_var = (covs_diag[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(torch.cat([y, y + 0.5 * math.pi], -1),
                        torch.cat([y_var, y_var], -1))
