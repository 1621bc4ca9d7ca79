"""Along-ray sampling: the vanilla renderer's stratified coarse depths and
inverse-CDF fine sampling (`run_nerf_helpers.py:206-250` semantics), and
mip-NeRF's fencepost sampling with cone casting and its blurpool
resampling through the hardened inverse CDF (`RegNeRF/internal/mip.py:
297-403`, `math.py:169-234`). Random draws come in as tensors, never from
a global RNG."""

from __future__ import annotations

from typing import Optional

import torch

from consistentnerf_tpu_torch.core import mip as mip_core
from consistentnerf_tpu_torch.core import spacing

_EPS = torch.finfo(torch.float32).eps


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    u: Optional[torch.Tensor] = None,
    det: bool = True,
) -> torch.Tensor:
    """bins: [..., M] sorted midpoints; weights: [..., M-1]. Returns
    [..., num_samples]. `u` [..., num_samples] in [0, 1) gives the draws;
    without it `det` must hold and the draws are an even linspace."""
    weights = weights + 1e-5  # prevent nans
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [..., M]

    if u is None:
        if not det:
            raise ValueError("stochastic sample_pdf needs its draws `u`")
        u = torch.linspace(0.0, 1.0, num_samples, device=cdf.device,
                           dtype=cdf.dtype)
        u = u.expand(*cdf.shape[:-1], num_samples)
    u = u.contiguous()

    # below = max{k: cdf[k] <= u}, above = below + 1 clamped to M - 1.
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(above - 1, min=0)
    above = torch.clamp(above, max=cdf.shape[-1] - 1)

    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)


def vanilla_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    lindisp: bool,
    t_rand: Optional[torch.Tensor],
) -> torch.Tensor:
    """Coarse z_vals of the vanilla renderer. near/far: [N, 1]. Returns
    [N, num_samples]; `t_rand` (or None) jitters them."""
    t_vals = torch.linspace(0.0, 1.0, num_samples, device=near.device,
                            dtype=near.dtype)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    return spacing.stratify(z_vals, t_rand)


def piecewise_pdf_draws(jitter: Optional[torch.Tensor], batch_shape,
                        num_samples: int, device=None) -> torch.Tensor:
    """The draw vector of `sorted_piecewise_constant_pdf` (RegNeRF
    math.py:181-190): the centered linspace without `jitter`, else strided
    draws arange(num) / num + jitter. `jitter` [..., 1] (single jitter) or
    [..., num] holds uniforms in [0, 1/num - eps)."""
    if jitter is None:
        u = torch.linspace(0.0, 1.0 - _EPS, num_samples, device=device)
        return u.expand(*batch_shape, num_samples)
    s = 1 / num_samples
    u = torch.arange(num_samples, device=jitter.device,
                     dtype=torch.float32) * s + jitter
    return torch.clamp(u, max=1.0 - _EPS).expand(*batch_shape, num_samples)


def jitter_draws(generator: torch.Generator, batch_shape, num_samples: int,
                 single_jitter: bool, device) -> torch.Tensor:
    """Uniforms in [0, 1/num_samples - eps) for `piecewise_pdf_draws`."""
    d = 1 if single_jitter else num_samples
    return torch.rand((*batch_shape, d), generator=generator,
                      device=device) * (1 / num_samples - _EPS)


def _interval(x: torch.Tensor, idx: torch.Tensor):
    """x at the last index with cdf <= u (`idx` - 1, the start of the
    sampled interval) and at the next one. x is non-decreasing, so these
    are the masked max / min of the reference's compare-mask form."""
    k = x.shape[-1]
    x0 = torch.gather(x, -1, torch.clamp(idx - 1, min=0))
    x1 = torch.gather(x, -1, torch.clamp(idx, max=k - 1))
    return x0, x1


def sorted_piecewise_constant_pdf(bins: torch.Tensor, weights: torch.Tensor,
                                  num_samples: int,
                                  jitter: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Numerically hardened inverse-CDF sampler (RegNeRF math.py:169-234).
    bins [..., K+1], weights [..., K]; `jitter` as `piecewise_pdf_draws`
    takes it (None: deterministic)."""
    weights = weights + torch.clamp(
        _EPS - weights.sum(-1, keepdim=True), min=0)
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], -1), max=1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)
    u = piecewise_pdf_draws(jitter, cdf.shape[:-1], num_samples,
                            cdf.device).contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    bins_g0, bins_g1 = _interval(bins, idx)
    cdf_g0, cdf_g1 = _interval(cdf, idx)
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / (cdf_g1 - cdf_g0),
                                     nan=0.0), 0, 1)
    return bins_g0 + t * (bins_g1 - bins_g0)


def sample_along_rays(t_rand: Optional[torch.Tensor], origins, directions,
                      radii, num_samples: int, near, far, genspace_fn,
                      ray_shape: str, diag: bool = True,
                      transposed: bool = False):
    """Stratified fencepost sampling and cone casting (mip.py:297-346).
    near/far [N, 1]; `t_rand` [N, num_samples + 1] (or [N, 1] for single
    jitter) uniforms in [0, 1), None for the deterministic fenceposts.
    Returns (t_vals [N, S+1], (means, covs))."""
    t_vals = spacing.genspace(near, far, num_samples + 1, fn=genspace_fn)
    t_vals = spacing.stratify(t_vals, t_rand)
    return t_vals, mip_core.cast_rays(t_vals, origins, directions, radii,
                                      ray_shape, diag=diag,
                                      transposed=transposed)


def resample_along_rays(jitter: Optional[torch.Tensor], origins,
                        directions, radii, t_vals, weights, ray_shape: str,
                        stop_grad: bool, resample_padding: float,
                        diag: bool = True, transposed: bool = False,
                        use_kernel: bool = False):
    """Blurpool and inverse-CDF resampling of the next level (mip.py:
    349-403). `jitter` as `piecewise_pdf_draws` takes it."""
    if use_kernel:
        raise NotImplementedError(
            "the fused mip resampling kernel (mip_resample_t_vals) is not "
            "ported yet (ROADMAP Queue 2 #9); set use_pdf_kernel=False")
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    new_t_vals = sorted_piecewise_constant_pdf(
        t_vals, weights_blur + resample_padding, t_vals.shape[-1], jitter)
    if stop_grad:
        new_t_vals = new_t_vals.detach()
    return new_t_vals, mip_core.cast_rays(new_t_vals, origins, directions,
                                          radii, ray_shape, diag=diag,
                                          transposed=transposed)
