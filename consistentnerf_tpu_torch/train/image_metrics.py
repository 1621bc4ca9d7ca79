"""SSIM (Wang et al., 11x1.5 Gaussian window, 'valid' padding), as the
patch loss uses it (`run_nerf_view.py:1701`). MS-SSIM and the PSNR
helpers come with the eval slice (ROADMAP Queue 1: eval metrics)."""

from __future__ import annotations

import torch


def _gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    return g / torch.sum(g)


def _effective_filter_size(filter_size: int, h: int, w: int) -> int:
    """Clamp the window to the image (odd size), so small patches work."""
    k = min(filter_size, h, w)
    return k if k % 2 == 1 else k - 1


def _filter2d_separable(img: torch.Tensor,
                        kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode separable Gaussian filter on [..., H, W, C] images."""
    k = kernel.shape[0]

    def conv_axis(x, axis):
        x = torch.movedim(x, axis, -1)
        n = x.shape[-1]
        windows = torch.stack([x[..., i: n - k + 1 + i] for i in range(k)],
                              -1)
        return torch.movedim(torch.einsum("...wk,k->...w", windows, kernel),
                             -1, axis)

    return conv_axis(conv_axis(img, -3), -2)


def ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
         filter_size: int = 11, filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, return_map: bool = False):
    """SSIM of [..., H, W, C] image batches. Returns per-image scalars."""
    filter_size = _effective_filter_size(filter_size, img0.shape[-3],
                                         img0.shape[-2])
    kernel = _gaussian_kernel(filter_size, filter_sigma, img0.device)
    mu0 = _filter2d_separable(img0, kernel)
    mu1 = _filter2d_separable(img1, kernel)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _filter2d_separable(img0**2, kernel) - mu00
    sigma11 = _filter2d_separable(img1**2, kernel) - mu11
    sigma01 = _filter2d_separable(img0 * img1, kernel) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    if return_map:
        return ssim_map
    return torch.mean(ssim_map, dim=(-3, -2, -1))
