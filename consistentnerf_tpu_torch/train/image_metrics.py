"""Image quality metrics: SSIM (Wang et al., 11x1.5 Gaussian window,
'valid' padding, as the patch loss (`run_nerf_view.py:1701`) and the
evaluation use it), MS-SSIM over 5 scales, PSNR and masked PSNR
(`alky/vis_utils.py:24-43`). Images are [..., H, W, C] tensors."""

from __future__ import annotations

import math

import torch

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


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


def _ssim_and_cs(img0, img1, max_val, filter_size, filter_sigma, k1, k2):
    filter_size = _effective_filter_size(filter_size, img0.shape[-3],
                                         img0.shape[-2])
    kernel = _gaussian_kernel(filter_size, filter_sigma, img0.device)
    mu0 = _filter2d_separable(img0, kernel)
    mu1 = _filter2d_separable(img1, kernel)
    sigma00 = _filter2d_separable(img0**2, kernel) - mu0**2
    sigma11 = _filter2d_separable(img1**2, kernel) - mu1**2
    sigma01 = _filter2d_separable(img0 * img1, kernel) - mu0 * mu1
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    cs_map = (2 * sigma01 + c2) / (sigma00 + sigma11 + c2)
    l_map = (2 * mu0 * mu1 + c1) / (mu0**2 + mu1**2 + c1)
    return (torch.mean(l_map * cs_map, dim=(-3, -2, -1)),
            torch.mean(cs_map, dim=(-3, -2, -1)))


def _avg_pool2(img):
    h, w = img.shape[-3], img.shape[-2]
    img = img[..., : h - h % 2, : w - w % 2, :]
    return 0.25 * (img[..., 0::2, 0::2, :] + img[..., 1::2, 0::2, :]
                   + img[..., 0::2, 1::2, :] + img[..., 1::2, 1::2, :])


def ms_ssim(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0,
            filter_size: int = 11, filter_sigma: float = 1.5,
            k1: float = 0.01, k2: float = 0.03, weights=_MSSSIM_WEIGHTS):
    """Multi-scale SSIM of [..., H, W, C] images (5 scales)."""
    weights = torch.as_tensor(weights, dtype=img0.dtype, device=img0.device)
    mcs = []
    s = None
    for i in range(len(weights)):
        s, cs = _ssim_and_cs(img0, img1, max_val, filter_size, filter_sigma,
                             k1, k2)
        if i < len(weights) - 1:
            mcs.append(torch.relu(cs))
            img0 = _avg_pool2(img0)
            img1 = _avg_pool2(img1)
    mcs = torch.stack(mcs, 0)  # [scales - 1, ...]
    w = weights[:-1].reshape((-1,) + (1,) * (mcs.dim() - 1))
    return torch.prod(mcs ** w, 0) * torch.relu(s) ** weights[-1]


def psnr(img0: torch.Tensor, img1: torch.Tensor, max_val: float = 1.0):
    mse = torch.mean((img0 - img1) ** 2)
    return -10.0 / math.log(10.0) * torch.log(mse / max_val**2)


def masked_psnr(img0: torch.Tensor, img1: torch.Tensor, mask: torch.Tensor):
    """PSNR over the masked pixels (alky/vis_utils.py:img2psnr_mask)."""
    mask = mask.reshape(mask.shape + (1,) * (img0.dim() - mask.dim()))
    se = (img0 - img1) ** 2 * mask
    denom = torch.sum(torch.broadcast_to(mask, img0.shape))
    mse = torch.sum(se) / torch.clamp(denom, min=1)
    return -10.0 / math.log(10.0) * torch.log(mse)
