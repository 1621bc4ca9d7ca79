"""Mask-weighted reconstruction losses (`run_nerf_view.py:35-58,80-100,
1645-1666` semantics), static-shaped: boolean indexing becomes weighted
sums; and the edge-mask variants of the train views
(`run_nerf_view.py:1117-1159`).

The edge masks are the JAX package's cv2 pipeline written in numpy with
cv2's arithmetic, so they equal cv2's bit for bit without cv2: the gray
image of float32 RGB read as BGR (`_gray`), the 3x3 Gaussian blur
(`_blur3`), the truncation to uint8, then Canny (`_canny`: aperture 3,
L1 gradient, integer non-maximum suppression, hysteresis) or the 5x5
mixed Sobel derivative (`_sobel11`).
"""

from __future__ import annotations

import numpy as np
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


def img2mse_softmask(x, y, temp):
    """Soft-mask reweighted MSE (run_nerf_view.py:50)."""
    se = (x - y) ** 2
    num = torch.sum(torch.exp(se / temp) * se)
    den = torch.sum(torch.exp((x - y).detach() ** 2 / temp))
    return num / den


def img2mse_softLpmask(x, y, coef):
    """Lp-soft-mask reweighted MSE (run_nerf_view.py:58)."""
    w = torch.abs(x - y) ** coef + 1
    return torch.sum(w * (x - y) ** 2) / torch.sum(w).detach()


def temp_schedule(step, total_steps, base_temp, temp_min):
    """Linear temperature decay (Temp_Scheduler, run_nerf_view.py:80-100)."""
    t = (1 - step / total_steps) * (base_temp - temp_min) + temp_min
    return max(t, temp_min)


# --- edge-detection mask variants (run_nerf_view.py:1117-1159) -------------


def _fma32(a: np.ndarray, x: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 a * x + c rounded once, as a fused multiply-add. The
    product is exact in float64; where the float64 sum lands on a float32
    midpoint, its rounding error (TwoSum) picks the side."""
    p = a.astype(np.float64) * np.float64(x)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > r64, np.inf, -np.inf)
                         .astype(np.float32))
    mid = (s == (r64 + other.astype(np.float64)) / 2) & (s != r64)
    toward_other = err * (other.astype(np.float64) - s) > 0
    return np.where(mid & toward_other, other, r)


def _gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of float32 [H, W, 3]: channel 0
    is read as blue, 0.114 * c0 + 0.587 * c1 + 0.299 * c2, summed as cv2's
    IPP path sums them: fma(c2, .299, fma(c0, .114, c1 * .587)) over
    each row's 8-pixel groups and its last pixels; where a row leaves 4
    to 7 pixels after its groups, the first and third of them are summed
    fma(c2, .299, fma(c1, .587, c0 * .114))."""
    img = np.asarray(img, np.float32)
    cb, cg, cr = np.float32(0.114), np.float32(0.587), np.float32(0.299)
    c0, c1, c2 = img[..., 0], img[..., 1], img[..., 2]
    out = _fma32(c2, cr, _fma32(c0, cb, c1 * cg))
    w = img.shape[1]
    k = w - w % 8
    if w - k >= 4:
        cols = [k, k + 2]
        out[:, cols] = _fma32(c2[:, cols], cr,
                              _fma32(c1[:, cols], cg, c0[:, cols] * cb))
    return out


def _blur3(x: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(x, (3, 3), 0) of float32 [H, W]: the kernel
    [1/4, 1/2, 1/4] along rows then columns, BORDER_REFLECT_101."""
    q, h = np.float32(0.25), np.float32(0.5)
    p = np.pad(x, ((0, 0), (1, 1)), mode="reflect")
    r = (p[:, :-2] + p[:, 2:]) * q + p[:, 1:-1] * h
    p = np.pad(r, ((1, 1), (0, 0)), mode="reflect")
    return (p[:-2] + p[2:]) * q + p[1:-1] * h


def blurred_uint8(img: np.ndarray) -> np.ndarray:
    """The uint8 image the edge detectors read: gray, blurred, times 255,
    truncated."""
    return (_blur3(_gray(img)) * 255).astype(np.uint8)


# tan(22.5 deg) in cv2's Canny fixed point (CANNY_SHIFT = 15).
_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)


def _dilate8(m: np.ndarray) -> np.ndarray:
    p = np.pad(m, 1)
    return (p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:] | p[1:-1, :-2]
            | p[1:-1, 2:] | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:])


def _canny(img: np.ndarray, low: int, high: int) -> np.ndarray:
    """cv2.Canny(img, low, high) > 0 of uint8 [H, W] (aperture 3, L1
    gradient). The 3x3 Sobel gradients with BORDER_REPLICATE; a pixel
    whose |dx| + |dy| exceeds low and is a maximum along its gradient's
    sector (the fixed-point tan 22.5 / 67.5 tests, zero magnitude outside
    the image) is a candidate; the edges are the 8-connected candidate
    sets that hold one above high."""
    low, high = int(low), int(high)
    if low > high:
        low, high = high, low
    x = np.pad(img.astype(np.int32), 1, mode="edge")
    dx = ((x[:-2, 2:] + 2 * x[1:-1, 2:] + x[2:, 2:])
          - (x[:-2, :-2] + 2 * x[1:-1, :-2] + x[2:, :-2]))
    dy = ((x[2:, :-2] + 2 * x[2:, 1:-1] + x[2:, 2:])
          - (x[:-2, :-2] + 2 * x[:-2, 1:-1] + x[:-2, 2:]))
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)
    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << 15
    tg22x = ax * _TG22
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg22x + (ax << 16))
    diag = ~horiz & ~vert
    same = (dx ^ dy) >= 0  # cv2's s = 1: the up-left / down-right diagonal
    d1 = np.where(same, m[:-2, :-2], m[:-2, 2:])
    d2 = np.where(same, m[2:, 2:], m[2:, :-2])
    cand = (mag > low) & (
        (horiz & (mag > m[1:-1, :-2]) & (mag >= m[1:-1, 2:]))
        | (vert & (mag > m[:-2, 1:-1]) & (mag >= m[2:, 1:-1]))
        | (diag & (mag > d1) & (mag > d2)))
    edges = cand & (mag > high)
    front = edges
    while front.any():  # hysteresis: grow the strong pixels over cand
        front = _dilate8(front) & cand & ~edges
        edges |= front
    return edges


_SOBEL5 = np.array([-1, -2, 0, 2, 1], np.int64)


def _sobel11(img: np.ndarray) -> np.ndarray:
    """cv2.Sobel(img, CV_64F, 1, 1, ksize=5) of uint8 [H, W], with
    BORDER_REFLECT_101: an integer sum, exact in float64."""
    h, w = img.shape
    x = np.pad(img.astype(np.int64), 2, mode="reflect")
    r = sum(k * x[:, i:i + w] for i, k in enumerate(_SOBEL5))
    return sum(k * r[i:i + h] for i, k in enumerate(_SOBEL5)).astype(
        np.float64)


def canny_masks(images: np.ndarray, i_train, threshold1=1, threshold2=200):
    """Canny edge masks for train views; zeros elsewhere. images:
    [N, H, W, 3] float in [0, 1]."""
    n, h, w = images.shape[:3]
    out = np.zeros((n, h, w), bool)
    for idx in np.asarray(i_train):
        out[idx] = _canny(blurred_uint8(images[idx]), threshold1, threshold2)
    return out


def sobel_masks(images: np.ndarray, i_train, ksize=5):
    """Sobel edge masks (d2/dxdy != 0) for train views; zeros elsewhere."""
    if ksize != 5:
        raise ValueError(f"sobel_masks takes ksize 5 only, not {ksize}")
    n, h, w = images.shape[:3]
    out = np.zeros((n, h, w), bool)
    for idx in np.asarray(i_train):
        out[idx] = _sobel11(blurred_uint8(images[idx])) != 0
    return out
