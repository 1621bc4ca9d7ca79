"""Visualization: turbo depth colormap with checkerboard matte, u8 PNGs.

Written on numpy and the standard library alone (a zlib PNG encoder, a
sampled turbo colormap), so rendering needs no imaging package.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_img_u8(img: np.ndarray, path: str) -> None:
    """Save a [0, 1] float image ([H, W] or [H, W, 3]) as an 8-bit PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * c)], 1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             color_type, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


# The turbo colormap (Google, Apache-2.0) at 33 evenly spaced points,
# linearly interpolated: within 0.03 of the 256-entry table.
_TURBO = np.array([
    [0.1900, 0.0718, 0.2322], [0.2250, 0.1635, 0.4510], [0.2511, 0.2524, 0.6337],
    [0.2682, 0.3382, 0.7805], [0.2763, 0.4212, 0.8912], [0.2754, 0.5011, 0.9659],
    [0.2586, 0.5796, 0.9988], [0.2138, 0.6589, 0.9796], [0.1584, 0.7355, 0.9231],
    [0.1117, 0.8057, 0.8452], [0.0927, 0.8655, 0.7623], [0.1201, 0.9119, 0.6866],
    [0.1966, 0.9490, 0.5947], [0.3051, 0.9770, 0.4899], [0.4278, 0.9942, 0.3857],
    [0.5466, 0.9991, 0.2958], [0.6436, 0.9900, 0.2336], [0.7260, 0.9647, 0.2064],
    [0.8047, 0.9245, 0.2046], [0.8753, 0.8727, 0.2155], [0.9330, 0.8124, 0.2267],
    [0.9732, 0.7468, 0.2254], [0.9931, 0.6741, 0.2035], [0.9959, 0.5870, 0.1690],
    [0.9836, 0.4929, 0.1285], [0.9580, 0.3996, 0.0883], [0.9211, 0.3149, 0.0548],
    [0.8742, 0.2453, 0.0330], [0.8161, 0.1846, 0.0181], [0.7462, 0.1310, 0.0085],
    [0.6645, 0.0844, 0.0042], [0.5710, 0.0447, 0.0053], [0.4796, 0.0158, 0.0106],
])


def _turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Turbo colormap, x in [0, 1] -> rgb [..., 3]."""
    x = np.clip(x, 0.0, 1.0)
    grid = np.linspace(0.0, 1.0, len(_TURBO))
    return np.stack([np.interp(x, grid, _TURBO[:, c]) for c in range(3)],
                    -1)


def weighted_percentile(x, w, ps):
    """Host-side weighted percentile for vis scaling."""
    x = x.reshape(-1)
    w = w.reshape(-1)
    sortidx = np.argsort(x)
    x, w = x[sortidx], w[sortidx]
    acc_w = np.cumsum(w)
    return np.interp(np.array(ps) * (acc_w[-1] / 100), acc_w, x)


def matte(vis: np.ndarray, acc: np.ndarray, dark=0.8, light=1.0,
          width=8) -> np.ndarray:
    """Checkerboard matte for unaccumulated pixels."""
    h, w = acc.shape[:2]
    bg_mask = np.logical_xor(
        (np.arange(h) % (2 * width) // width)[:, None],
        (np.arange(w) % (2 * width) // width)[None, :],
    )
    bg = np.where(bg_mask, light, dark)[..., None].repeat(3, -1)
    return vis * acc[..., None] + (bg * (1 - acc[..., None]))


def visualize_cmap(
    value: np.ndarray,
    weight: np.ndarray,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    curve_fn=lambda x: x,
    matte_background: bool = True,
    percentile: float = 99.0,
) -> np.ndarray:
    """Colormapped scalar map with accumulation-matte checkerboard."""
    if lo is None or hi is None:
        lo_auto, hi_auto = weighted_percentile(
            value, weight, [50 - percentile / 2, 50 + percentile / 2]
        )
        lo = lo if lo is not None else lo_auto
        hi = hi if hi is not None else hi_auto
    value = np.clip(value, lo, hi)
    value = curve_fn(value)
    lo_c, hi_c = curve_fn(lo), curve_fn(hi)
    value = (value - np.minimum(lo_c, hi_c)) / np.abs(hi_c - lo_c + 1e-10)
    if hi_c < lo_c:
        value = 1 - value
    colorized = _turbo_colormap(value)
    if matte_background:
        return matte(colorized, weight)
    return colorized


def visualize_depth(depth: np.ndarray, acc: Optional[np.ndarray] = None,
                    lo=None, hi=None) -> np.ndarray:
    """Turbo visualization of a depth map (colored by log disparity)."""
    acc = acc if acc is not None else np.ones_like(depth)
    eps = np.finfo(np.float32).eps
    return visualize_cmap(
        1.0 / np.maximum(depth, eps),
        acc,
        lo=lo,
        hi=hi,
        curve_fn=lambda x: np.log(x + eps),
    )


def visualize_normals(normals: np.ndarray,
                      acc: Optional[np.ndarray] = None) -> np.ndarray:
    """Unit normals [H, W, 3] to rgb in [0, 1], matted where `acc` is
    low (vis.py's convention)."""
    vis = (normals + 1.0) / 2.0
    if acc is not None:
        vis = matte(vis, acc)
    return vis
