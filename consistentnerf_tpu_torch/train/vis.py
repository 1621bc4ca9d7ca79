"""Visualization: turbo depth colormap with checkerboard matte, the
visualize-suite dict (RegNeRF `vis.py:254-299`), u8 PNGs.

The PNGs and the colormap need no imaging package (`data/images.py`
writes the PNGs, the turbo colormap is sampled here). `save_img_f32`
(a TIFF) and `visualize_rays` (a plot) import PIL and matplotlib when
called, as the JAX package's do; no path of the port calls them.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from consistentnerf_tpu_torch.data import images


def save_img_u8(img: np.ndarray, path: str) -> None:
    """Save a [0, 1] float image ([H, W] or [H, W, 3]) as an 8-bit PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    images.write_png(path, arr)


def save_img_f32(depthmap: np.ndarray, path: str) -> None:
    """Save a float map as a 32-bit TIFF (needs PIL)."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(np.nan_to_num(depthmap).astype(np.float32)).save(
        path, "TIFF")


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


def visualize_rays(t_vals: np.ndarray, weights: np.ndarray,
                   rgbs: Optional[np.ndarray] = None, width: int = 640,
                   height: int = 320) -> np.ndarray:
    """Per-ray weight curves over distance (RegNeRF vis.py:185-251's ray
    plots; needs matplotlib): an RGB image in [0, 1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t_vals = np.asarray(t_vals)
    weights = np.asarray(weights)
    fig, ax = plt.subplots(figsize=(width / 100, height / 100), dpi=100)
    t_mids = 0.5 * (t_vals[:, :-1] + t_vals[:, 1:])
    for i in range(min(t_mids.shape[0], 64)):
        color = None
        if rgbs is not None:
            color = np.clip(np.asarray(rgbs)[i].mean(0), 0, 1)
        ax.plot(t_mids[i], weights[i][: t_mids.shape[1]], lw=0.7,
                alpha=0.6, color=color)
    ax.set_xlabel("distance")
    ax.set_ylabel("weight")
    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf.astype(np.float32) / 255.0


def visualize_suite(rendering: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The standard visualization bundle (RegNeRF vis.py:254-299)."""
    out = {"color": np.clip(rendering["rgb"], 0, 1)}
    acc = rendering.get("acc", np.ones(rendering["rgb"].shape[:2]))
    if "depth" in rendering:
        out["depth"] = visualize_depth(rendering["depth"], acc)
    if "disp" in rendering:
        out["disp"] = visualize_cmap(rendering["disp"], acc)
    if "normals" in rendering:
        out["normals"] = visualize_normals(rendering["normals"], acc)
    out["acc"] = np.repeat(np.clip(acc, 0, 1)[..., None], 3, -1)
    return out
