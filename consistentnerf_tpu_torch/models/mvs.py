"""The plane-sweep MVS depth network, the in-framework depth-prior producer
(port of `consistentnerf_tpu/models/mvs.py`).

2D features of the reference and source views at 1/4 resolution, every
source warped onto D fronto-parallel planes of the reference camera, the
visibility-weighted variance over the views as a cost volume, a 3D U-Net
over it, a soft-argmin depth with a window confidence, and a 2D residual
refinement at full resolution (MVSNet's design). Its depths use the
repo's camera convention, so they feed the hard masks and the depth loss
as external PFMs would.

Public functions keep the JAX layouts (images [H, W, 3], prob [D, H, W],
depths [H, W]); the convolutions run NCHW / NCDHW inside the modules,
`torch.nn.functional.conv2d` / `conv3d` / `conv_transpose3d`, as the JAX
package runs them outside any Pallas kernel. The source views are one
batch dimension ([1 + V] views through the feature net, [V] through the
warp), where the JAX module maps over them.

What the port keeps of flax's convolutions:
* `padding="SAME"` pads `total = max((ceil(n/s) - 1) s + k - n, 0)` as
  `(total // 2, total - total // 2)`: asymmetric at stride 2 and an even
  size, so the modules pad with `F.pad` from the input's size.
* flax's `ConvTranspose` does not flip its kernel and its `SAME` output
  is `s n`: that is `conv_transpose3d` of the flipped kernel with no
  padding, cropped. The flip lives in the stored weight
  (`interop.mvs_params_from_jax` flips the flax kernel), so the module's
  forward is the plain transpose convolution.
* kernels start lecun-normal (a truncated normal of variance 1 / fan-in,
  fan-in `prod(k) * in` for both kinds) and biases at zero.
* `compute_dtype` bfloat16 casts inputs and kernels to bf16 and keeps the
  params fp32; the softmax over the depth planes is fp32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from consistentnerf_tpu_torch.core.rays import _as_tensor
# One camera convention, one implementation: the cost-volume warp must
# agree with core/rays.py::get_rays, as in the JAX module.
from consistentnerf_tpu_torch.core.rays import pixel_dirs, world_to_camera
from consistentnerf_tpu_torch.ops import fused_mlp as fm

# OpenGL camera (y up, z back) -> projection convention (y down, z
# forward), as in consistency/reproject.py.
_FLIP_YZ = np.diag(np.array([1.0, -1.0, -1.0], np.float32))


# --- geometry --------------------------------------------------------------


def scale_K(K, sx: float, sy: float | None = None) -> torch.Tensor:
    """Intrinsics for an image resampled by sx (width) / sy (height), with
    the pixel-centre convention: cx' = (cx + 0.5) sx - 0.5."""
    sy = sx if sy is None else sy
    K = _as_tensor(K, None)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    one = torch.ones((), dtype=K.dtype, device=K.device)
    return torch.stack([
        torch.stack([K[0, 0] * sx, zero, (K[0, 2] + 0.5) * sx - 0.5]),
        torch.stack([zero, K[1, 1] * sy, (K[1, 2] + 0.5) * sy - 0.5]),
        torch.stack([zero, zero, one]),
    ])


def project_to_pixels(points_w: torch.Tensor, c2w_src: torch.Tensor, K,
                      H: int, W: int):
    """Project world points into a source camera (continuous coords).

    points_w [..., 3] against c2w_src [3, 4], or [B, ..., 3] against a
    batch of cameras [B, 3, 4]. Returns (x, y, z, valid): float pixel
    coordinates, the source-camera depth (positive in front after the y/z
    flip) and the in-frustum mask; the continuous analog of
    `consistency/reproject.py::world_to_ref_pixels`."""
    K = _as_tensor(K, points_w.device)
    lead = c2w_src.shape[:-2]
    w2c = world_to_camera(c2w_src)
    R, T = w2c[..., :3, :3], w2c[..., :3, 3]
    flip = torch.as_tensor(_FLIP_YZ, device=points_w.device)
    pts = points_w.reshape(*lead, -1, 3)
    p_cam = ((pts @ R.transpose(-1, -2) + T.unsqueeze(-2)) @ flip).reshape(
        points_w.shape)
    z = p_cam[..., 2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    x = K[0, 0] * p_cam[..., 0] / zs + K[0, 2]
    y = K[1, 1] * p_cam[..., 1] / zs + K[1, 2]
    valid = (z > 1e-4) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return x, y, z, valid


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample img [H, W, C] at float coords x / y [...] ->
    [..., C]; or a batch img [B, H, W, C] at x / y [B, ...].

    The JAX module's four clamped gathers (not `grid_sample`, whose edge
    weights differ): the gradient reaches x / y through the weights."""
    H, W, C = img.shape[-3:]
    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    flat = img.reshape(-1, C)
    base = 0
    if img.dim() == 4:
        base = (torch.arange(img.shape[0], device=img.device) * (H * W)
                ).view(-1, *([1] * (x.dim() - 1)))

    def at(yy, xx):
        idx = (yy * W + xx).long() + base
        return flat[idx.reshape(-1)].reshape(*idx.shape, C)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _world_dirs(H: int, W: int, K: torch.Tensor,
                c2w_ref: torch.Tensor) -> torch.Tensor:
    """The reference camera's pixel directions in world space [H, W, 3]."""
    return pixel_dirs(H, W, K, device=K.device) @ c2w_ref[:3, :3].T


def plane_sweep_warp(src_feat: torch.Tensor, c2w_ref: torch.Tensor,
                     c2w_src: torch.Tensor, K, depth_values: torch.Tensor,
                     H: int, W: int):
    """Warp source feature maps onto fronto-parallel reference planes.

    src_feat [H, W, C] with c2w_src [3, 4], or a batch [V, H, W, C] with
    [V, 3, 4]; depth_values [D]. Returns (warped [(V,) D, H, W, C], valid
    [(V,) D, H, W]): every plane and view in one gather."""
    K = _as_tensor(K, src_feat.device)
    dirs_w = _world_dirs(H, W, K, c2w_ref)
    pts = c2w_ref[:3, 3] + depth_values[:, None, None, None] * dirs_w[None]
    pts = pts.expand(*c2w_src.shape[:-2], *pts.shape)
    x, y, _, valid = project_to_pixels(pts, c2w_src, K, H, W)
    warped = bilinear_sample(src_feat, x, y)
    return warped * valid[..., None].to(warped.dtype), valid


def warp_src_to_ref(src_img: torch.Tensor, depth_ref: torch.Tensor,
                    c2w_ref: torch.Tensor, c2w_src: torch.Tensor, K):
    """Warp a source image [H, W, C] (c2w [3, 4]), or a batch [V, H, W, C]
    ([V, 3, 4]), into the reference view through a per-pixel reference
    depth [H, W]. Returns (warped [(V,) H, W, C], valid [(V,) H, W])."""
    H, W = depth_ref.shape
    K = _as_tensor(K, src_img.device)
    dirs_w = _world_dirs(H, W, K, c2w_ref)
    pts = c2w_ref[:3, 3] + depth_ref[..., None] * dirs_w
    pts = pts.expand(*c2w_src.shape[:-2], *pts.shape)
    x, y, _, valid = project_to_pixels(pts, c2w_src, K, H, W)
    valid = valid & (depth_ref > 0)
    return bilinear_sample(src_img, x, y) * valid[..., None], valid


# --- networks --------------------------------------------------------------


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance
    1 / fan_in (std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    with torch.no_grad():
        w.copy_((z * std).to(w.dtype))


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              strides: Sequence[int]) -> list:
    """flax's `padding="SAME"` for spatial sizes (in order), as `F.pad`
    takes them (last dimension first)."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for lo_hi in reversed(pads) for p in lo_hi]


class SameConv(nn.Module):
    """A flax `nn.Conv(padding="SAME")`: weight [out, in, *k], bias [out]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), stride
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.weight, self.weight[0].numel(), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        nd = len(self.kernel)
        x = F.pad(x.to(dtype), same_pads(x.shape[-nd:], self.kernel,
                                         (self.stride,) * nd))
        conv = F.conv2d if nd == 2 else F.conv3d
        return conv(x, self.weight.to(dtype), self.bias.to(dtype),
                    stride=self.stride)


class SameConvTranspose3d(nn.Module):
    """A flax `nn.ConvTranspose(padding="SAME")` in 3D: weight [in, out,
    *k] holds flax's kernel flipped on its spatial axes, so the forward is
    `conv_transpose3d` with no padding, cropped to flax's output size s n
    on each spatial axis."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax counts a transpose kernel's fan-in as prod(k) * in.
        _lecun_normal_(self.weight,
                       self.weight.shape[0] * self.weight[0, 0].numel(),
                       generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv_transpose3d(x.to(dtype), self.weight.to(dtype),
                               self.bias.to(dtype), stride=self.stride)
        return y[(...,) + tuple(slice(0, self.stride * n)
                                for n in x.shape[2:])]


def _crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop x to ref's spatial shape (NC... layout): odd sizes round up
    under stride 2."""
    return x[(...,) + tuple(slice(0, s) for s in ref.shape[2:])]


class _Net(nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = fm.as_dtype(dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)


class FeatureNet2D(_Net):
    """2D features: images [..., H, W, 3] -> [..., ceil(H/4), ceil(W/4),
    4 base_ch] in the compute dtype."""

    def __init__(self, base_ch: int = 8, dtype="float32"):
        super().__init__(dtype)
        c = base_ch
        spec = [(3, c, 3, 1), (c, c, 3, 1), (c, 2 * c, 5, 2),
                (2 * c, 2 * c, 3, 1), (2 * c, 4 * c, 5, 2),
                (4 * c, 4 * c, 3, 1), (4 * c, 4 * c, 3, 1)]
        self.convs = nn.ModuleList(SameConv(i, o, (k, k), s)
                                   for i, o, k, s in spec)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        lead = img.shape[:-3]
        h = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
        for i, conv in enumerate(self.convs):
            h = conv(h, self.dtype)
            if i < len(self.convs) - 1:
                h = torch.relu(h)
        return h.permute(0, 2, 3, 1).reshape(*lead, *h.shape[2:],
                                             h.shape[1])


class CostRegNet3D(_Net):
    """3D U-Net over the cost volume [D, H, W, C] -> score [D, H, W]."""

    def __init__(self, base_ch: int = 8, dtype="float32"):
        super().__init__(dtype)
        c = base_ch
        k = (3, 3, 3)
        self.convs = nn.ModuleList([
            SameConv(4 * c, c, k), SameConv(c, 2 * c, k, 2),
            SameConv(2 * c, 2 * c, k), SameConv(2 * c, 4 * c, k, 2),
            SameConv(4 * c, 4 * c, k), SameConv(c, 1, k)])
        self.ups = nn.ModuleList([SameConvTranspose3d(4 * c, 2 * c, k),
                                  SameConvTranspose3d(2 * c, c, k)])

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        dt, cv, up = self.dtype, self.convs, self.ups
        v = vol.permute(3, 0, 1, 2)[None]
        x0 = torch.relu(cv[0](v, dt))
        x1 = torch.relu(cv[2](torch.relu(cv[1](x0, dt)), dt))
        x2 = torch.relu(cv[4](torch.relu(cv[3](x1, dt)), dt))
        y1 = _crop_like(torch.relu(up[0](x2, dt)), x1) + x1
        y0 = _crop_like(torch.relu(up[1](y1, dt)), x0) + x0
        return cv[5](y0, dt)[0, 0]


class RefineNet2D(_Net):
    """Full-resolution residual refinement of the upsampled coarse depth,
    conditioned on the reference image."""

    def __init__(self, base_ch: int = 16, dtype="float32"):
        super().__init__(dtype)
        c = base_ch
        self.convs = nn.ModuleList([
            SameConv(4, c, (3, 3)), SameConv(c, c, (3, 3)),
            SameConv(c, c, (3, 3)), SameConv(c, 1, (3, 3))])

    def forward(self, img: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        h = torch.cat([img.to(self.dtype), depth[..., None].to(self.dtype)],
                      -1).permute(2, 0, 1)[None]
        for i, conv in enumerate(self.convs):
            h = conv(h, self.dtype)
            if i < len(self.convs) - 1:
                h = torch.relu(h)
        return depth + h[0, 0].to(depth.dtype)


class MVSDepthNet(nn.Module):
    """Plane-sweep MVS: reference + source views -> reference depth and
    confidence (the depth-prior role of the reference's external
    MVSNeRF)."""

    def __init__(self, num_depths: int = 32, base_ch: int = 8,
                 dtype="float32"):
        super().__init__()
        self.num_depths = num_depths
        self.feature = FeatureNet2D(base_ch, dtype)
        self.cost_reg = CostRegNet3D(base_ch, dtype)
        self.refine = RefineNet2D(2 * base_ch, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.feature, self.cost_reg, self.refine):
            m.reset_parameters(generator)

    def forward(self, ref_img: torch.Tensor, src_imgs: torch.Tensor,
                c2w_ref: torch.Tensor, c2w_srcs: torch.Tensor, K,
                near: float, far: float):
        """ref_img [H, W, 3], src_imgs [V, H, W, 3], c2w_ref [3, 4],
        c2w_srcs [V, 3, 4], K [3, 3] full-resolution intrinsics. Returns
        {depth [H, W], depth_lo [Hr, Wr], conf [H, W], prob [D, Hr, Wr],
        depth_values [D]}."""
        H, W = ref_img.shape[0], ref_img.shape[1]
        dev = ref_img.device
        K = _as_tensor(K, dev)
        feats = self.feature(torch.cat([ref_img[None], src_imgs], 0))
        f_ref, f_srcs = feats[0], feats[1:]
        Hr, Wr = f_ref.shape[0], f_ref.shape[1]  # ceil(H/4), ceil(W/4)
        Kr = scale_K(K, Wr / W, Hr / H)
        D = self.num_depths
        planes = torch.arange(D, dtype=torch.float32, device=dev)
        d_values = near + (far - near) * (planes + 0.5) / D

        warped, valid = plane_sweep_warp(f_srcs, c2w_ref, c2w_srcs, Kr,
                                         d_values, Hr, Wr)
        # Visibility-weighted variance over {ref} and the warped sources;
        # the view sums run in the JAX order (view 0 first).
        w = valid[..., None].to(warped.dtype)
        s1, s2, n = warped[0] * w[0], warped[0] ** 2 * w[0], w[0]
        for v in range(1, warped.shape[0]):
            s1 = s1 + warped[v] * w[v]
            s2 = s2 + warped[v] ** 2 * w[v]
            n = n + w[v]
        tot_w = 1.0 + n
        mean = (f_ref[None] + s1) / tot_w
        sq = (f_ref[None] ** 2 + s2) / tot_w
        cost = sq - mean ** 2  # [D, Hr, Wr, C]

        score = self.cost_reg(cost)
        prob = torch.softmax(-score.float(), dim=0)
        depth_lo = torch.sum(prob * d_values[:, None, None], 0)
        # Confidence: the probability mass within 1.5 planes of the
        # soft-argmin (MVSNet's photometric confidence).
        idx = torch.clamp(torch.sum(prob * planes[:, None, None], 0), 0,
                          D - 1)
        window = ((planes[:, None, None] - idx[None]).abs() <= 1.5).to(
            prob.dtype)
        conf_lo = torch.sum(prob * window, 0)

        up = torch.stack([depth_lo, conf_lo])[None]
        depth_up, conf = F.interpolate(up, size=(H, W), mode="bilinear",
                                       align_corners=False,
                                       antialias=False)[0]
        depth = torch.clamp(self.refine(ref_img, depth_up), near, far)
        return {"depth": depth, "depth_lo": depth_lo, "conf": conf,
                "prob": prob, "depth_values": d_values}


def select_source_views(poses: np.ndarray, i_train: Sequence[int],
                        ref: int, n_src: int) -> np.ndarray:
    """The n_src train views whose camera centres are nearest to ref's
    (itself excluded)."""
    poses = np.asarray(poses)
    centers = poses[:, :3, 3]
    cand = np.array([v for v in i_train if v != ref])
    d = np.linalg.norm(centers[cand] - centers[ref], axis=-1)
    return cand[np.argsort(d)[:n_src]]
