"""The NeRF MLPs as `nn.Module`s: the vanilla `NeRFMLP` and mip-NeRF's
`MipMLP`.

Architecture of `nerf-pytorch-master/run_nerf_helpers.py:67-130`: an 8x256
trunk with the skip concat [pts_embed, h] after layer 4, a 128-wide
view branch, plus ConsistentNeRF's learnable `temp_rgb` / `temp_depth` /
`depth_scale` scalars. Parameter names are the reference's, so a
nerf-pytorch `.tar` state_dict loads with `load_state_dict`.

At `dtype=bfloat16` the forward rounds where the fused kernel rounds
(ops/fused_mlp.py::_mlp_body): bf16 operands, fp32 accumulation and
biases, fp32 rgb/alpha out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from consistentnerf_tpu_torch.ops import fused_mip
from consistentnerf_tpu_torch.ops import fused_mlp as fm


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's lecun_normal: truncated normal on [-2, 2] std, variance
    1/fan_in (std corrected for the truncation)."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1)
    with torch.no_grad():
        w.copy_((z * std).to(w.dtype))


class NeRFMLP(nn.Module):
    """Vanilla NeRF MLP with ConsistentNeRF temperature parameters."""

    def __init__(self, net_depth: int = 8, net_width: int = 256,
                 input_ch: int = 63, input_ch_views: int = 27,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True,
                 output_ch: int = 4, dtype=torch.float32):
        super().__init__()
        self.net_depth = net_depth
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.dtype = fm.as_dtype(dtype)
        W = net_width
        self.pts_linears = nn.ModuleList(
            [nn.Linear(input_ch, W)]
            + [nn.Linear(W + input_ch if i in self.skips else W, W)
               for i in range(net_depth - 1)]
        )
        # A skip after the last trunk layer feeds the heads [pe | h], as in
        # the JAX NeRFMLP (at netdepth 5 with the skip after layer 4).
        head_in = W + input_ch if net_depth - 1 in self.skips else W
        if use_viewdirs:
            self.views_linears = nn.ModuleList(
                [nn.Linear(input_ch_views + W, W // 2)])
            self.feature_linear = nn.Linear(head_in, W)
            self.alpha_linear = nn.Linear(head_in, 1)
            self.rgb_linear = nn.Linear(W // 2, 3)
        else:
            self.output_linear = nn.Linear(head_in, output_ch)
        # Consumed by the soft-mask losses, not by the forward pass.
        self.temp_rgb = nn.Parameter(torch.full((1,), -0.7))
        self.temp_depth = nn.Parameter(torch.full((1,), -0.7))
        self.depth_scale = nn.Parameter(torch.full((1,), 1.0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: lecun-normal kernels, zero biases (the JAX
        package's initializers)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, pts_embed: torch.Tensor,
                views_embed: Optional[torch.Tensor]) -> torch.Tensor:
        """pts_embed [..., C_pts], views_embed [..., C_views] (or None).
        Returns [..., 4] rgb + density logits in fp32."""
        lead = pts_embed.shape[:-1]
        weights = fm.flatten_params(self, self.use_viewdirs, self.net_depth)
        views = None
        if views_embed is not None:
            views = views_embed.reshape(-1, views_embed.shape[-1])
        out = fm._mlp_encoded(
            pts_embed.reshape(-1, pts_embed.shape[-1]), views, weights,
            net_depth=self.net_depth, skips=self.skips,
            use_viewdirs=self.use_viewdirs, compute_dtype=self.dtype,
        )
        return out.reshape(*lead, out.shape[-1])


def _glorot_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's glorot_uniform: U(-b, b), b = sqrt(6 / (fan_in + fan_out))."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    with torch.no_grad():
        w.copy_(((2 * u - 1) * bound).to(w.dtype))


class MipMLP(nn.Module):
    """mip-NeRF MLP (`RegNeRF/internal/models.py:172-280`): IPE of the
    samples' Gaussians into an 8x256 trunk with the skip concat
    [act, inputs] after layer 4, a density head, a 256-wide bottleneck,
    one 128-wide view layer on [bottleneck, pos_enc(viewdirs)], an rgb
    head; sigmoid rgb with padding, softplus density with bias -1.

    The layers are `dense.0` .. `dense.{D+3}`, the JAX package's
    `Dense_0` .. `Dense_{D+3}` (trunk, density, bottleneck, view layer,
    rgb). With `use_viewdirs=False` there is no bottleneck or view layer:
    `dense.0` .. `dense.{D+1}` (trunk, density, rgb on the trunk's
    output, models/mlp.py:150-171 of the JAX package). At `dtype=bfloat16` the forward rounds where the fused kernels
    round (ops/fused_mip.py::_mip_body). With `disable_normals=False` the
    forward also returns the normals, -normalize(d density / d means)
    (models.py:244-262), from the gradient that
    `fused_mip.plain_fwd_normals_T` takes by autograd, rounded where the
    normals kernel (6n) rounds; they carry no graph (they feed no
    loss)."""

    def __init__(self, net_depth: int = 8, net_width: int = 256,
                 net_width_viewdirs: int = 128, max_deg_point: int = 16,
                 deg_view: int = 4, skip_layer: int = 4,
                 density_noise: float = 0.0, density_bias: float = -1.0,
                 rgb_padding: float = 0.001, disable_normals: bool = True,
                 use_viewdirs: bool = True, dtype=torch.float32):
        super().__init__()
        self.net_depth = net_depth
        self.use_viewdirs = use_viewdirs
        self.disable_normals = disable_normals
        self.max_deg_point = max_deg_point
        self.deg_view = deg_view
        self.skip_layer = skip_layer
        self.density_noise = density_noise
        self.density_bias = density_bias
        self.rgb_padding = rgb_padding
        self.dtype = fm.as_dtype(dtype)
        n_in = 6 * max_deg_point
        ins = [n_in]
        for i in range(1, net_depth + 1):
            skip = (i - 1) % skip_layer == 0 and i - 1 > 0
            ins.append(net_width + n_in if skip else net_width)
        trunk_out = ins.pop()
        view_in = net_width + 3 * (1 + 2 * deg_view)
        heads = ([(trunk_out, net_width), (view_in, net_width_viewdirs),
                  (net_width_viewdirs, 3)] if use_viewdirs
                 else [(trunk_out, 3)])
        dims = [(k, net_width) for k in ins] + [(trunk_out, 1)] + heads
        self.dense = nn.ModuleList([nn.Linear(k, n) for k, n in dims])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: glorot-uniform kernels, zero biases (the JAX
        package's initializers)."""
        for m in self.dense:
            _glorot_uniform_(m.weight, generator)
            nn.init.zeros_(m.bias)

    def forward(self, means: torch.Tensor, covs: torch.Tensor,
                viewdirs: torch.Tensor,
                noise: Optional[torch.Tensor] = None):
        """means, covs (diagonal), viewdirs: [N, 3] (viewdirs unread, may
        be None, without `use_viewdirs`); `noise` [N] standard normals of
        the density noise (used when density_noise > 0).
        Returns (rgb [N, 3], density [N], normals [N, 3] or None when
        `disable_normals`)."""
        flat = fused_mip.flatten_mip_params(self, self.net_depth)
        if not self.use_viewdirs:
            viewdirs = None

        def head_logit(raw):
            x = raw[:, 3]
            if noise is not None and self.density_noise > 0:
                x = x + self.density_noise * noise
            return x + self.density_bias

        normals = None
        if self.disable_normals or torch.is_grad_enabled():
            raw = fused_mip._mip_body(
                means, covs, viewdirs, flat, net_depth=self.net_depth,
                num_freqs=self.max_deg_point, deg_view=self.deg_view,
                skip_layer=self.skip_layer, compute_dtype=self.dtype)
        if not self.disable_normals:
            # d(raw density)/d(means) by autograd, rounded as kernel 6n
            # rounds it; the normals carry no graph.
            rows = fused_mip.plain_fwd_normals_T(
                flat, means.T, covs.T,
                None if viewdirs is None else viewdirs.T, self.net_depth,
                self.max_deg_point, self.dtype, self.deg_view,
                self.skip_layer).T
            if not torch.is_grad_enabled():
                raw = rows[:, :4]
            grad = rows[:, 4:] * torch.sigmoid(head_logit(rows))[:, None]
            eps = torch.finfo(torch.float32).eps
            normals = -grad / torch.sqrt(torch.clamp(
                (grad ** 2).sum(-1, keepdim=True), min=eps))
        density = softplus(head_logit(raw))
        rgb = torch.sigmoid(raw[:, :3]) * (1 + 2 * self.rgb_padding) \
            - self.rgb_padding
        return rgb, density, normals


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))
