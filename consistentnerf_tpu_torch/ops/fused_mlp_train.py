"""The v1 trainable fused MLP: kernel forward and kernel weight grads.

Port of `consistentnerf_tpu/ops/fused_mlp_train.py`, the JAX package's
first-generation train kernels, which its two-call step runs for
`fused_kernel="v1"` and `"hybrid"`:

  `fused_mlp_train`   forward #13 (`_fwd_pallas`, per tile `_forward_tile`)
                      and weight grads #14 (`_bwd_pallas`, per tile
                      `_backward_tile`), a `torch.autograd.Function`;
  `hybrid_mlp_train`  the plain forward (`_fwd_xla`: the JAX package runs
                      that forward outside any kernel) and #14.

The contract is the JAX one: `weights` is the flat list in
`fused_mlp.flatten_params` order (torch layout), fp32, cast to the compute
dtype inside, so the weight cotangents are fp32; points and view
directions are row-major [N, 3]; the output is [N, 4] (rgb logits 0..2,
density 3); the input grads are zero (sample positions carry no trainable
parameters in the NeRF step, run_nerf_view.py:527).

#13 is `csrc/fused_mlp_v1_fwd.cu` (the launch it shares with #12,
`fused_mlp.v1_forward`), #14 `csrc/fused_mlp_v1_bwd.cu`; both are the
port's shared walks under the row-major layout, with v1's shapes (heads on
[pe | h] after a skip at the last trunk layer, PE degrees past the TPU v2
kernel's 20-frequency register). #14 in bf16 runs #11's level walk and dW
GEMM (`csrc/level_train.cuh`, nine-slot plan, a `gpart` buffer), in fp32
`train_block`; both reduce dW deterministically, in a fixed order with no
atomics. The TPU kernel's
128-lane output padding (`out_lanes`) is a Mosaic relayout device and is
not carried over. On CPU tensors the ops run the plain versions
`plain_forward` (`_forward_tile`'s output: `fused_mlp._mlp_body`) and
`plain_backward` (`_backward_tile`'s grads: autograd through it).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

FWD_KERNEL = fm.KERNEL  # csrc/fused_mlp_v1_fwd.cu (#13; #12 shares it)
BWD_KERNEL = "fused_mlp_v1_bwd"  # csrc/fused_mlp_v1_bwd.cu (#14)
# Launches of #13 and #14 since import (or since the caller last reset).
fwd_launches = 0
bwd_launches = 0


def plain_forward(weights, pts, views, net_depth, skips, multires,
                  multires_views, compute_dtype) -> torch.Tensor:
    """The plain version of #13 on any device: pts/views [N, 3] -> raw
    [N, 4] (no kernel). `weights`: the flat list or a v1 PackedMLP."""
    flat = weights.flat if isinstance(weights, v2.PackedMLP) else weights
    return fm._mlp_body(pts, views, flat, net_depth=net_depth,
                        skips=tuple(skips), multires=multires,
                        multires_views=multires_views,
                        compute_dtype=compute_dtype)


def plain_backward(weights, pts, views, g, net_depth, skips, multires,
                   multires_views, compute_dtype) -> List[torch.Tensor]:
    """The plain version of #14 on any device: the weight grads (fp32,
    torch layout) of `plain_forward` for the cotangent g [N, 4]."""
    flat = weights.flat if isinstance(weights, v2.PackedMLP) else weights
    ws = [w.detach().float().requires_grad_() for w in flat]
    with torch.enable_grad():
        out = fm._mlp_body(pts, views, ws, net_depth=net_depth,
                           skips=tuple(skips), multires=multires,
                           multires_views=multires_views,
                           compute_dtype=compute_dtype)
        return list(torch.autograd.grad(out, ws, g.float()))


def forward(weights, pts: torch.Tensor, views: torch.Tensor, net_depth: int,
            skips, multires: int, multires_views: int,
            compute_dtype) -> torch.Tensor:
    """#13: pts/views [N, 3] -> raw [N, 4]. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if pts.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            fm.v1_packed_for(weights, net_depth, skips, multires,
                             multires_views, cd)
        return plain_forward(weights, pts, views, net_depth, skips,
                             multires, multires_views, cd)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused forward for device {pts.device}")
    packed = fm.v1_packed_for(weights, net_depth, skips, multires,
                              multires_views, cd)
    out, launched = fm.v1_forward(packed, pts, views)
    global fwd_launches
    fwd_launches += launched
    return out


def backward(weights, pts: torch.Tensor, views: torch.Tensor,
             g: torch.Tensor, net_depth: int, skips, multires: int,
             multires_views: int, compute_dtype) -> List[torch.Tensor]:
    """#14: the weight grads for the raw cotangent g [N, 4], the
    torch-layout list (fp32). CPU tensors take the plain version; CUDA
    tensors launch the kernel (and its dW reduction) or raise."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if pts.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            fm.v1_packed_for(weights, net_depth, skips, multires,
                             multires_views, cd)
        return plain_backward(weights, pts, views, g, net_depth, skips,
                              multires, multires_views, cd)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused backward for device {pts.device}")
    packed = fm.v1_packed_for(weights, net_depth, skips, multires,
                              multires_views, cd)
    grads, launched = v2.dw_launch(BWD_KERNEL, BWD_KERNEL, packed, pts,
                                   views, g, row=True)
    global bwd_launches
    bwd_launches += launched
    return grads


class _V1Train(torch.autograd.Function):
    """raw = MLP(pts, views); weight grads from #14, zero input grads.
    `hybrid`: the plain forward in place of #13."""

    @staticmethod
    def forward(ctx, config, packed, hybrid, pts, views, *weights):
        src = packed if packed is not None else list(weights)
        ctx.config, ctx.src = config, src
        ctx.save_for_backward(pts, views)
        run = plain_forward if hybrid else forward
        if hybrid and isinstance(src, v2.PackedMLP):
            src = src.flat
        return run(src, pts, views, *config)

    @staticmethod
    def backward(ctx, g):
        pts, views = ctx.saved_tensors
        grads = backward(ctx.src, pts, views, g.contiguous(), *ctx.config)
        d_pts = torch.zeros_like(pts) if ctx.needs_input_grad[3] else None
        d_views = torch.zeros_like(views) if ctx.needs_input_grad[4] else None
        return (None, None, None, d_pts, d_views, *grads)


def _op(hybrid, weights, pts, views, net_depth, skips, multires,
        multires_views, compute_dtype, packed):
    config = (net_depth, tuple(sorted(skips)), multires, multires_views,
              fm.as_dtype(compute_dtype))
    return _V1Train.apply(config, packed, hybrid, pts, views, *weights)


def fused_mlp_train(weights: Sequence[torch.Tensor], pts, views,
                    net_depth: int = 8, skips=(4,), multires: int = 10,
                    multires_views: int = 4, compute_dtype=torch.float32,
                    packed=None) -> torch.Tensor:
    """Differentiable v1 fused MLP: pts/views [N, 3] -> raw [N, 4];
    forward #13, weight grads #14. `weights` is the torch-layout parameter
    list that receives the grads; `packed` (the same weights as
    `fused_mlp.pack_v1` packs them, for a CUDA caller that already
    packed) is optional."""
    return _op(False, weights, pts, views, net_depth, skips, multires,
               multires_views, compute_dtype, packed)


def hybrid_mlp_train(weights: Sequence[torch.Tensor], pts, views,
                     net_depth: int = 8, skips=(4,), multires: int = 10,
                     multires_views: int = 4, compute_dtype=torch.float32,
                     packed=None) -> torch.Tensor:
    """`fused_mlp_train` with the plain forward (`_mlp_body`, no kernel,
    as the JAX package's `_fwd_xla`) and weight grads #14."""
    return _op(True, weights, pts, views, net_depth, skips, multires,
               multires_views, compute_dtype, packed)
