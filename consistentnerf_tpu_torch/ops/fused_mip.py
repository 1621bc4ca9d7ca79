"""The fused MipMLP on transposed point streams: forward, weight grads and
the differentiable op built from the two.

`fwd_T` is the port of `consistentnerf_tpu/ops/fused_mip.py::
_fwd_pallas_T` (kernel #6): the Gaussians' means, diagonal covariances
and view directions [3, N] in, the raw heads [4, N] out (rgb logits rows
0..2, density logit row 3; sigmoid, rgb padding, softplus and density
noise stay outside, as in the JAX package). On a CUDA tensor it launches
the hand-written kernel `csrc/fused_mip_fwd.cu` (or raises); on a CPU
tensor it runs the plain version `_mip_body`. `bwd_T` is the port of
`_bwd_pallas_T` (kernel #7): the weight grads for a raw cotangent
g [4, N], from `csrc/fused_mip_bwd.cu` or, on the CPU, autograd through
`_mip_body` (`plain_bwd_T`). `fused_mip_mlp_train_T` is the
differentiable op: forward #6, backward #7. `fused_mip_mlp_normals_T` is
#6 `with_normals` (kernel 6n, `fused_mip_fwd_normals` in the same
source): the raw heads and d(raw density)/d(means) [7, N], for the
render of `disable_normals=False` configs; its plain version is
`plain_fwd_normals_T` (autograd through `_mip_encoded`).

The MipMLP differs from the NeRFMLP only in its encoder and in the column
order of its skip concat, so the kernels share the NeRF kernels' walk
(`csrc/mlp_fwd.cuh`, `csrc/mlp_train.cuh`) under an encoder policy, and
the weights are packed by `fused_mlp_v2.pack(..., encoder="ipe")`, whose
packed walks (`packed_reference_T`, `packed_bwd_reference_T`) are the
kernels' references here too. The TPU kernels' packed 128-lane IPE
register, pi/2 phase-bias row and sin(2^-14 v) 2^14 raw-viewdir columns
are Mosaic lane-layout devices and are not carried over: the CUDA kernels
compute the IPE per feature (fp32 floor-mod range reduction of
`core/mathx.safe_sin`, then the cast) and read the raw view directions.

The flat weight list (`flatten_mip_params`) is in torch layout ([out, in]
weights), in the JAX package's Dense_0..Dense_{D+3} order: the trunk,
the density head, the bottleneck, the view layer, the rgb head. A MipMLP
without view directions has Dense_0..Dense_{D+1} (the trunk, the density
head, the rgb head on the trunk's output): its plain versions here read
that shorter list, and the kernels' wrappers and packers refuse it
(`check_kernel_weights`), as the JAX package's kernel paths fail on it.

The row-major family takes [N, 3] means, covs and views and gives
[N, 4]: `fwd` is the port of `_fwd_pallas` (kernel #15,
`fused_mip_fwd_row` in `csrc/fused_mip_fwd.cu`) and `bwd` of
`_bwd_pallas` (kernel #16, `fused_mip_bwd_row` in
`csrc/fused_mip_bwd.cu`), #6's and #7's walks under the kernels'
row-major stream layout (in bf16 the Hopper forward walk, so #15 gives
#6's bits; the level walk with its dW GEMM in bf16 and fp32, so #16 gives
#7's bits on the same points), with the plain versions `plain_fwd_row` /
`plain_bwd_row`;
`fused_mip_mlp_train` is their differentiable op.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from consistentnerf_tpu_torch.core import encoding
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

KERNEL = "fused_mip_fwd"
BWD_KERNEL = "fused_mip_bwd"
NORMALS_KERNEL = "fused_mip_fwd_normals"  # a kernel of fused_mip_fwd.cu
ROW_KERNEL = "fused_mip_fwd_row"  # a kernel of fused_mip_fwd.cu
ROW_BWD_KERNEL = "fused_mip_bwd_row"  # a kernel of fused_mip_bwd.cu
# Kernel launches since import (or since the caller last reset them).
launches = 0
bwd_launches = 0
normals_launches = 0
row_launches = 0
row_bwd_launches = 0

SKIP_LAYER = 4  # MipMLP.skip_layer
DEG_VIEW = 4  # MipMLP.deg_view
RGB_PADDING = 0.001  # MipMLP.rgb_padding
DENSITY_BIAS = -1.0  # MipMLP.density_bias


def post_skip_layers(net_depth: int, skip_layer: int = SKIP_LAYER) -> set:
    """Trunk layers whose input is [act, inputs] (models/mlp.py:112-113:
    the concat follows layer i when i % skip_layer == 0, i > 0)."""
    return {i for i in range(1, net_depth)
            if (i - 1) % skip_layer == 0 and i - 1 > 0}


def mip_skips(net_depth: int, skip_layer: int = SKIP_LAYER) -> tuple:
    """The post-skip layers as `fused_mlp_v2.pack` names them (the layer
    after which the concat happens). A concat after the last trunk layer
    would feed the heads, which neither the JAX fused kernels nor these
    take."""
    last = net_depth - 1
    if last > 0 and last % skip_layer == 0:
        raise ValueError(f"net_depth {net_depth} puts a skip concat after "
                         "the last trunk layer; the fused MipMLP kernels "
                         "do not take it")
    return tuple(sorted(i - 1 for i in post_skip_layers(net_depth,
                                                        skip_layer)))


def flatten_mip_params(mlp: Union[nn.Module, dict],
                       net_depth: int = 8) -> List[torch.Tensor]:
    """A MipMLP (or its state_dict) -> the flat torch-layout list
    [w0, b0, ..., w_{D+3}, b_{D+3}] ([w0, b0, ..., w_{D+1}, b_{D+1}]
    without view directions); a module's are its parameters (gradients
    flow), a state_dict's its tensors."""
    sd = dict(mlp.named_parameters()) if isinstance(mlp, nn.Module) else mlp
    n = net_depth + (4 if f"dense.{net_depth + 2}.weight" in sd else 2)
    out = []
    for i in range(n):
        out += [sd[f"dense.{i}.weight"], sd[f"dense.{i}.bias"]]
    return out


def has_view_layer(weights: Sequence[torch.Tensor], net_depth: int) -> bool:
    """Whether a flat list holds the bottleneck and view layer (D + 4
    layers) or not (D + 2: use_viewdirs=False)."""
    if len(weights) not in (2 * (net_depth + 4), 2 * (net_depth + 2)):
        raise ValueError(f"{len(weights)} tensors are not a MipMLP's at "
                         f"net_depth {net_depth}")
    return len(weights) == 2 * (net_depth + 4)


def check_kernel_weights(weights, net_depth: int) -> None:
    """The fused MipMLP kernels read the bottleneck and view layer: a
    list without them (use_viewdirs=False) raises, where the JAX
    package's `flatten_mip_params` raises KeyError 'Dense_{D+2}'."""
    if not isinstance(weights, v2.PackedMLP) and not has_view_layer(
            weights, net_depth):
        raise ValueError(
            "the fused MipMLP kernels need the view layer; use_viewdirs="
            f"false has none (the JAX kernel paths raise KeyError "
            f"'Dense_{net_depth + 2}' here): use the eager step and the "
            "module render")


def _mip_body(means, covs, views, weights: Sequence[torch.Tensor], *,
              net_depth, num_freqs, deg_view=DEG_VIEW,
              skip_layer=SKIP_LAYER, compute_dtype=torch.float32):
    """The plain MipMLP body on [N, 3] means, diagonal covs and view
    directions (None, unread, without a view layer): raw heads [N, 4]
    fp32 (rgb logits, density logit).

    Rounding follows the fused kernels (`_mip_aligned_forward`): the IPE
    and view encoding in fp32, then rounded; bf16 operands with fp32
    accumulation and fp32 biases; trunk activations and the view layer
    rounded after the ReLU, the bottleneck without one; heads fp32.

    A post-skip layer takes [act, inputs] (models/mlp.py:112-113) and is
    summed here, as in the kernels, in the order [inputs | act]: the same
    sum, but an fp32 sum in another order flips a ReLU whose input lies
    within rounding of zero, and with a random cotangent one flipped unit
    moves the grads of every layer below it by ~1/sqrt(N)."""
    cd = fm.as_dtype(compute_dtype)
    fm.strict_fp32(means.device)
    inputs = fm._round(encoding.integrated_pos_enc(
        means.float(), covs.float(), 0, num_freqs), cd)
    return _mip_encoded(inputs, views, weights, net_depth=net_depth,
                        deg_view=deg_view, skip_layer=skip_layer,
                        compute_dtype=cd)


def _mip_encoded(inputs, views, weights: Sequence[torch.Tensor], *,
                 net_depth, deg_view=DEG_VIEW, skip_layer=SKIP_LAYER,
                 compute_dtype=torch.float32):
    """`_mip_body` from the rounded IPE `inputs` [N, 6F] on: raw heads
    [N, 4] fp32."""
    cd = fm.as_dtype(compute_dtype)
    view_layer = has_view_layer(weights, net_depth)
    w = [fm._round(x.float(), cd) if i % 2 == 0 else x.float()
         for i, x in enumerate(weights)]
    post = post_skip_layers(net_depth, skip_layer)
    h = inputs
    for i in range(net_depth):
        wi = w[2 * i]
        if i in post:
            h = torch.cat([inputs, h], -1)
            k = inputs.shape[-1]
            wi = torch.cat([wi[:, -k:], wi[:, :-k]], 1)
        h = fm._round(torch.relu(F.linear(h, wi, w[2 * i + 1])), cd)
    if net_depth - 1 > 0 and (net_depth - 1) % skip_layer == 0:
        h = torch.cat([h, inputs], -1)  # the heads read the concat
    wi = 2 * net_depth
    density = F.linear(h, w[wi], w[wi + 1])
    if not view_layer:  # the rgb head reads the trunk's output
        return torch.cat([F.linear(h, w[wi + 2], w[wi + 3]), density], -1)
    bneck = fm._round(F.linear(h, w[wi + 2], w[wi + 3]), cd)
    venc = fm._round(encoding.pos_enc(views.float(), 0, deg_view), cd)
    hv = fm._round(torch.relu(F.linear(torch.cat([bneck, venc], -1),
                                       w[wi + 4], w[wi + 5])), cd)
    rgb = F.linear(hv, w[wi + 6], w[wi + 7])
    return torch.cat([rgb, density], -1)


def reference_mip_mlp_apply(weights, means, covs, views, *, net_depth=8,
                            skip_layer=SKIP_LAYER, num_freqs=16,
                            deg_view=DEG_VIEW, compute_dtype=torch.float32):
    """The plain forward on [N, 3] inputs from the flat list (or a
    MipMLP): raw heads [N, 4]."""
    if isinstance(weights, nn.Module):
        weights = flatten_mip_params(weights, net_depth)
    return _mip_body(means, covs, views, weights, net_depth=net_depth,
                     num_freqs=num_freqs, deg_view=deg_view,
                     skip_layer=skip_layer, compute_dtype=compute_dtype)


def pack(weights: Sequence[torch.Tensor], net_depth: int, num_freqs: int,
         compute_dtype, deg_view: int = DEG_VIEW) -> v2.PackedMLP:
    """The flat torch-layout list -> the kernels' packed buffers (in
    fp32 with the planes `w3` that the fp32 level walk of #5, #7 and #16
    reads)."""
    check_kernel_weights(weights, net_depth)
    return v2.pack(weights, net_depth, mip_skips(net_depth), num_freqs,
                   deg_view, compute_dtype, encoder="ipe")


def _packed_for(weights, net_depth, num_freqs, deg_view, cd):
    check_kernel_weights(weights, net_depth)
    return v2._packed_for(weights, net_depth, mip_skips(net_depth),
                          num_freqs, deg_view, cd, "ipe")


def _flat(weights):
    return weights.flat if isinstance(weights, v2.PackedMLP) else weights


def plain_fwd_T(weights, means_T, covs_T, views_T, net_depth, num_freqs,
                compute_dtype, deg_view=DEG_VIEW) -> torch.Tensor:
    """The plain version of `fwd_T` on any device (no kernel)."""
    out = _mip_body(means_T.T, covs_T.T, views_T.T, _flat(weights),
                    net_depth=net_depth, num_freqs=num_freqs,
                    deg_view=deg_view, compute_dtype=compute_dtype)
    return out.T.contiguous()


def _check_inputs(packed, dev, n, row=False, **streams):
    for name, t in streams.items():
        v2._check_stream(name, t, 3, n, dev, row=row)
    v2._check_weights(packed, dev)


def _cfg_args(packed: v2.PackedMLP):
    """The kernels' config ints: depth, width, view-layer width, skip
    mask, IPE frequencies, view degree, bf16."""
    skip_mask = sum(1 << s for s in packed.skips)
    return (packed.net_depth, packed.width, packed.view_width, skip_mask,
            packed.multires, packed.multires_views,
            int(packed.compute_dtype == torch.bfloat16))


def _fwd(row: bool, weights, means, covs, views, net_depth, num_freqs,
         compute_dtype, deg_view) -> torch.Tensor:
    """`fwd_T` (transposed streams, kernel #6) or, with `row`, `fwd`
    (row-major streams, kernel #15)."""
    cd = fm.as_dtype(compute_dtype)
    if means.device.type == "cpu":
        check_kernel_weights(weights, net_depth)
        if isinstance(weights, v2.PackedMLP):
            _packed_for(weights, net_depth, num_freqs, deg_view, cd)
        plain = plain_fwd_row if row else plain_fwd_T
        return plain(weights, means, covs, views, net_depth, num_freqs, cd,
                     deg_view)
    if means.device.type != "cuda":
        raise ValueError(f"no fused forward for device {means.device}")
    packed = _packed_for(weights, net_depth, num_freqs, deg_view, cd)
    n, dev = means.shape[0 if row else 1], means.device
    _check_inputs(packed, dev, n, row=row, means=means, covs=covs,
                  views=views)
    v2.check_tma_weights(packed)  # the Hopper walk's TMA, in bf16
    out = torch.empty((n, 4) if row else (4, n), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    symbol = ROW_KERNEL if row else KERNEL
    err = v2._entry(KERNEL, symbol, 6, 8)(
        means.data_ptr(), covs.data_ptr(), views.data_ptr(),
        packed.w.data_ptr(), packed.b.data_ptr(), out.data_ptr(), n,
        *_cfg_args(packed), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    global launches, row_launches
    if row:
        row_launches += 1
    else:
        launches += 1
    return out


def fwd_plan(packed: v2.PackedMLP, n: int, row: bool = False) -> dict:
    """The walk that kernel #6 (or, with `row`, #15: the same plan) runs
    for n points of the packed MipMLP, decided by shapes alone
    (`fused_mip_fwd_plan`; slots as `fused_mlp_v2.plan_dict`); needs the
    card."""
    return v2.plan_dict(v2._entry(KERNEL, "fused_mip_fwd_plan", 0, 9),
                        (n, *_cfg_args(packed), int(row)))


def fwd_T(weights, means_T: torch.Tensor, covs_T: torch.Tensor,
          views_T: torch.Tensor, net_depth: int, num_freqs: int,
          compute_dtype, deg_view: int = DEG_VIEW) -> torch.Tensor:
    """means/covs/views [3, N] -> raw heads [4, N] (kernel #6).

    `weights`: the flat torch-layout list or a packed MipMLP (`pack`).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _fwd(False, weights, means_T, covs_T, views_T, net_depth,
                num_freqs, compute_dtype, deg_view)


def plain_fwd_normals_T(weights, means_T, covs_T, views_T, net_depth,
                        num_freqs, compute_dtype, deg_view=DEG_VIEW,
                        skip_layer=SKIP_LAYER) -> torch.Tensor:
    """The plain version of `fused_mip_mlp_normals_T` on any device: the
    plain forward and, by autograd, the raw density's gradient by the
    means, rounded where the kernel rounds. The casts of `_mip_encoded`
    round the trunk's gradients to the compute type before each product,
    as the kernel does; the encoding's gradient stays fp32 (the IPE is a
    leaf here, so its cast does not round it) and goes through the IPE by
    autograd. Returns [7, N]. Inference mode has no gradient to take:
    run it under torch.no_grad()."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("the normals differentiate the density: run "
                           "them under torch.no_grad(), not inference_mode")
    cd = fm.as_dtype(compute_dtype)
    fm.strict_fp32(means_T.device)
    with torch.enable_grad():
        means = means_T.T.detach().float().requires_grad_()
        ipe = encoding.integrated_pos_enc(means, covs_T.T.float(), 0,
                                          num_freqs)
        inputs = fm._round(ipe.detach(), cd).requires_grad_()
        raw = _mip_encoded(inputs, None if views_T is None else views_T.T,
                           _flat(weights),
                           net_depth=net_depth, deg_view=deg_view,
                           skip_layer=skip_layer, compute_dtype=cd)
        g_sc, = torch.autograd.grad(raw[:, 3].sum(), inputs)
        dmeans, = torch.autograd.grad(ipe, means, g_sc)
    return torch.cat([raw.detach(), dmeans], 1).T.contiguous()


def fused_mip_mlp_normals_T(weights, means_T: torch.Tensor,
                            covs_T: torch.Tensor, views_T: torch.Tensor,
                            net_depth: int, num_freqs: int, compute_dtype,
                            deg_view: int = DEG_VIEW) -> torch.Tensor:
    """means/covs/views [3, N] -> [7, N] (kernel 6n): the raw heads
    (rgb logits 0..2, density logit 3) and d(raw density)/d(means) in
    rows 4..6. Not differentiable: the render's forward for
    `disable_normals=False` (the normals feed no loss). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    cd = fm.as_dtype(compute_dtype)
    if means_T.device.type == "cpu":
        check_kernel_weights(weights, net_depth)
        if isinstance(weights, v2.PackedMLP):
            _packed_for(weights, net_depth, num_freqs, deg_view, cd)
        return plain_fwd_normals_T(weights, means_T, covs_T, views_T,
                                   net_depth, num_freqs, cd, deg_view)
    if means_T.device.type != "cuda":
        raise ValueError(f"no fused forward for device {means_T.device}")
    packed = _packed_for(weights, net_depth, num_freqs, deg_view, cd)
    return normals_launch(packed, means_T, covs_T, views_T)


# `fused_mip_fwd_normals_plan`'s slots: `fused_mlp_v2.PLAN_SLOTS` (mode 5:
# not the Hopper walk, points a chunk, no ring, its shared memory, blocks,
# chunks), where the masks live (1: registers, the Hopper walk; 0: mode 5
# saves every activation), and mode 5's workspace elements (0 on the
# Hopper walk).
NORMALS_PLAN_SLOTS = v2.PLAN_SLOTS + ("masks_in_registers", "workspace")


def normals_plan(packed: v2.PackedMLP, n: int) -> dict:
    """The walk that 6n takes for n points of the packed MipMLP, decided by
    shapes alone (`NORMALS_PLAN_SLOTS`); needs the card."""
    out = (ctypes.c_longlong * len(NORMALS_PLAN_SLOTS))()
    err = v2._entry(KERNEL, NORMALS_KERNEL + "_plan", 0, 8)(
        n, *_cfg_args(packed), out)
    if err != 0:
        raise RuntimeError(f"{NORMALS_KERNEL} plan failed: cudaError_t "
                           f"{err}")
    return dict(zip(NORMALS_PLAN_SLOTS, list(out)))


def normals_launch(packed: v2.PackedMLP, means_T, covs_T,
                   views_T) -> torch.Tensor:
    """Kernel 6n on the device's [3, N] streams (no plain version): checks
    them, allocates mode 5's workspace where the plan runs mode 5 (none on
    the Hopper walk), launches and returns [7, N]."""
    n, dev = means_T.shape[1], means_T.device
    _check_inputs(packed, dev, n, means_T=means_T, covs_T=covs_T,
                  views_T=views_T)
    v2.check_tma_weights(packed)
    out = torch.empty((7, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    plan = normals_plan(packed, n)
    ws = (torch.empty(plan["workspace"], dtype=packed.compute_dtype,
                      device=dev) if plan["workspace"] else None)
    err = v2._entry(KERNEL, NORMALS_KERNEL, 7, 8)(
        means_T.data_ptr(), covs_T.data_ptr(), views_T.data_ptr(),
        packed.w.data_ptr(), packed.b.data_ptr(),
        ws.data_ptr() if ws is not None else None, out.data_ptr(), n,
        *_cfg_args(packed), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NORMALS_KERNEL} launch failed: cudaError_t "
                           f"{err}")
    global normals_launches
    normals_launches += 1
    return out


# ---------------------------------------------------------------------------
# Weight grads (kernel #7) and the differentiable op
# ---------------------------------------------------------------------------


def plain_bwd_T(weights, means_T, covs_T, views_T, g_T, net_depth,
                num_freqs, compute_dtype,
                deg_view=DEG_VIEW) -> List[torch.Tensor]:
    """The plain version of `bwd_T` on any device: autograd through
    `_mip_body` (torch-layout grads)."""
    ws = [w.detach().float().requires_grad_() for w in _flat(weights)]
    with torch.enable_grad():
        out = _mip_body(means_T.T, covs_T.T, views_T.T, ws,
                        net_depth=net_depth, num_freqs=num_freqs,
                        deg_view=deg_view, compute_dtype=compute_dtype)
        grads = torch.autograd.grad(out, ws, g_T.T.float())
    return list(grads)


def _bwd(row: bool, weights, means, covs, views, g, net_depth, num_freqs,
         compute_dtype, deg_view) -> List[torch.Tensor]:
    """`bwd_T` (transposed streams, kernel #7) or, with `row`, `bwd`
    (row-major streams, kernel #16)."""
    cd = fm.as_dtype(compute_dtype)
    if means.device.type == "cpu":
        check_kernel_weights(weights, net_depth)
        if isinstance(weights, v2.PackedMLP):
            _packed_for(weights, net_depth, num_freqs, deg_view, cd)
        plain = plain_bwd_row if row else plain_bwd_T
        return plain(weights, means, covs, views, g, net_depth, num_freqs,
                     cd, deg_view)
    if means.device.type != "cuda":
        raise ValueError(f"no fused backward for device {means.device}")
    packed = _packed_for(weights, net_depth, num_freqs, deg_view, cd)
    n, dev = means.shape[0 if row else 1], means.device
    _check_inputs(packed, dev, n, row=row, means=means, covs=covs,
                  views=views)
    v2._check_stream("g", g, 4, n, dev, row)
    grads, launched = v2.grad_launch(
        BWD_KERNEL, ROW_BWD_KERNEL if row else BWD_KERNEL, packed,
        (means, covs, views), g, _cfg_args(packed), row)
    global bwd_launches, row_bwd_launches
    if launched and row:
        row_bwd_launches += 1
    elif launched:
        bwd_launches += 1
    return grads


def bwd_T(weights, means_T: torch.Tensor, covs_T: torch.Tensor,
          views_T: torch.Tensor, g_T: torch.Tensor, net_depth: int,
          num_freqs: int, compute_dtype,
          deg_view: int = DEG_VIEW) -> List[torch.Tensor]:
    """Weight grads of `fwd_T` for the raw cotangent g_T [4, N] (kernel
    #7): the torch-layout list (fp32). CPU tensors take the plain
    version; CUDA tensors launch the kernel (and its dW reduction) or
    raise."""
    return _bwd(False, weights, means_T, covs_T, views_T, g_T, net_depth,
                num_freqs, compute_dtype, deg_view)


class _FusedMipTrain(torch.autograd.Function):
    """raw = MipMLP(means, covs, views); grads for the weights only (the
    samples are stop-gradient'ed or parameter-independent in both levels,
    models/mipnerf.py:82-93). `row`: row-major streams (#15, #16), whose
    op gives the inputs zero grads as the JAX op's VJP does
    (fused_mip.py:826-835); else transposed streams (#6, #7)."""

    @staticmethod
    def forward(ctx, config, packed, row, means, covs, views, *weights):
        src = packed if packed is not None else list(weights)
        ctx.config, ctx.src, ctx.row = config, src, row
        ctx.save_for_backward(means, covs, views)
        return _fwd(row, src, means, covs, views, *config)

    @staticmethod
    def backward(ctx, g):
        means, covs, views = ctx.saved_tensors
        grads = _bwd(ctx.row, ctx.src, means, covs, views, g.contiguous(),
                     *ctx.config)
        ins = ([torch.zeros_like(x) for x in (means, covs, views)]
               if ctx.row else [None] * 3)
        return (None, None, None, *ins, *grads)


def _train_op(row, weights, means, covs, views, net_depth, num_freqs,
              compute_dtype, deg_view, packed):
    config = (net_depth, num_freqs, fm.as_dtype(compute_dtype), deg_view)
    return _FusedMipTrain.apply(config, packed, row, means, covs, views,
                                *weights)


def fused_mip_mlp_train_T(weights: Sequence[torch.Tensor], means_T, covs_T,
                          views_T, net_depth: int, num_freqs: int,
                          compute_dtype, deg_view: int = DEG_VIEW,
                          packed: v2.PackedMLP = None) -> torch.Tensor:
    """Differentiable fused MipMLP on transposed streams: means/covs/views
    [3, N] -> raw [4, N]; the weight grads come from `bwd_T`. `weights`
    is the torch-layout parameter list that receives the grads; `packed`
    (the same weights packed, for a CUDA caller) is optional."""
    return _train_op(False, weights, means_T, covs_T, views_T, net_depth,
                     num_freqs, compute_dtype, deg_view, packed)


# ---------------------------------------------------------------------------
# The row-major family (kernels #15 and #16) and its differentiable op
# ---------------------------------------------------------------------------


def plain_fwd_row(weights, means, covs, views, net_depth, num_freqs,
                  compute_dtype, deg_view=DEG_VIEW) -> torch.Tensor:
    """The plain version of `fwd` on any device: [N, 3] streams -> raw
    heads [N, 4] (no kernel)."""
    return _mip_body(means, covs, views, _flat(weights), net_depth=net_depth,
                     num_freqs=num_freqs, deg_view=deg_view,
                     compute_dtype=compute_dtype)


def plain_bwd_row(weights, means, covs, views, g, net_depth, num_freqs,
                  compute_dtype, deg_view=DEG_VIEW) -> List[torch.Tensor]:
    """The plain version of `bwd` on any device: autograd through
    `_mip_body` for the cotangent g [N, 4] (torch-layout grads)."""
    return plain_bwd_T(weights, means.T, covs.T, views.T, g.T, net_depth,
                       num_freqs, compute_dtype, deg_view)


def fwd(weights, means: torch.Tensor, covs: torch.Tensor,
        views: torch.Tensor, net_depth: int, num_freqs: int, compute_dtype,
        deg_view: int = DEG_VIEW) -> torch.Tensor:
    """means/covs/views [N, 3] -> raw heads [N, 4] (kernel #15).
    `weights`: the flat torch-layout list or a packed MipMLP (`pack`). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _fwd(True, weights, means, covs, views, net_depth, num_freqs,
                compute_dtype, deg_view)


def bwd(weights, means: torch.Tensor, covs: torch.Tensor,
        views: torch.Tensor, g: torch.Tensor, net_depth: int,
        num_freqs: int, compute_dtype,
        deg_view: int = DEG_VIEW) -> List[torch.Tensor]:
    """Weight grads of `fwd` for the raw cotangent g [N, 4] (kernel #16):
    the torch-layout list (fp32). CPU tensors take the plain version;
    CUDA tensors launch the kernel (and its dW reduction) or raise."""
    return _bwd(True, weights, means, covs, views, g, net_depth, num_freqs,
                compute_dtype, deg_view)


def fused_mip_mlp_train(weights: Sequence[torch.Tensor], means, covs,
                        views, net_depth: int, num_freqs: int,
                        compute_dtype, deg_view: int = DEG_VIEW,
                        packed: v2.PackedMLP = None) -> torch.Tensor:
    """Differentiable fused MipMLP on row-major streams: means/covs/views
    [N, 3] -> raw heads [N, 4]; forward #15, weight grads from #16 and
    zero input grads. `weights` is the torch-layout parameter list that
    receives the grads; `packed` is optional."""
    return _train_op(True, weights, means, covs, views, net_depth,
                     num_freqs, compute_dtype, deg_view, packed)
