"""The fused NeRF MLP on transposed point streams: forward, weight grads
and the differentiable op built from the two.

`fwd_T` is the port of `consistentnerf_tpu/ops/fused_mlp_v2.py::
_fwd_pallas_T`: points and view directions [3, N] in, raw rgb + density
logits [4, N] out. On a CUDA tensor it launches the hand-written kernel
`csrc/fused_mlp_fwd.cu` (or raises); on a CPU tensor it runs the plain
version `ops/fused_mlp.py::_mlp_body`. The TPU kernel's packed 128-lane
sin/cos register, pi/2 phase bias and 2^-14 raw-x columns are lane-layout
devices of Mosaic and are not carried over: the CUDA kernel computes the
PE directly in torch Embedder order.

`pack` lays the torch-layout weight list out as the kernel reads it; a
caller that renders many chunks packs once and passes the `PackedMLP`.
An fp32 pack (not v1) also carries `w3`, its weights split into three
bf16 planes (`split3`), which the fp32 level walk of #2, #3 and #11 and
of the mip kernels #5, #7 and #16 streams to the tensor cores (six bf16
products a fp32 product).
The packing and the packed walks also serve the MipMLP kernels
(`ops/fused_mip.py`), whose MLP differs only in its encoder and in the
column order of its skip concat: `encoder="ipe"` selects the integrated
positional encoding of (means, covs) and the mip view encoding, and packs
the post-skip layer's [h | pe] columns as [pe | h], the rows the kernels'
shared walk (`csrc/mlp_train.cuh`) reads.
`packed_reference_T` evaluates a `PackedMLP` by walking the packed
buffers the way the kernel does, so the layout is testable without a
card.

`bwd_T` is the port of `_bwd_pallas_T`: the weight grads for an output
cotangent g [4, N], in the torch weight layout. On a CUDA tensor it
launches `csrc/fused_mlp_bwd.cu` (or raises); on a CPU tensor it runs the
plain version `plain_bwd_T` (autograd through `_mlp_body`).
`packed_bwd_reference_T` walks the packed buffers as that kernel does,
with its rounding, and `unpack_grads` maps the packed grads to the torch
layout. `fused_mlp_v2_train_T` is the differentiable op: forward `fwd_T`,
backward `bwd_T`.

The row-major family takes [N, 3] points and views and gives [N, 4]:
`fwd` is the port of `_fwd_pallas` (kernel #10, `fused_mlp_fwd_row` in
`csrc/fused_mlp_fwd.cu`; the TPU kernel's 128-lane output padding is not
carried over) and `bwd` of `_bwd_pallas` (kernel #11,
`fused_mlp_bwd_row` in `csrc/fused_mlp_bwd.cu`): the same walks as #1 and
#2 under the kernels' row-major stream layout, with the plain versions
`plain_fwd_row` / `plain_bwd_row`. `fused_mlp_v2_train` is their
differentiable op, `hybrid_mlp_v2_train` the same op with the plain
forward (the JAX package runs that forward outside any kernel, as XLA
matmuls) and backward #11, and `fused_mlp_v2` the forward from a NeRFMLP.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence

import torch

from consistentnerf_tpu_torch.core import encoding
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops import fused_mlp as fm

KERNEL = "fused_mlp_fwd"
BWD_KERNEL = "fused_mlp_bwd"
ROW_KERNEL = "fused_mlp_fwd_row"  # a kernel of fused_mlp_fwd.cu
ROW_BWD_KERNEL = "fused_mlp_bwd_row"  # a kernel of fused_mlp_bwd.cu
# Kernel launches since import (or since the caller last reset them).
launches = 0
bwd_launches = 0
row_launches = 0
row_bwd_launches = 0


@dataclasses.dataclass
class PackedMLP:
    """One NeRFMLP's (or MipMLP's) weights, as the plain version and as
    the kernel reads them. For a MipMLP, `multires` is its number of IPE
    frequencies and `multires_views` its view-encoding degree."""

    flat: List[torch.Tensor]  # torch-layout list (fused_mlp.flatten_params)
    w: torch.Tensor  # packed weights, compute dtype
    b: torch.Tensor  # packed biases, fp32
    net_depth: int
    width: int
    skips: tuple
    multires: int
    multires_views: int
    compute_dtype: torch.dtype
    encoder: str = "pe"  # 'pe' (NeRFMLP) | 'ipe' (MipMLP)
    # Output width of the view layer: width / 2 in the NeRFMLP, 128 in
    # the MipMLP whatever its width.
    view_width: int = 0
    # Packed for the v1 kernels (#12-#14), which also take heads on
    # [pe | h] (a skip at the last trunk layer) and, with out_ch > 0, the
    # use_viewdirs=False output head of out_ch channels.
    v1: bool = False
    out_ch: int = 0
    # fp32 packs but v1's: `split3(w)`, [3, w.numel()] bf16 (hi, mid,
    # lo); else None.
    w3: Optional[torch.Tensor] = None

    def head_skip(self) -> bool:
        return self.net_depth - 1 in self.skips

    def config(self):
        return (self.net_depth, self.skips, self.multires,
                self.multires_views, self.compute_dtype, self.encoder)


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Pad [r, n] with zero rows to [k, n]."""
    return torch.cat([x, x.new_zeros(k - x.shape[0], x.shape[1])], 0)


def split3(x: torch.Tensor) -> torch.Tensor:
    """fp32 x -> [3, *x.shape] bf16 planes (hi, mid, lo): hi = bf16(x),
    mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest
    even. hi + mid + lo == x exactly for every normal x above ~2^-100
    (below, mid and lo fall among bf16's subnormals and lose bits); the
    products of the terms that the fp32 level walk leaves out (mid lo, lo
    mid, lo lo) are at 2^-24 of a product."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo]).contiguous()


def six_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 as the fp32 level walk (#2, #3, #5, #7, #11, #16)
    computes its backward's products and dW (`csrc/level_train.cuh`; its
    forward runs the fp32 SIMT layer, a plain fp32 product): both operands
    split by `split3`, six products of bf16 terms (each exact in fp32)
    summed in fp32 in the walk's order, a_hi b_lo, a_mid b_mid, a_hi
    b_mid, a_lo b_hi, a_mid b_hi, a_hi b_hi; the three left out are at
    2^-24 of the product. The plain version of the walk's arithmetic (the
    kernel sums over k and the six products in another order)."""
    (ah, am, al), (bh, bm, bl) = split3(a), split3(b)
    out = None
    for x, y in ((ah, bl), (am, bm), (ah, bm), (al, bh), (am, bh),
                 (ah, bh)):
        t = x.float() @ y.float()
        out = t if out is None else out + t
    return out


def enc_widths(encoder: str, multires: int, multires_views: int) -> tuple:
    """(point encoding, view encoding) widths: the torch Embedder's
    3(1 + 2F) for both, or the IPE's 6F (no identity) for the points."""
    ve = 3 * (1 + 2 * multires_views)
    if encoder == "pe":
        return 3 * (1 + 2 * multires), ve
    if encoder == "ipe":
        return 6 * multires, ve
    raise ValueError(f"unknown encoder {encoder!r}")


def _skip_cols(w: torch.Tensor, pe_real: int, encoder: str):
    """A post-skip layer's torch weight [W, K] -> (pe columns, h
    columns): the NeRFMLP concat is [pe, h], the MipMLP's [h, pe]."""
    if encoder == "pe":
        return w[:, :pe_real], w[:, pe_real:]
    return w[:, w.shape[1] - pe_real:], w[:, : w.shape[1] - pe_real]


def pack(weights: Sequence[torch.Tensor], net_depth: int, skips,
         multires: int, multires_views: int, compute_dtype,
         encoder: str = "pe", v1: bool = False,
         use_viewdirs: bool = True) -> PackedMLP:
    """Torch-layout weight list -> the kernel's flat weight/bias buffers.

    Per layer W^T [K_pad, N] with K padded to a multiple of 16 by zero
    rows; a post-skip layer's rows are [pe | h], views_0's rows are
    [feature | ve]; then alpha [W] and rgb [3, Hv] (Hv the view layer's
    width). Layout contract with
    `csrc/fused_mlp_fwd.cu` and the kernels that share its walk. A
    MipMLP's list (`fused_mip.flatten_mip_params`: trunk, density,
    bottleneck, view layer, rgb) has the same order and shapes, with
    `encoder="ipe"`.

    `v1=True` packs for the v1 kernels (`csrc/fused_mlp_v1_*.cu`), which
    also take a skip after the last trunk layer (feature's rows and alpha
    are then [pe | h] as well) and, with `use_viewdirs=False`, the output
    head: output [oc, K_head] after the trunk instead of the view branch
    (the forward #12 only).

    An fp32 pack (either encoder, not v1: the v1 kernel #14 keeps
    train_block in fp32) also holds `w3 = split3(w)`, the planes that the
    fp32 level walk of #2, #3, #11 and of the mip kernels #5, #7, #16
    reads (plane p of element i at p * w.numel() + i)."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if not use_viewdirs and not v1:
        raise ValueError("the v2 kernels need the view-direction MLP")
    n_head = 8 if use_viewdirs else 2
    if len(weights) != 2 * net_depth + n_head:
        raise ValueError(f"the fused MLP takes {2 * net_depth + n_head} "
                         f"tensors here, got {len(weights)}")
    last = net_depth if v1 else net_depth - 1
    if any(s < 0 or s >= last for s in skips):
        hint = "" if v1 else "; the v1 kernels take a skip into the heads"
        raise ValueError(f"skips {skips} must lie in [0, {last}){hint}")
    flat = [w.detach().float() for w in weights]
    width = flat[0].shape[0]
    pe_real, ve_real = enc_widths(encoder, multires, multires_views)
    if width % 32 or flat[0].shape[1] != pe_real:
        raise ValueError(f"width {width} must be a multiple of 32 and the "
                         f"first layer must take {pe_real} PE features")
    p, v = _pad16(pe_real), _pad16(ve_real)
    hs = net_depth - 1 in skips
    ws, bs = [], []
    for i in range(net_depth):
        w, b = flat[2 * i], flat[2 * i + 1]
        if i == 0:
            ws.append(_rows(w.T, p))
        elif i - 1 in skips:
            w_pe, w_h = _skip_cols(w, pe_real, encoder)
            ws += [_rows(w_pe.T, p), w_h.T]
        else:
            ws.append(w.T)
        bs.append(b)

    def head(w):  # a head's torch weight [out, K] -> rows [K_pad, out]
        if w.shape[1] != (pe_real + width if hs else width):
            raise ValueError(f"a head takes {w.shape[1]} features; the "
                             f"trunk gives {pe_real + width if hs else width}")
        if not hs:
            return w.T
        return torch.cat([_rows(w[:, :pe_real].T, p), w[:, pe_real:].T], 0)

    out_ch = view_width = 0
    if not use_viewdirs:
        wo, bo = flat[2 * net_depth:]
        ws.append(head(wo).T)
        bs.append(bo)
        out_ch = wo.shape[0]
    else:
        wa, ba, wf, bf, wv, bv, wr, br = flat[2 * net_depth:]
        if wv.shape[1] != width + ve_real:
            raise ValueError(f"views_0 must take {width} + {ve_real} "
                             "features")
        if wv.shape[0] % 16:
            raise ValueError(f"the view layer's width {wv.shape[0]} must be "
                             "a multiple of 16")
        ws += [head(wf), wv[:, :width].T, _rows(wv[:, width:].T, v),
               head(wa), wr]
        bs += [bf, bv, ba, br]
        view_width = wv.shape[0]
    w = torch.cat([x.reshape(-1) for x in ws])
    return PackedMLP(
        flat=flat, w=w.to(cd).contiguous(),
        b=torch.cat([x.reshape(-1) for x in bs]).contiguous(),
        net_depth=net_depth, width=width, skips=skips, multires=multires,
        multires_views=multires_views, compute_dtype=cd, encoder=encoder,
        view_width=view_width, v1=v1, out_ch=out_ch,
        w3=split3(w) if cd == torch.float32 and not v1 else None,
    )


def encode(packed: PackedMLP, pts_T, views_T, covs_T=None):
    """The kernels' encodings of [3, N] streams, rounded to the compute
    dtype and zero-padded to 16 columns: (pe [N, P], ve [N, V]). For the
    IPE, pts_T holds the Gaussians' means and covs_T their diagonal
    covariances."""
    cd = packed.compute_dtype
    pe_real, ve_real = enc_widths(packed.encoder, packed.multires,
                                  packed.multires_views)
    if packed.encoder == "ipe":
        pe = encoding.integrated_pos_enc(pts_T.T.float(), covs_T.T.float(),
                                         0, packed.multires)
        ve = encoding.pos_enc(views_T.T.float(), 0, packed.multires_views)
    else:
        pe = fm._posenc(pts_T.T.float(), packed.multires)
        ve = fm._posenc(views_T.T.float(), packed.multires_views)
    return (_pad_cols(fm._round(pe, cd), _pad16(pe_real)),
            _pad_cols(fm._round(ve, cd), _pad16(ve_real)))


def packed_reference_T(packed: PackedMLP, pts_T: torch.Tensor,
                       views_T: torch.Tensor, covs_T=None) -> torch.Tensor:
    """Evaluate `packed` by the kernel's walk over its buffers ([4, N])."""
    cd, width, depth = packed.compute_dtype, packed.width, packed.net_depth
    half = packed.view_width
    w, b = packed.w.float(), packed.b
    pos = {"w": 0, "b": 0}

    def take(key, buf, n):
        t = buf[pos[key]: pos[key] + n]
        pos[key] += n
        return t

    pe, ve = encode(packed, pts_T, views_T, covs_T)
    h = None
    for i in range(depth):
        if i == 0:
            x = pe
        elif i - 1 in packed.skips:
            x = torch.cat([pe, h], 1)
        else:
            x = h
        wt = take("w", w, x.shape[1] * width).view(-1, width)
        h = fm._round(torch.relu(x @ wt + take("b", b, width)), cd)
    xh = torch.cat([pe, h], 1) if packed.head_skip() else h
    k = xh.shape[1]
    if packed.out_ch:
        oc = packed.out_ch
        wo = take("w", w, oc * k).view(oc, k)
        return (xh @ wo.T + take("b", b, oc)).T
    wf = take("w", w, k * width).view(k, width)
    wv = take("w", w, (width + ve.shape[1]) * half).view(-1, half)
    wa = take("w", w, k)
    wr = take("w", w, 3 * half).view(3, half)
    bf, bv = take("b", b, width), take("b", b, half)
    ba, br = take("b", b, 1), take("b", b, 3)
    alpha = xh @ wa + ba
    feat = fm._round(xh @ wf + bf, cd)
    hv = fm._round(torch.relu(torch.cat([feat, ve], 1) @ wv + bv), cd)
    rgb = hv @ wr.T + br
    return torch.cat([rgb.T, alpha[None]], 0)


def plain_fwd_T(weights, pts_T, views_T, net_depth, skips, multires,
                multires_views, compute_dtype) -> torch.Tensor:
    """The plain version of `fwd_T` on any device (no kernel)."""
    flat = weights.flat if isinstance(weights, PackedMLP) else weights
    out = fm._mlp_body(
        pts_T.T, views_T.T, flat, net_depth=net_depth, skips=tuple(skips),
        multires=multires, multires_views=multires_views,
        compute_dtype=compute_dtype,
    )
    return out.T.contiguous()


@functools.cache
def _entry(lib: str, symbol: str, n_ptr: int, n_int: int):
    """A C entry point of the kernel library `lib`: n_ptr pointers, n_int
    ints, then a pointer (the stream, or a plan's output); returns a
    cudaError_t."""
    fn = getattr(_build.load(lib), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cfg_ints(packed: PackedMLP):
    """The kernels' config ints after n: depth, width, skip mask,
    multires, multires_views, bf16."""
    return (packed.net_depth, packed.width,
            sum(1 << s for s in packed.skips), packed.multires,
            packed.multires_views,
            int(packed.compute_dtype == torch.bfloat16))


def _fwd(row: bool, weights, pts, views, net_depth, skips, multires,
         multires_views, compute_dtype) -> torch.Tensor:
    """`fwd_T` (transposed streams, kernel #1) or, with `row`, `fwd`
    (row-major streams, kernel #10)."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if pts.device.type == "cpu":
        if isinstance(weights, PackedMLP):
            _packed_for(weights, net_depth, skips, multires, multires_views,
                        cd)
        plain = plain_fwd_row if row else plain_fwd_T
        return plain(weights, pts, views, net_depth, skips, multires,
                     multires_views, cd)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused forward for device {pts.device}")
    packed = _packed_for(weights, net_depth, skips, multires,
                         multires_views, cd)
    out, launched = fwd_launch(KERNEL, ROW_KERNEL if row else KERNEL,
                               packed, pts, views, row)
    global launches, row_launches
    if launched and row:
        row_launches += 1
    elif launched:
        launches += 1
    return out


def fwd_launch(lib: str, symbol: str, packed: PackedMLP, pts, views,
               row: bool, extra=()):
    """Launch the forward kernel `symbol` of library `lib` on CUDA
    streams of either layout, with `extra` ints after the config's: (raw
    [N, C] or [C, N], C = 4 or the output head's channels; whether a
    kernel was launched: not for N = 0)."""
    n, dev = pts.shape[0 if row else 1], pts.device
    for name, t in (("pts", pts), ("views", views)):
        _check_stream(name, t, 3, n, dev, row)
    _check_weights(packed, dev)
    check_tma_weights(packed)  # the walks' TMA / bulk-copy alignment
    c = packed.out_ch or 4
    out = torch.empty((n, c) if row else (c, n), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out, False
    err = _entry(lib, symbol, 5, 7 + len(extra))(
        pts.data_ptr(), views.data_ptr(), packed.w.data_ptr(),
        packed.b.data_ptr(), out.data_ptr(), n, *_cfg_ints(packed), *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    return out, True


def fwd_T(weights, pts_T: torch.Tensor, views_T: torch.Tensor,
          net_depth: int, skips, multires: int, multires_views: int,
          compute_dtype) -> torch.Tensor:
    """pts/views [3, N] -> raw [4, N] (rgb logits rows 0..2, density 3).

    `weights`: the flat torch-layout list or a `PackedMLP`. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    return _fwd(False, weights, pts_T, views_T, net_depth, skips, multires,
                multires_views, compute_dtype)


# ---------------------------------------------------------------------------
# Weight grads (kernel #2) and the differentiable op
# ---------------------------------------------------------------------------


def _block_shapes(packed: PackedMLP):
    """(name, rows, cols) of the packed weight blocks and (name, size) of
    the packed biases, in buffer order."""
    width, half = packed.width, packed.view_width
    p, v = (_pad16(x) for x in enc_widths(packed.encoder, packed.multires,
                                          packed.multires_views))
    ws, bs = [], []
    for i in range(packed.net_depth):
        rows = p if i == 0 else (p + width if i - 1 in packed.skips
                                 else width)
        ws.append((f"pts_{i}", rows, width))
        bs.append((f"pts_{i}", width))
    k = p + width if packed.head_skip() else width  # the heads' rows
    if packed.out_ch:
        return (ws + [("output", packed.out_ch, k)],
                bs + [("output", packed.out_ch)])
    ws += [("feature", k, width), ("views_0", width + v, half),
           ("alpha", k, 1), ("rgb", 3, half)]
    bs += [("feature", width), ("views_0", half), ("alpha", 1), ("rgb", 3)]
    return ws, bs


def _split(flat: torch.Tensor, shapes) -> dict:
    out, o = {}, 0
    for name, *dims in shapes:
        n = 1
        for x in dims:
            n *= x
        out[name] = flat[o: o + n].view(*dims)
        o += n
    return out


def grad_numel(packed: PackedMLP) -> tuple:
    """(weights, biases) element counts of the packed grads."""
    ws, bs = _block_shapes(packed)
    return sum(r * c for _, r, c in ws), sum(n for _, n in bs)


def unpack_grads(packed: PackedMLP, dw: torch.Tensor,
                 db: torch.Tensor) -> List[torch.Tensor]:
    """Packed fp32 dW / db -> the torch-layout grad list (the order of
    `fused_mlp.flatten_params`): padding rows dropped, [pe | h] and
    [feature | ve] rows rejoined, W^T blocks transposed back."""
    wshapes, bshapes = _block_shapes(packed)
    w, b = _split(dw, wshapes), _split(db, bshapes)
    width = packed.width
    pe_real, ve_real = enc_widths(packed.encoder, packed.multires,
                                  packed.multires_views)
    p = _pad16(pe_real)
    out = []
    for i in range(packed.net_depth):
        blk = w[f"pts_{i}"]
        if i == 0:
            g = blk[:pe_real]
        elif i - 1 in packed.skips:
            rows = [blk[:pe_real], blk[p:]]
            g = torch.cat(rows if packed.encoder == "pe" else rows[::-1], 0)
        else:
            g = blk
        out += [g.T.contiguous(), b[f"pts_{i}"].clone()]
    views = w["views_0"]

    def head(blk):  # the heads' rows [K_pad, out] -> [K, out]
        if not packed.head_skip():
            return blk
        return torch.cat([blk[:pe_real], blk[p:]], 0)

    out += [head(w["alpha"]).reshape(1, -1).clone(), b["alpha"].clone(),
            head(w["feature"]).T.contiguous(), b["feature"].clone(),
            torch.cat([views[:width], views[width: width + ve_real]],
                      0).T.contiguous(), b["views_0"].clone(),
            w["rgb"].clone(), b["rgb"].clone()]
    return out


def _packed_weights(packed: PackedMLP):
    wshapes, bshapes = _block_shapes(packed)
    return (_split(packed.w.float(), wshapes),
            _split(packed.b.float(), bshapes))


def _pad_cols(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(x.shape[0], k - x.shape[1])], 1)


def packed_forward_saved(packed: PackedMLP, pts_T, views_T, covs_T=None):
    """The train kernels' forward walk over the packed buffers: raw
    [4, N] and the saved activations (rounded as the kernel saves them)."""
    cd, depth = packed.compute_dtype, packed.net_depth
    w, b = _packed_weights(packed)
    pe, ve = encode(packed, pts_T, views_T, covs_T)
    acts, h = [], None
    for i in range(depth):
        if i == 0:
            x = pe
        elif i - 1 in packed.skips:
            x = torch.cat([pe, h], 1)
        else:
            x = h
        h = fm._round(torch.relu(x @ w[f"pts_{i}"] + b[f"pts_{i}"]), cd)
        acts.append(h)
    xh = torch.cat([pe, h], 1) if packed.head_skip() else h
    feat = fm._round(xh @ w["feature"] + b["feature"], cd)
    hv = fm._round(torch.relu(torch.cat([feat, ve], 1) @ w["views_0"]
                              + b["views_0"]), cd)
    alpha = xh @ w["alpha"][:, 0] + b["alpha"]
    rgb = hv @ w["rgb"].T + b["rgb"]
    raw = torch.cat([rgb.T, alpha[None]], 0)
    return raw, dict(pe=pe, ve=ve, acts=acts, feat=feat, hv=hv)


def packed_backward(packed: PackedMLP, saved, g_T,
                    mm=torch.matmul) -> tuple:
    """The train kernels' backward walk: packed fp32 (dW, db) for the raw
    cotangent g_T [4, N], rounded where the kernel rounds (bf16 operands
    of every product, fp32 bias sums, ReLU masks from saved values). `mm`
    takes the products that the kernels run on the tensor cores (every
    dW but the heads', the input grads through the layers):
    `six_products` for the fp32 level walk."""
    cd, depth = packed.compute_dtype, packed.net_depth
    w, _ = _packed_weights(packed)

    def rnd(x):
        return fm._round(x, cd)

    pe, ve, acts = saved["pe"], saved["ve"], saved["acts"]
    feat, hv, h_last = saved["feat"], saved["hv"], saved["acts"][-1]
    # The heads' input, and where its h rows start in their weights.
    hoff = pe.shape[1] if packed.head_skip() else 0
    x_head = torch.cat([pe, h_last], 1) if hoff else h_last
    g_rgb, g_a = g_T[:3].T.float(), g_T[3].float()
    gr_r, ga_r = rnd(g_rgb), rnd(g_a)
    dw, db = {}, {}
    dw["rgb"], db["rgb"] = gr_r.T @ hv, g_rgb.sum(0)
    dw["alpha"], db["alpha"] = (x_head.T @ ga_r)[:, None], g_a.sum()[None]
    g_hv = (gr_r @ w["rgb"]) * (hv > 0)
    g_hv_r = rnd(g_hv)
    dw["views_0"] = mm(torch.cat([feat, ve], 1).T, g_hv_r)
    db["views_0"] = g_hv.sum(0)
    g_feat = mm(g_hv_r, w["views_0"][: packed.width].T)
    g_feat_r = rnd(g_feat)
    dw["feature"], db["feature"] = mm(x_head.T, g_feat_r), g_feat.sum(0)
    g_h = (mm(g_feat_r, w["feature"][hoff:].T)
           + ga_r[:, None] * w["alpha"][hoff:, 0])
    p = pe.shape[1]
    for i in reversed(range(depth)):
        g_pre = g_h * (acts[i] > 0)
        g_pre_r = rnd(g_pre)
        skip = i > 0 and i - 1 in packed.skips
        if i == 0:
            x = pe
        elif skip:
            x = torch.cat([pe, acts[i - 1]], 1)
        else:
            x = acts[i - 1]
        dw[f"pts_{i}"], db[f"pts_{i}"] = mm(x.T, g_pre_r), g_pre.sum(0)
        if i > 0:
            wh = w[f"pts_{i}"][p:] if skip else w[f"pts_{i}"]
            g_h = mm(g_pre_r, wh.T)
    wshapes, bshapes = _block_shapes(packed)
    return (torch.cat([dw[n].reshape(-1) for n, *_ in wshapes]),
            torch.cat([db[n].reshape(-1) for n, _ in bshapes]))


def packed_bwd_reference_T(packed: PackedMLP, pts_T, views_T,
                           g_T, covs_T=None,
                           mm=torch.matmul) -> List[torch.Tensor]:
    """`bwd_T` by the kernel's walk over its packed buffers, unpacked to
    the torch layout (`mm`: see `packed_backward`)."""
    _, saved = packed_forward_saved(packed, pts_T, views_T, covs_T)
    return unpack_grads(packed, *packed_backward(packed, saved, g_T, mm))


def plain_bwd_T(weights, pts_T, views_T, g_T, net_depth, skips, multires,
                multires_views, compute_dtype) -> List[torch.Tensor]:
    """The plain version of `bwd_T` on any device: autograd through
    `_mlp_body` (torch-layout grads)."""
    flat = weights.flat if isinstance(weights, PackedMLP) else weights
    ws = [w.detach().float().requires_grad_() for w in flat]
    with torch.enable_grad():
        out = fm._mlp_body(
            pts_T.T, views_T.T, ws, net_depth=net_depth, skips=tuple(skips),
            multires=multires, multires_views=multires_views,
            compute_dtype=compute_dtype)
        grads = torch.autograd.grad(out, ws, g_T.T.float())
    return list(grads)


def _check_stream(name, t, rows, n, device, row=False):
    """A [rows, n] stream, or with `row` an [n, rows] one."""
    shape = (n, rows) if row else (rows, n)
    if (t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name} must be a contiguous fp32 "
                         f"{list(shape)} tensor on {device}")


def _check_weights(packed: PackedMLP, device):
    for t in (packed.w, packed.b):
        if t.device != device:
            raise ValueError("packed weights are not on the points' device")


def check_tma_weights(packed: PackedMLP):
    """The bf16 forwards #1, #6, #10, #12 / #13 and #15
    (`csrc/fwd_hopper.cuh`)
    and the level walk of the weight grads (`csrc/level_train.cuh`) read
    the packed weights by TMA: the buffer's base and the row strides of its
    two weight maps (2 width and 2 view_width bytes) must be multiples of
    16 bytes. The fp32 level walk reads the planes `w3` so: their base,
    the planes' stride (2 w.numel() bytes) and the same row strides. The
    fp32 forward walk (`csrc/fwd_f32.cuh`) reads the fp32 `w` by bulk
    copies of whole slabs: its base must be 16-byte aligned."""
    if packed.compute_dtype == torch.bfloat16:
        base, stride = packed.w, 0
    elif packed.w.data_ptr() % 16:
        raise ValueError("the packed fp32 weights must be 16-byte aligned "
                         "(the fp32 forward walk's bulk copies)")
    elif packed.w3 is not None:
        base, stride = packed.w3, 2 * packed.w.numel()
        if (packed.w3.dtype != torch.bfloat16
                or packed.w3.shape != (3, packed.w.numel())
                or not packed.w3.is_contiguous()
                or packed.w3.device != packed.w.device):
            raise ValueError("w3 must be the contiguous [3, w.numel()] bf16 "
                             "planes of w on its device (split3)")
    else:
        return
    if (base.data_ptr() % 16 or stride % 16 or (2 * packed.width) % 16
            or (2 * packed.view_width) % 16):
        raise ValueError("the packed bf16 weights must be 16-byte aligned, "
                         "with row strides of a multiple of 16 bytes (TMA)")


def check_planes(packed: PackedMLP):
    """An fp32 pack for #2, #3, #5, #7, #11 or #16 carries the planes
    `w3` that their level walk reads (`pack` makes them)."""
    if packed.compute_dtype == torch.float32 and packed.w3 is None:
        raise ValueError("the fp32 level walk reads the weights' bf16 "
                         "planes w3: pack them with fused_mlp_v2.pack")


PLAN_SLOTS = ("hopper", "tile", "stages", "cluster", "smem_bytes",
              "blocks", "pe_buffers", "tiles")
# Slot "hopper" of a forward plan: the walk that runs.
WALK_TILE, WALK_BF16, WALK_F32 = 0, 1, 2
WALK_NAMES = {WALK_TILE: "mlp_fwd.cuh's walk (fwd_tile)",
              WALK_BF16: "the bf16 Hopper walk (fwd_hopper.cuh)",
              WALK_F32: "the fp32 walk (fwd_f32.cuh)"}


def plan_dict(fn, args) -> dict:
    """A forward plan function's eight slots (`PLAN_SLOTS`): the walk
    that runs (`WALK_NAMES`: 0 `mlp_fwd.cuh`'s walk, 1 the bf16 Hopper
    walk, 2 the fp32 walk), points a tile, ring slots, cluster size,
    shared memory, blocks, pe buffers, tiles."""
    out = (ctypes.c_longlong * len(PLAN_SLOTS))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"forward plan failed: cudaError_t {err}")
    return dict(zip(PLAN_SLOTS, list(out)))


def fwd_plan(packed: PackedMLP, n: int, row: bool = False) -> dict:
    """The walk that kernel #1 (or, with `row`, #10: the same plan) runs
    for n points of `packed`, decided by shapes alone
    (`fused_mlp_fwd_plan`; `plan_dict`: in bf16 the Hopper walk, in fp32
    the fp32 walk, at widths 64-256); needs the card."""
    return plan_dict(_entry(KERNEL, "fused_mlp_fwd_plan", 0, 8),
                     (n, *_cfg_ints(packed), int(row)))


def level_buffers(plan_fn, args, packed: PackedMLP, device):
    """Workspace, per-block partials, dW-GEMM split partials and the
    packed-grad output of one launch of a kernel on `level_train.cuh`'s
    nine-slot plan (#2, #3, #5, #7, #11, #14, #16), sized by the kernel's
    own plan (blocks, workspace elements, partial floats per block, shared
    memory, points per chunk, splits, split partial floats, slabs per
    split, 1 for the level walk). The level walk's workspace holds a bf16
    row of every point of the launch (~9.9 KB a point at 8x256; in fp32
    three planes of them, ~29.7 KB); train_block's is of the compute
    type."""
    out = (ctypes.c_longlong * 9)()
    err = plan_fn(*args, out)
    if err != 0:
        raise RuntimeError(f"train kernel plan failed: cudaError_t {err}")
    n_w, n_b = grad_numel(packed)
    ws = torch.empty(out[1], device=device, dtype=(
        torch.bfloat16 if out[8] else packed.compute_dtype))
    part = torch.empty(out[0] * out[2], dtype=torch.float32, device=device)
    gpart = torch.empty(max(out[6], 1), dtype=torch.float32, device=device)
    dw = torch.empty(n_w + n_b, dtype=torch.float32, device=device)
    return ws, part, gpart, dw


def _packed_for(weights, net_depth, skips, multires, multires_views, cd,
                encoder="pe", v1=False):
    if isinstance(weights, PackedMLP):
        if (weights.config() != (net_depth, skips, multires, multires_views,
                                 cd, encoder) or weights.v1 != v1):
            raise ValueError("PackedMLP was packed for another config")
        return weights
    return pack(weights, net_depth, skips, multires, multires_views, cd,
                encoder, v1=v1)


def _bwd(row: bool, weights, pts, views, g, net_depth, skips, multires,
         multires_views, compute_dtype) -> List[torch.Tensor]:
    """`bwd_T` (transposed streams, kernel #2) or, with `row`, `bwd`
    (row-major streams, kernel #11)."""
    cd = fm.as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if pts.device.type == "cpu":
        if isinstance(weights, PackedMLP):
            _packed_for(weights, net_depth, skips, multires, multires_views,
                        cd)
        plain = plain_bwd_row if row else plain_bwd_T
        return plain(weights, pts, views, g, net_depth, skips, multires,
                     multires_views, cd)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused backward for device {pts.device}")
    packed = _packed_for(weights, net_depth, skips, multires,
                         multires_views, cd)
    symbol = ROW_BWD_KERNEL if row else BWD_KERNEL
    grads, launched = dw_launch(BWD_KERNEL, symbol, packed, pts, views, g,
                                row)
    global bwd_launches, row_bwd_launches
    if launched and row:
        row_bwd_launches += 1
    elif launched:
        bwd_launches += 1
    return grads


def dw_launch(lib: str, symbol: str, packed: PackedMLP, pts, views, g,
              row: bool):
    """Launch the weight-grad kernel `symbol` of library `lib` (#2, #11
    or #14) on CUDA points and view directions of either layout: (the
    torch-layout grads, whether a kernel was launched: not for N = 0)."""
    n, dev = pts.shape[0 if row else 1], pts.device
    for name, t, rows in (("pts", pts, 3), ("views", views, 3),
                          ("g", g, 4)):
        _check_stream(name, t, rows, n, dev, row)
    _check_weights(packed, dev)
    return grad_launch(lib, symbol, packed, (pts, views), g,
                       _cfg_ints(packed), row)


# The weight-grad entry points that take the fp32 planes `w3` after `w`
# (their fp32 path runs the level walk): #2, #11 and the mip kernels #7
# (`fused_mip.BWD_KERNEL`) and #16 (`fused_mip.ROW_BWD_KERNEL`).
PLANE_ENTRIES = (BWD_KERNEL, ROW_BWD_KERNEL, "fused_mip_bwd",
                 "fused_mip_bwd_row")


def grad_launch(lib: str, symbol: str, packed: PackedMLP, streams, g,
                cfg_args, row: bool):
    """Launch a weight-grad kernel on checked CUDA streams and cotangent g
    ([4, N], or [N, 4] with `row`), its buffers sized by its
    `{symbol}_plan`: (the torch-layout grads, whether a kernel was
    launched: not for N = 0). Every one of them (#2, #7, #11, #14, #16)
    fills the nine slots of `csrc/level_train.cuh::level_plan`, takes
    `gpart`, and in bf16 reads the weights by TMA. The PLANE_ENTRIES (#2,
    #11, #7, #16) also take the weights' fp32 split `w3` after `w` (a null
    pointer in bf16), which their fp32 level walk reads by TMA."""
    planes = symbol in PLANE_ENTRIES
    n, dev = g.shape[0 if row else 1], g.device
    n_w, n_b = grad_numel(packed)
    if n == 0:
        zeros = torch.zeros(n_w + n_b, device=dev)
        return unpack_grads(packed, zeros[:n_w], zeros[n_w:]), False
    # The plan's buffers (ws, part, gpart, dw), in the C entry points'
    # order.
    if planes:
        check_planes(packed)
    check_tma_weights(packed)
    bufs = level_buffers(_entry(lib, symbol + "_plan", 0, 1 + len(cfg_args)),
                         (n, *cfg_args), packed, dev)
    w3 = [packed.w3.data_ptr() if packed.w3 is not None else None] \
        if planes else []
    ptrs = [t.data_ptr() for t in streams] + [
        g.data_ptr(), packed.w.data_ptr()] + w3 + [packed.b.data_ptr()] + [
        t.data_ptr() for t in bufs]
    err = _entry(lib, symbol, len(ptrs), 1 + len(cfg_args))(
        *ptrs, n, *cfg_args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
    dw = bufs[-1]
    return unpack_grads(packed, dw[:n_w], dw[n_w:]), True


def bwd_T(weights, pts_T: torch.Tensor, views_T: torch.Tensor,
          g_T: torch.Tensor, net_depth: int, skips, multires: int,
          multires_views: int, compute_dtype) -> List[torch.Tensor]:
    """Weight grads of `fwd_T` for the raw cotangent g_T [4, N]: the
    torch-layout list (fp32). CPU tensors take the plain version; CUDA
    tensors launch the kernel (and its dW reduction) or raise."""
    return _bwd(False, weights, pts_T, views_T, g_T, net_depth, skips,
                multires, multires_views, compute_dtype)


class _FusedMLPTrain(torch.autograd.Function):
    """raw = MLP(pts, views); grads for the weights only (positions carry
    no grad in the NeRF step, run_nerf_view.py:527). `mode`: "T" on
    transposed streams (#1, #2), "row" on row-major ones (#10, #11),
    "hybrid" row-major with the plain forward and #11."""

    @staticmethod
    def forward(ctx, config, packed, mode, pts, views, *weights):
        src = packed if packed is not None else list(weights)
        ctx.config, ctx.src, ctx.mode = config, src, mode
        ctx.save_for_backward(pts, views)
        run = {"T": fwd_T, "row": fwd, "hybrid": plain_fwd_row}[mode]
        return run(src, pts, views, *config)

    @staticmethod
    def backward(ctx, g):
        pts, views = ctx.saved_tensors
        run = bwd_T if ctx.mode == "T" else bwd
        grads = run(ctx.src, pts, views, g.contiguous(), *ctx.config)
        return (None, None, None, None, None, *grads)


def _train_op(mode, weights, pts, views, net_depth, skips, multires,
              multires_views, compute_dtype, packed):
    config = (net_depth, tuple(sorted(skips)), multires, multires_views,
              fm.as_dtype(compute_dtype))
    return _FusedMLPTrain.apply(config, packed, mode, pts, views, *weights)


def fused_mlp_v2_train_T(weights: Sequence[torch.Tensor], pts_T, views_T,
                         net_depth: int, skips, multires: int,
                         multires_views: int, compute_dtype,
                         packed: PackedMLP = None) -> torch.Tensor:
    """Differentiable fused MLP on transposed streams: pts/views [3, N] ->
    raw [4, N]; the weight grads come from `bwd_T`. `weights` is the
    torch-layout parameter list that receives the grads; `packed` (the
    same weights packed, for a CUDA caller that already packed them) is
    optional."""
    return _train_op("T", weights, pts_T, views_T, net_depth, skips,
                     multires, multires_views, compute_dtype, packed)


# ---------------------------------------------------------------------------
# The row-major family (kernels #10 and #11) and its differentiable ops
# ---------------------------------------------------------------------------


def plain_fwd_row(weights, pts, views, net_depth, skips, multires,
                  multires_views, compute_dtype) -> torch.Tensor:
    """The plain version of `fwd` on any device: pts/views [N, 3] -> raw
    [N, 4] (no kernel)."""
    flat = weights.flat if isinstance(weights, PackedMLP) else weights
    return fm._mlp_body(
        pts, views, flat, net_depth=net_depth, skips=tuple(skips),
        multires=multires, multires_views=multires_views,
        compute_dtype=compute_dtype)


def plain_bwd_row(weights, pts, views, g, net_depth, skips, multires,
                  multires_views, compute_dtype) -> List[torch.Tensor]:
    """The plain version of `bwd` on any device: autograd through
    `_mlp_body` for the cotangent g [N, 4] (torch-layout grads)."""
    return plain_bwd_T(weights, pts.T, views.T, g.T, net_depth, skips,
                       multires, multires_views, compute_dtype)


def fwd(weights, pts: torch.Tensor, views: torch.Tensor, net_depth: int,
        skips, multires: int, multires_views: int,
        compute_dtype) -> torch.Tensor:
    """pts/views [N, 3] -> raw [N, 4] (rgb logits 0..2, density 3), kernel
    #10. `weights`: the flat torch-layout list or a `PackedMLP`. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return _fwd(True, weights, pts, views, net_depth, skips, multires,
                multires_views, compute_dtype)


def bwd(weights, pts: torch.Tensor, views: torch.Tensor, g: torch.Tensor,
        net_depth: int, skips, multires: int, multires_views: int,
        compute_dtype) -> List[torch.Tensor]:
    """Weight grads of `fwd` for the raw cotangent g [N, 4] (kernel #11):
    the torch-layout list (fp32). CPU tensors take the plain version;
    CUDA tensors launch the kernel (and its dW reduction) or raise."""
    return _bwd(True, weights, pts, views, g, net_depth, skips, multires,
                multires_views, compute_dtype)


def fused_mlp_v2_train(weights: Sequence[torch.Tensor], pts, views,
                       net_depth: int, skips, multires: int,
                       multires_views: int, compute_dtype,
                       packed: PackedMLP = None) -> torch.Tensor:
    """Differentiable fused MLP on row-major streams: pts/views [N, 3] ->
    raw [N, 4]; forward #10, weight grads from #11. `weights` is the
    torch-layout parameter list that receives the grads; `packed` (the
    same weights packed, for a CUDA caller that already packed them) is
    optional."""
    return _train_op("row", weights, pts, views, net_depth, skips,
                     multires, multires_views, compute_dtype, packed)


def hybrid_mlp_v2_train(weights: Sequence[torch.Tensor], pts, views,
                        net_depth: int, skips, multires: int,
                        multires_views: int, compute_dtype,
                        packed: PackedMLP = None) -> torch.Tensor:
    """`fused_mlp_v2_train` with the plain forward (`_mlp_body`, no
    kernel, as the JAX package's XLA forward) and backward #11."""
    return _train_op("hybrid", weights, pts, views, net_depth, skips,
                     multires, multires_views, compute_dtype, packed)


def fused_mlp_v2(mlp, pts, viewdirs, *, net_depth=8, skips=(4,),
                 multires=10, multires_views=4,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """The forward (#10) from a NeRFMLP or its state_dict: [N, 3] points
    and view directions -> raw [N, 4]."""
    weights = fm.flatten_params(mlp, True, net_depth)
    return fwd([w.detach() for w in weights], pts, viewdirs, net_depth,
               skips, multires, multires_views, compute_dtype)
