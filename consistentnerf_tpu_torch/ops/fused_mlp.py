"""The NeRF MLP's flat weight list, its plain PyTorch forward, and the v1
fused forward (kernel #12).

`_mlp_body` is the plain version of the fused forward kernels
(`ops/fused_mlp_v2.py`, `csrc/fused_mlp_fwd.cu`, and the v1 kernels
`csrc/fused_mlp_v1_fwd.cu` / `fused_mlp_v1_bwd.cu`): the CPU path of the
kernel wrappers and the yardstick the kernels are held against on the
card. It computes the torch-Embedder PE and the 8x256 trunk, skip and view
branch with the kernel's rounding points. At `compute_dtype=bfloat16`
every product takes bf16-rounded operands and accumulates in fp32 (the
operands are rounded to bf16 and multiplied in fp32, which is exact), the
biases stay fp32, trunk activations are rounded to bf16 after the ReLU,
`feature` is rounded without one, and alpha and rgb stay fp32. A skip
after the last trunk layer makes the heads read [pe | h]; with
`use_viewdirs=False` the output head gives [N, output_ch].

`fused_mlp` is the port of `consistentnerf_tpu/ops/fused_mlp.py::
fused_mlp` (kernel #12, the v1 render forward): [N, 3] points and view
directions in, [N, 4] (or [N, output_ch]) out. On a CUDA tensor it
launches `fused_mlp_v1_fwd` (or raises); on a CPU tensor it runs
`_mlp_body`. The TPU kernel's `tile` and `interpret` arguments are Pallas
devices and are dropped. `v1_forward` is the launch that #12 and the v1
train forward (#13, `ops/fused_mlp_train.py`) share, `fwd_plan` the walk
it takes by shapes; `pack_v1` packs the weights as the v1 kernels read
them.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

KERNEL = "fused_mlp_v1_fwd"  # csrc/fused_mlp_v1_fwd.cu: #12 and #13
# The `fused_kernel` values that run the v1 kernels: "v1" (#13 and #14 in
# the two-call step) and "hybrid" (the plain forward and #14); the fused
# render runs #12 for both.
V1_KINDS = ("v1", "hybrid")
# Launches of #12 since import (or since the caller last reset it).
launches = 0
# Dynamic shared memory an H100 block can take (232,448 bytes).
SMEM_LIMIT = 227 * 1024


def as_dtype(dtype) -> torch.dtype:
    """'float32' / 'bfloat16' / a torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def strict_fp32(device: torch.device) -> None:
    """fp32 products on the card in full fp32: TF32 keeps ~3 digits."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _posenc(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Torch-Embedder-ordered PE [x, sin(2^k x), cos(2^k x), ...]."""
    if num_freqs == 0:
        return x
    feats = [x]
    for i in range(num_freqs):
        xb = x * (2.0**i)
        feats += [torch.sin(xb), torch.cos(xb)]
    return torch.cat(feats, -1)


def flatten_params(mlp: Union[nn.Module, Mapping[str, torch.Tensor]],
                   use_viewdirs: bool = True,
                   net_depth: int = 8) -> List[torch.Tensor]:
    """A NeRFMLP (or its state_dict) -> the flat torch-layout weight list.

    Order: [pts_0_w, pts_0_b, ..., pts_{D-1}_w, pts_{D-1}_b,
            alpha_w, alpha_b, feature_w, feature_b,
            views_0_w, views_0_b, rgb_w, rgb_b]
    Weights are torch `nn.Linear` layout [out, in]; a module's are its
    parameters (gradients flow), a state_dict's its tensors.
    """
    sd = dict(mlp.named_parameters()) if isinstance(mlp, nn.Module) else mlp
    names = [f"pts_linears.{i}" for i in range(net_depth)]
    if use_viewdirs:
        names += ["alpha_linear", "feature_linear", "views_linears.0",
                  "rgb_linear"]
    else:
        names += ["output_linear"]
    out = []
    for name in names:
        out += [sd[f"{name}.weight"], sd[f"{name}.bias"]]
    return out


def _round(x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, keep computing in fp32."""
    return x if cd == torch.float32 else x.to(cd).float()


def _mlp_body(pts, views, weights: Sequence[torch.Tensor], *, net_depth,
              skips, multires, multires_views, use_viewdirs=True,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Plain forward on [N, 3] points (+ views). Returns [N, 4] fp32."""
    views_embed = None
    if use_viewdirs:
        views_embed = _posenc(views.float(), multires_views)
    return _mlp_encoded(
        _posenc(pts.float(), multires), views_embed, weights,
        net_depth=net_depth, skips=skips, use_viewdirs=use_viewdirs,
        compute_dtype=compute_dtype,
    )


def _mlp_encoded(pts_embed, views_embed, weights: Sequence[torch.Tensor],
                 *, net_depth, skips, use_viewdirs=True,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """The MLP on encoded [N, C] inputs (fp32 encodings, rounded here)."""
    cd = as_dtype(compute_dtype)
    strict_fp32(pts_embed.device)
    w = [_round(x.float(), cd) if i % 2 == 0 else x.float()
         for i, x in enumerate(weights)]
    pts_embed = _round(pts_embed.float(), cd)
    h = pts_embed
    for i in range(net_depth):
        h = _round(torch.relu(F.linear(h, w[2 * i], w[2 * i + 1])), cd)
        if i in skips:
            h = torch.cat([pts_embed, h], -1)
    wi = 2 * net_depth
    if not use_viewdirs:
        return F.linear(h, w[wi], w[wi + 1])
    views_embed = _round(views_embed.float(), cd)
    alpha = F.linear(h, w[wi], w[wi + 1])
    feature = _round(F.linear(h, w[wi + 2], w[wi + 3]), cd)
    hv = torch.cat([feature, views_embed], -1)
    hv = _round(torch.relu(F.linear(hv, w[wi + 4], w[wi + 5])), cd)
    rgb = F.linear(hv, w[wi + 6], w[wi + 7])
    return torch.cat([rgb, alpha], -1)


def cast_weight_list(weights: Sequence[torch.Tensor],
                     compute_dtype) -> List[torch.Tensor]:
    """Cast the kernels (even slots) of a flat weight list to the compute
    dtype; the biases (odd slots) stay fp32, as they add into the fp32
    accumulator."""
    cd = as_dtype(compute_dtype)
    return [w.to(cd) if i % 2 == 0 else w.float()
            for i, w in enumerate(weights)]


def reference_mlp_apply(mlp, pts, viewdirs, *, net_depth=8, skips=(4,),
                        multires=10, multires_views=4, use_viewdirs=True,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The plain forward from a NeRFMLP (or its state_dict)."""
    weights = cast_weight_list(flatten_params(mlp, use_viewdirs, net_depth),
                               compute_dtype)
    return _mlp_body(
        pts, viewdirs, weights, net_depth=net_depth, skips=tuple(skips),
        multires=multires, multires_views=multires_views,
        use_viewdirs=use_viewdirs, compute_dtype=compute_dtype,
    )


# ---------------------------------------------------------------------------
# The v1 kernels' packing and forward launch (#12, #13)
# ---------------------------------------------------------------------------


# The constants of the v1 kernels' shared-memory plan under their names in
# csrc/mlp_common.cuh and csrc/mlp_train.cuh (chip_smoke.py holds
# `v1_smem_bytes` against the plan of the built kernels).
K_PAD = 8  # kPad: row padding, in elements
K_WARPS = 8  # kWarps
K_CHUNK = 768  # kChunk: points of a train chunk
K_DW_STAGE_BYTES = 64 * (256 + 8 + 64 + 8) * 2  # kDwStageBytes (bf16)


def v1_smem_bytes(packed) -> tuple:
    """(forward, train) dynamic shared memory of one v1 block, in bytes:
    the plans of `csrc/mlp_fwd.cuh::fwd_smem_bytes` (tiles of 128 points
    in bf16, 64 in fp32) and `csrc/mlp_train.cuh::smem_bytes` (sub-tiles
    of 64 / 32 points, K_CHUNK-point chunks; in bf16 at least the dW
    pass's staging buffer)."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    bf16 = packed.compute_dtype == torch.bfloat16
    elem = 2 if bf16 else 4
    p, v = (v2._pad16(x) for x in v2.enc_widths(
        "pe", packed.multires, packed.multires_views))
    act = max(packed.width, packed.view_width)

    def tiles(m):
        return m * (p + K_PAD) + m * (v + K_PAD) + 2 * m * (act + K_PAD)

    fwd = tiles(128 if bf16 else 64) * elem + K_WARPS * 256 * 4
    m = 64 if bf16 else 32
    train = tiles(m) * elem + 4 * (m * (packed.width + 4) + K_WARPS * 256
                                   + 4 * m + 5 * K_CHUNK)
    return fwd, max(train, K_DW_STAGE_BYTES if bf16 else 0)


# The level walk's weight ring under its names in csrc/level_train.cuh:
# kWStages slots of kWStage bytes (four 64 x 64 bf16 boxes), 1024-byte
# aligned; and its static shared memory (the ring's 2 x 3 mbarriers and
# the 64-entry product table of 5 ints), which the plan counts beside the
# dynamic bytes against the 232,448 a block may hold.
K_WSTAGES = 3
K_WSTAGE = 4 * 64 * 64 * 2
K_WALK_STATIC = 2 * K_WSTAGES * 8 + 64 * 5 * 4


def walk_smem_bytes(packed, rows: int, row: bool = True) -> int:
    """Dynamic shared memory of one block of the level walk,
    `csrc/level_train.cuh::level_smem`, for chunks of `rows` rows (a
    multiple of 64): the weight ring, the 64-point tiles, the per-chunk
    rows, the column-sum partials and, with `row` (#11, #14 and with the
    IPE #16, on row-major streams), the tile's staged points (9 x 64
    floats). bf16 tiles, two of activations; an fp32 pack's walk (#2, #3,
    #11, and with the IPE #5, #7, #16) keeps fp32 tiles and one
    activation tile, and with the IPE its pe tile in the weight ring
    beside the forward's second activation tile where the two fit there
    (`level_train.cuh::pe_in_ring`). The plan takes the walk where this
    and K_WALK_STATIC fit SMEM_LIMIT at 768-row chunks."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    p, v = (v2._pad16(x) for x in v2.enc_widths(
        packed.encoder, packed.multires, packed.multires_views))
    act, m = max(packed.width, packed.view_width), 64
    fp32 = packed.compute_dtype == torch.float32
    pe_in_ring = (fp32 and packed.encoder == "ipe"
                  and m * (act + p + 2 * K_PAD) * 4 <= K_WSTAGES * K_WSTAGE)
    elems = (0 if pe_in_ring else m * (p + K_PAD)) + m * (v + K_PAD) + (
        1 if fp32 else 2) * m * (act + K_PAD)
    floats = 4 * m + 5 * rows + 2 * K_WARPS * act + (9 * m if row else 0)
    return (K_WSTAGES * K_WSTAGE + 1024 + (4 if fp32 else 2) * elems
            + 4 * floats)


def pack_v1(weights: Sequence[torch.Tensor], net_depth: int, skips,
            multires: int, multires_views: int, compute_dtype,
            use_viewdirs: bool = True):
    """The torch-layout list -> a `fused_mlp_v2.PackedMLP` for the v1
    kernels: heads on [pe | h] after a skip at the last trunk layer and,
    with use_viewdirs=False, the output head.

    Limits that stay, each raised here with its reason: a width that is a
    multiple of 32 and a view width that is a multiple of 16 (the wmma
    tiles of the walk), and an encoding that fits the shared-memory plan
    (227 KB a block: at width 256 and 4 view frequencies, multires <= 47;
    multires 21 gives P = 144 columns and a 192,512-byte forward block in
    bf16)."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    packed = v2.pack(weights, net_depth, skips, multires, multires_views,
                     compute_dtype, v1=True, use_viewdirs=use_viewdirs)
    fwd, train = v1_smem_bytes(packed)
    if max(fwd, train) > SMEM_LIMIT:
        raise ValueError(
            f"multires {multires} / {multires_views} at width "
            f"{packed.width}: the v1 kernels' shared-memory plan takes "
            f"{max(fwd, train)} bytes a block, past the {SMEM_LIMIT} an "
            "H100 block can have")
    return packed


def v1_packed_for(weights, net_depth, skips, multires, multires_views, cd,
                  use_viewdirs=True):
    """`weights` (a flat list or a v1 PackedMLP) as a v1 PackedMLP."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    if isinstance(weights, v2.PackedMLP):
        v2._packed_for(weights, net_depth, skips, multires, multires_views,
                       cd, v1=True)
        if (weights.out_ch == 0) != use_viewdirs:
            raise ValueError("PackedMLP was packed for another head")
        return weights
    return pack_v1(weights, net_depth, skips, multires, multires_views, cd,
                   use_viewdirs)


def pack_for(kind: str, weights, net_depth, skips, multires, multires_views,
             compute_dtype):
    """The flat list packed once for the kernels of `fused_kernel=kind`:
    `pack_v1` for the v1 kinds, `fused_mlp_v2.pack` otherwise."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    pack = pack_v1 if kind in V1_KINDS else v2.pack
    return pack(weights, net_depth, skips, multires, multires_views,
                compute_dtype)


def v1_forward(packed, pts: torch.Tensor, views: torch.Tensor):
    """Launch `fused_mlp_v1_fwd` on CUDA [N, 3] streams (views unread with
    the output head): (raw [N, 4] or [N, out_ch], whether a kernel was
    launched: not for N = 0). Counts nothing: each caller counts the
    kernel it serves (#12 or #13)."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    return v2.fwd_launch(KERNEL, KERNEL, packed, pts, views, True,
                         (packed.out_ch,))


def fwd_plan(packed, n: int) -> dict:
    """The walk that `fused_mlp_v1_fwd` (#12, #13) runs for n points of the
    v1 `packed`, decided by shapes alone (`fused_mlp_v1_fwd_plan`, the
    eight slots of `fused_mlp_v2.PLAN_SLOTS`): in bf16 at #1's shapes the
    Hopper walk that #10 runs; a skip into the heads, the output head, P >
    128 and fp32 keep `mlp_fwd.cuh`'s walk. Needs the card."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    return v2.plan_dict(v2._entry(KERNEL, KERNEL + "_plan", 0, 8),
                        (n, *v2._cfg_ints(packed), packed.out_ch))


def fused_mlp(weights, pts: torch.Tensor, viewdirs: torch.Tensor, *,
              net_depth: int = 8, skips=(4,), multires: int = 10,
              multires_views: int = 4, use_viewdirs: bool = True,
              compute_dtype=torch.float32) -> torch.Tensor:
    """The NeRF MLP on [N, 3] points (+ view directions): raw [N, 4], or
    [N, output_ch] with use_viewdirs=False. Kernel #12.

    `weights`: the flat torch-layout list (`flatten_params`) or a v1
    `PackedMLP` (`pack_v1`, packed once by a caller that renders many
    chunks). CPU tensors take the plain version `_mlp_body`; CUDA tensors
    launch the kernel or raise."""
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    if not isinstance(weights, (list, tuple, v2.PackedMLP)):
        raise TypeError("fused_mlp takes the flat weight list "
                        "(flatten_params) or a PackedMLP (pack_v1), not "
                        f"{type(weights).__name__}")
    cd = as_dtype(compute_dtype)
    skips = tuple(sorted(skips))
    if pts.device.type == "cpu":
        if isinstance(weights, v2.PackedMLP):
            v1_packed_for(weights, net_depth, skips, multires,
                          multires_views, cd, use_viewdirs)
            weights = weights.flat
        return _mlp_body(pts, viewdirs, weights, net_depth=net_depth,
                         skips=skips, multires=multires,
                         multires_views=multires_views,
                         use_viewdirs=use_viewdirs, compute_dtype=cd)
    if pts.device.type != "cuda":
        raise ValueError(f"no fused forward for device {pts.device}")
    packed = v1_packed_for(weights, net_depth, skips, multires,
                           multires_views, cd, use_viewdirs)
    out, launched = v1_forward(packed, pts,
                               viewdirs if use_viewdirs else pts)
    global launches
    launches += launched
    return out
