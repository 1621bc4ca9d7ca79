#!/usr/bin/env python3
"""Where the fp32 level walk of #2 (`csrc/fused_mlp_bwd.cu`) stands
against fp32 and fp64 arithmetic, on one card:

    python3 tools/fp32_walk_diag.py

For seeded weights (a NeRFMLP 8x256, multires 10 / 4) and seeded points
(uniform in [-2, 2], unit view directions, a normal cotangent) at 3000,
20,000 and 196,607 points, it launches fp32 #2, keeps its workspace (the
three bf16 planes of every saved row, summed back to fp32 exactly) and
prints:

* per trunk layer, the distance of the kernel's activations from the
  same layer in fp64 on the kernel's own inputs, over sum |x w| (mean,
  and its mean sign: the bias), beside a fp32 matmul's on those inputs;
* per trunk layer, the units whose ReLU mask differs from the plain
  fp32 forward's (`fused_mlp_v2.packed_forward_saved`, the plain
  versions' matmul);
* the dW against the same product in fp64 over the kernel's own saved
  rows (its dW GEMM alone), and against the plain packed walk
  (`packed_bwd_reference_T`, fp32): max relative L2 over the tensors.

Prints the card's name and power limit. Needs the card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SKIPS, MR, MV, DEPTH, WIDTH = (4,), 10, 4, 8, 256


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA device")
    from consistentnerf_tpu_torch.models.mlp import NeRFMLP
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    kept = []
    buffers = v2.level_buffers

    def keep(*a):
        out = buffers(*a)
        kept.append(out)
        return out

    v2.level_buffers = keep
    mlp = NeRFMLP(net_depth=DEPTH, net_width=WIDTH)
    mlp.reset_parameters(torch.Generator().manual_seed(1))
    flat = [x.detach().to(dev) for x in fm.flatten_params(mlp)]
    packed = v2.pack(flat, DEPTH, SKIPS, MR, MV, "float32")
    w, b = v2._packed_weights(packed)
    p_, v_ = (v2._pad16(x) for x in v2.enc_widths("pe", MR, MV))
    h_ = packed.view_width
    total = p_ + v_ + 2 * (DEPTH * WIDTH + WIDTH + h_)
    plan = v2._entry(v2.BWD_KERNEL, "fused_mlp_bwd_plan", 0, 7)
    for n in (3000, 20_000, 196_607):
        kept.clear()
        g = torch.Generator().manual_seed(n)
        pts = (torch.rand(3, n, generator=g) * 4 - 2).to(dev)
        views = torch.randn(3, n, generator=g)
        views = (views / views.norm(dim=0, keepdim=True)).to(dev)
        cot = torch.randn(4, n, generator=g).to(dev)
        got = v2.bwd_T(packed, pts, views, cot, DEPTH, SKIPS, MR, MV,
                       "float32")
        torch.cuda.synchronize()
        pl = (ctypes.c_longlong * 9)()
        plan(n, DEPTH, WIDTH, 1 << SKIPS[0], MR, MV, 0, pl)
        cpts, rows = pl[4], -(-pl[4] // 64) * 64
        ws = kept[0][0]
        planes = ws.view(3, -1, total).float()
        full = ((planes[0] + planes[1]) + planes[2]).double()
        idx = torch.arange(n, device=dev)
        f = full[(idx // cpts) * rows + idx % cpts]
        pe = f[:, :p_]
        o = p_ + v_
        acts = [f[:, o + i * WIDTH:o + (i + 1) * WIDTH]
                for i in range(DEPTH)]
        o += DEPTH * WIDTH
        feat, hv = f[:, o:o + WIDTH], f[:, o + WIDTH:o + WIDTH + h_]
        o += WIDTH + h_
        gpre = [f[:, o + i * WIDTH:o + (i + 1) * WIDTH]
                for i in range(DEPTH)]
        o += DEPTH * WIDTH
        gfeat, ghv = f[:, o:o + WIDTH], f[:, o + WIDTH:o + WIDTH + h_]
        ve = f[:, p_:p_ + v_]
        _, saved = v2.packed_forward_saved(packed, pts, views)
        print(f"N={n} ({cpts}-point chunks):")
        for i in range(DEPTH):
            x = pe if i == 0 else (torch.cat([pe, acts[i - 1]], 1)
                                   if i - 1 in SKIPS else acts[i - 1])
            wi, bi = w[f"pts_{i}"].double(), b[f"pts_{i}"].double()
            ref = x @ wi + bi
            scale = (x.abs() @ wi.abs()).clamp_min(1e-30)
            on = ref > 0
            err = ((acts[i] - ref.clamp_min(0)) / scale)[on]
            mm = (x.float() @ w[f"pts_{i}"] + b[f"pts_{i}"]).double()
            err32 = ((mm - ref) / scale)[on]
            flips = ((acts[i] > 0) != (saved["acts"][i] > 0)).sum().item()
            print(f"  layer {i}: kernel {err.abs().mean().item():.2e} of "
                  f"sum |x w| (bias {err.mean().item():.2e}), fp32 matmul "
                  f"{err32.abs().mean().item():.2e}; masks unlike the plain "
                  f"forward's: {flips}")
        # The kernel's dW in the packed layout (its grads packed as
        # weights), against A^T G in fp64 over its own saved rows.
        own = {}
        for i in range(DEPTH):
            x = pe if i == 0 else (torch.cat([pe, acts[i - 1]], 1)
                                   if i - 1 in SKIPS else acts[i - 1])
            own[f"pts_{i}"] = x.T @ gpre[i]
        own["feature"] = acts[-1].T @ gfeat
        own["views_0"] = torch.cat([feat, ve], 1).T @ ghv
        mine = v2._split(v2.pack(got, DEPTH, SKIPS, MR, MV, "float32").w,
                         v2._block_shapes(packed)[0])
        e_own = max((torch.linalg.norm(mine[k].double() - o_)
                     / torch.linalg.norm(o_).clamp_min(1e-30)).item()
                    for k, o_ in own.items())
        want = v2.packed_bwd_reference_T(packed, pts, views, cot)
        e_ref = max((torch.linalg.norm(a - c)
                     / torch.linalg.norm(c).clamp_min(1e-30)).item()
                    for a, c in zip(got, want))
        print(f"  dW: against fp64 over its own rows {e_own:.2e}; against "
              f"the plain packed walk {e_ref:.2e} (max rel L2)")


if __name__ == "__main__":
    main()
