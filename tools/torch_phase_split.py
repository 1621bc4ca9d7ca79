#!/usr/bin/env python3
"""Where the one-pass train kernel spends its time, on one CUDA card.

    python3 tools/torch_phase_split.py

Builds `csrc/onepass_level.cu` four times from patched copies of
`csrc/mlp_train.cuh` (beside copies of the other headers) under
`build/phase_split/`: as it is, without the dW
pass, without the dW pass and the backward walk, and without those and
without saving activations to the workspace. Each variant is timed with
CUDA events on the flagship fine level (4096 rays x 192 samples, 8x256
MLP, bf16, seeded random weights and rays); the differences are the
phases' times. The variants compute wrong grads by construction; only
the full build is a kernel of the port. Prints the card's name and power
limit beside the times. Imports torch and the port only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

VARIANTS = {
    "full": [],
    "no_dw": ["-DPHASE_NO_DW"],
    "fwd_saves": ["-DPHASE_NO_DW", "-DPHASE_NO_BWD"],
    "fwd": ["-DPHASE_NO_DW", "-DPHASE_NO_BWD", "-DPHASE_NO_SAVE"],
}
# Calls of save_tile<T, M>( in mlp_train.cuh (the forward's five saves).
SAVE_CALLS = 5


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    """src.replace that fails unless `old` occurs exactly `count` times,
    so that an edit of the header cannot leave a phase in silently."""
    found = src.count(old)
    if found != count:
        raise ValueError(f"anchor {old!r} occurs {found} times in "
                         f"mlp_train.cuh, expected {count}")
    return src.replace(old, new)


def patched_header(src: str) -> str:
    """mlp_train.cuh with #ifndef guards around the phases."""
    src = _replace(src, "    // ---- backward over sub-tiles ----",
                   "#ifndef PHASE_NO_BWD\n"
                   "    // ---- backward over sub-tiles ----")
    src = _replace(src, "    // ---- dW over the chunk ----",
                   "#endif\n#ifndef PHASE_NO_DW\n"
                   "    // ---- dW over the chunk ----")
    end = src.index("// dw[j] = sum over blocks")
    close = src.rindex("    __syncthreads();\n  }\n}", 0, end)
    src = src[:close] + "#endif\n" + src[close:]
    src = _replace(src, "save_tile<T, M>(", "PHASE_SAVE(", SAVE_CALLS)
    return _replace(
        src, "// Shared memory of one block",
        "#ifdef PHASE_NO_SAVE\n#define PHASE_SAVE(...)\n#else\n"
        "#define PHASE_SAVE(...) save_tile<T, M>(__VA_ARGS__)\n#endif\n"
        "// Shared memory of one block")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from consistentnerf_tpu_torch.models.mlp import NeRFMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    csrc = REPO / "build" / "phase_split" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        text = header.read_text()
        if header.name == "mlp_train.cuh":
            text = patched_header(text)
        (csrc / header.name).write_text(text)
    (csrc / "onepass_level.cu").write_text(
        (_build.CSRC / "onepass_level.cu").read_text())

    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    g = torch.Generator().manual_seed(0)
    mlp = NeRFMLP()
    mlp.reset_parameters(g)
    packed = v2.pack([w.detach().to(dev) for w in fm.flatten_params(mlp)],
                     8, (4,), 10, 4, "bfloat16")
    n_rays, seg = 4096, 192
    o = torch.randn(n_rays, 3, generator=g) * 0.3 - torch.tensor(
        [0.0, 0.0, 4.0])
    d = torch.randn(n_rays, 3, generator=g) * 0.2 + torch.tensor(
        [0.0, 0.0, 1.0])
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2, -1).values
    o, d, z = o.to(dev), d.to(dev), z.to(dev).contiguous()
    pts, views = op._pts_views(o.T, d.T, (d / d.norm(dim=-1,
                                                     keepdim=True)).T, z)
    rows = [torch.rand(n_rays, generator=g).to(dev) * 1e-3
            for _ in range(3)]
    tgt = torch.rand(n_rays, 3, generator=g).to(dev)
    args = (pts, views, z, d.norm(dim=-1), rows[0], tgt, rows[1],
            rows[2] + 4)

    base_flags = list(_build.NVCC_FLAGS)
    _build.CSRC = csrc
    times = {}
    for name, flags in VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / name
        _build._LIBS.clear()
        op._kernel.cache_clear()

        def run():
            return op.onepass_level(packed, *args, white_bkgd=True,
                                    compute_dtype="bfloat16")

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 3
        print(f"[{card}] {name}: {times[name]:.2f} ms", flush=True)
    print(f"[{card}] one-pass fine level ({n_rays * seg} points, bf16): "
          f"dW pass {times['full'] - times['no_dw']:.2f} ms, backward "
          f"walk {times['no_dw'] - times['fwd_saves']:.2f} ms, workspace "
          f"saves {times['fwd_saves'] - times['fwd']:.2f} ms, forward and "
          f"compositing {times['fwd']:.2f} ms, of {times['full']:.2f} ms")


if __name__ == "__main__":
    main()
