#!/usr/bin/env python3
"""Where the train kernels on `csrc/level_train.cuh` (the one-pass levels
#3 and #5, the weight grads #2, #7, #11, #14 and #16) and the bf16
forwards #1, #10, #6 and #15 spend their time, on one CUDA card.

    python3 tools/torch_phase_split.py          # the bf16 parts
    python3 tools/torch_phase_split.py level    # #2, #3, #5, #7, #11, #14, #16
    python3 tools/torch_phase_split.py fwd      # #1, #10, #6, #15 and 6n
    python3 tools/torch_phase_split.py fp32     # #3, #2, #5, #7 in fp32
    python3 tools/torch_phase_split.py fwd32    # #1, #6 in fp32

Builds `csrc/onepass_level.cu` (#3), `csrc/onepass_mip_level.cu` (#5),
`csrc/fused_mlp_bwd.cu` (#2 and #11), `csrc/fused_mip_bwd.cu` (#7 and
#16) and `csrc/fused_mlp_v1_bwd.cu` (#14) four times from patched copies of
`csrc/level_train.cuh` (beside copies of the other headers) under
`build/phase_split/`: as they are, without the dW GEMM, without the dW
GEMM and the backward walk, and without those and without saving
activations to the workspace. Each variant is timed with CUDA events at
the main path's shapes, bf16, seeded random weights and rays: #3 at the
flagship step's fine level (4096 rays x 192 samples) and coarse level
(x 64), #5 at a mip level (3072 rays x 96 samples), #2 at the one-pass
step's fine patch launch (1024 patch rays x 192 samples), #7 at a mip
patch level (1024 x 96), #2, #11 and #14 on the same points of the
two-call step's fine level (5120 rays x 192 samples: [3, N] streams for
#2, their [N, 3] transposes for #11 and #14), and #7 and #16 on the same
points of the mip two-call step's level (4096 rays x 96 samples), with a
seeded cotangent;
the differences are the phases' times (for the weight grads "forward"
includes reading the cotangent). The variants compute wrong grads by
construction; only the full build is a kernel of the port.

The forward part builds `csrc/fused_mlp_fwd.cu` (#1 and its row-major
twin #10) and `csrc/fused_mip_fwd.cu` (#6) four times from patched copies
of `csrc/fwd_hopper.cuh` under `build/phase_split/fwd_*`: as they are,
without the heads, without the heads and the encoding, and with the
products only (no heads, no encoding, no epilogue). Each is timed at the
render's chunk shapes, bf16, seeded random weights and points: #1 at the
fine chunk (8192 rays x 192 samples) and the coarse chunk (x 64), #10 on
the fine chunk's points as [N, 3] streams (the same walk under the
row-major layout: its encoders read 12-byte rows, its heads store
[N, 4]), #6 at a chunk (8192 rays x 96 samples) and #15 on that chunk's
Gaussians as [N, 3] streams. The differences are the
heads', the encoding's (what the producer does not hide) and the
epilogues' times.
Then it builds `csrc/fused_mip_fwd.cu` three times more from copies of
`csrc/fwd_hopper.cuh` with 6n's normals tail guarded (under
`build/phase_split/normals_*`): as it is, without the IPE's Jacobian, and
without the Jacobian and the walk back (its products and its weight
slabs), and times 6n on the same chunk: the differences are the
Jacobian's and the walk back's times, the rest #6's forward with the
masks kept. The fp32 part builds `csrc/onepass_level.cu`,
`csrc/fused_mlp_bwd.cu`, `csrc/onepass_mip_level.cu` and
`csrc/fused_mip_bwd.cu` in the level part's four variants and times fp32
#3 at the fine level, #2 at the fine patch launch, #5 at a level of the
regnerf3 presets' data rays (1024 x 96) and #7 at their MiDaS patch rays
(1024 x 96) (the fp32 walk: its forward on the CUDA cores, its backward
and dW GEMM as six bf16 products; "forward" holds the forward, the heads
and the compositing). The fwd32 part builds `csrc/fused_mlp_fwd.cu` and
`csrc/fused_mip_fwd.cu` three times, as they are, without the heads
and without the heads and the encoding, from copies of
`csrc/fwd_f32.cuh` (the fp32 walk of #1 and #6) with its heads guarded
and of `csrc/fwd_hopper.cuh` with the encoders' feature computations
guarded (the fp32 walk runs them with an fp32 store), and times fp32 #1
at the fine render chunk and the vanilla presets' fine patch level (1024
x 192) and fp32 #6 at the render chunk and the mip presets' patch rays
(1024 x 96): the heads', the encoding's (what the encoder warps take from
the consumers) and the rest's (products, epilogues, barriers and the
weight stream) times. Prints the
card's name and power limit beside the times. Imports torch and the port
only.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SOURCE_DIR = REPO / "consistentnerf_tpu_torch" / "csrc"

HEADER = "level_train.cuh"
SOURCES = ("onepass_level.cu", "onepass_mip_level.cu", "fused_mlp_bwd.cu",
           "fused_mip_bwd.cu", "fused_mlp_v1_bwd.cu")
# Points of the two-call step's fine level (5120 rays x 192 samples),
# where #2, #11 and #14 are split on the same points.
TWOCALL_FINE = 5120 * 192
# Points of the mip two-call step's level (4096 rays x 96 samples), where
# #7 and #16 are split on the same points.
MIP_LEVEL = 4096 * 96
VARIANTS = {
    "full": [],
    "no_dw": ["-DPHASE_NO_DW"],
    "fwd_saves": ["-DPHASE_NO_DW", "-DPHASE_NO_BWD"],
    "fwd": ["-DPHASE_NO_DW", "-DPHASE_NO_BWD", "-DPHASE_NO_SAVE"],
}
# Calls of save_rows<M>( in the level walk: the one in its `save` helper,
# which makes every save of the bf16 walk (the forward's pe, ve, every
# trunk layer, feat, hv and the backward's rounded gradients); and of
# save_rows3<M>(, the same saves of the fp32 walk (three planes).
SAVE_CALLS = 1

FWD_HEADER = "fwd_hopper.cuh"
FWD_SOURCES = ("fused_mlp_fwd.cu", "fused_mip_fwd.cu")
FWD_VARIANTS = {
    "full": [],
    "no_heads": ["-DPHASE_NO_HEADS"],
    "no_encode": ["-DPHASE_NO_HEADS", "-DPHASE_NO_ENCODE"],
    "products": ["-DPHASE_NO_HEADS", "-DPHASE_NO_ENCODE",
                 "-DPHASE_NO_EPILOGUE"],
}
# The guarded regions of the forward walk: (first line, last line, macro,
# occurrences): the two heads, the encoders' feature computations (the
# NeRF PE, the mip IPE and view encoding) and the epilogue's body.
FWD_REGIONS = (
    ("      // ---- alpha head ----",
     "      // ---- end of the alpha head ----", "PHASE_NO_HEADS", 1),
    ("      // ---- rgb head ----",
     "      // ---- end of the rgb head ----", "PHASE_NO_HEADS", 1),
    ("      // ---- encode ----", "      // ---- end of the encode ----",
     "PHASE_NO_ENCODE", 3),
    ("    // ---- epilogue ----", "    // ---- end of the epilogue ----",
     "PHASE_NO_EPILOGUE", 1),
)


# 6n's guarded regions of the forward walk: the walk back's weight slabs
# (the producer), the walk back (the consumers) and the IPE's Jacobian.
NORMALS_SOURCE = "fused_mip_fwd.cu"
NORMALS_REGIONS = (
    ("            // ---- the walk back's slabs ----",
     "            // ---- end of the walk back's slabs ----",
     "PHASE_NO_NORMALS_BWD", 1),
    ("        // ---- normals backward ----",
     "        // ---- end of the normals backward ----",
     "PHASE_NO_NORMALS_BWD", 1),
    ("        // ---- jacobian ----", "        // ---- end of the jacobian ----",
     "PHASE_NO_JACOBIAN", 1),
)
NORMALS_VARIANTS = {
    "full": [],
    "no_jacobian": ["-DPHASE_NO_JACOBIAN"],
    "forward": ["-DPHASE_NO_JACOBIAN", "-DPHASE_NO_NORMALS_BWD"],
}


def _replace(src: str, old: str, new: str, count: int = 1,
             header: str = HEADER) -> str:
    """src.replace that fails unless `old` occurs exactly `count` times,
    so that an edit of the header cannot leave a phase in silently."""
    found = src.count(old)
    if found != count:
        raise ValueError(f"anchor {old!r} occurs {found} times in "
                         f"{header}, expected {count}")
    return src.replace(old, new)


def patched_header(src: str) -> str:
    """level_train.cuh with #ifndef guards around the phases."""
    src = _replace(src, "    // ---- backward over sub-tiles ----",
                   "#ifndef PHASE_NO_BWD\n"
                   "    // ---- backward over sub-tiles ----")
    src = _replace(src, "    // ---- end of the backward ----",
                   "#endif\n    // ---- end of the backward ----")
    # Without the backward, its products leave the weight stream too.
    src = _replace(src, "  return d.depth + 1;\n",
                   "#ifdef PHASE_NO_BWD\n  return 0;\n#else\n"
                   "  return d.depth + 1;\n#endif\n")
    src = _replace(src, "  // ---- the dW GEMM ----",
                   "#ifndef PHASE_NO_DW\n  // ---- the dW GEMM ----")
    src = _replace(src, "  // ---- end of the dW GEMM ----",
                   "#endif\n  // ---- end of the dW GEMM ----")
    src = _replace(src, "save_rows<M>(", "PHASE_SAVE(", SAVE_CALLS)
    src = _replace(src, "save_rows3<M>(", "PHASE_SAVE3(", SAVE_CALLS)
    return _replace(
        src, "__device__ inline float rnd(",
        "#ifdef PHASE_NO_SAVE\n#define PHASE_SAVE(...)\n"
        "#define PHASE_SAVE3(...)\n#else\n"
        "#define PHASE_SAVE(...) save_rows<M>(__VA_ARGS__)\n"
        "#define PHASE_SAVE3(...) save_rows3<M>(__VA_ARGS__)\n#endif\n"
        "__device__ inline float rnd(")


# The fp32 forward walk's guarded regions (csrc/fwd_f32.cuh), under the
# forward part's macros: its two heads; its encoders are fwd_hopper.cuh's
# (FWD_REGIONS' encode region). Its epilogue stays: without it the
# compiler drops the fma chains whose results nothing stores (the bf16
# walk's wgmma products are volatile asm), so the fp32 split has three
# variants.
F32_HEADER = "fwd_f32.cuh"
F32_REGIONS = (
    ("    // ---- alpha head ----", "    // ---- end of the alpha head ----",
     "PHASE_NO_HEADS", 1),
    ("    // ---- rgb head ----", "    // ---- end of the rgb head ----",
     "PHASE_NO_HEADS", 1),
)
F32_VARIANTS = {name: FWD_VARIANTS[name]
                for name in ("full", "no_heads", "no_encode")}


def patched_sources(csrc: Path) -> dict:
    """File name -> text of the phase-split build: every header (the level
    header patched) and the four kernels on it, which must include it."""
    out = {h.name: h.read_text() for h in sorted(csrc.glob("*.cuh"))}
    out[HEADER] = patched_header(out[HEADER])
    for name in SOURCES:
        text = (csrc / name).read_text()
        if f'#include "{HEADER}"' not in text:
            raise ValueError(f"{name} does not include {HEADER}")
        out[name] = text
    return out


def patched_fwd_header(src: str, regions=FWD_REGIONS,
                       header: str = FWD_HEADER) -> str:
    """fwd_hopper.cuh with #ifndef guards around the heads, the encoding
    and the epilogue (or around 6n's `regions`; or fwd_f32.cuh, `header`,
    around F32_REGIONS)."""
    for first, last, macro, count in regions:
        src = _replace(src, first + "\n", f"#ifndef {macro}\n{first}\n",
                       count, header)
        src = _replace(src, last + "\n", f"{last}\n#endif\n", count,
                       header)
    return src


def patched_fwd_sources(csrc: Path, normals: bool = False) -> dict:
    """File name -> text of the forward phase-split build: every header
    (the forward walk's patched) and the two forward kernels, which must
    include it; with `normals`, 6n's regions guarded and its source."""
    out = {h.name: h.read_text() for h in sorted(csrc.glob("*.cuh"))}
    out[FWD_HEADER] = patched_fwd_header(
        out[FWD_HEADER], NORMALS_REGIONS if normals else FWD_REGIONS)
    for name in (NORMALS_SOURCE,) if normals else FWD_SOURCES:
        text = (csrc / name).read_text()
        if f'#include "{FWD_HEADER}"' not in text:
            raise ValueError(f"{name} does not include {FWD_HEADER}")
        out[name] = text
    return out


def patched_f32_sources(csrc: Path) -> dict:
    """File name -> text of the fp32 forward phase-split build: the
    forward build's (`patched_fwd_sources`), with fwd_f32.cuh's heads
    guarded too; both forward kernels include it."""
    out = patched_fwd_sources(csrc)
    out[F32_HEADER] = patched_fwd_header(out[F32_HEADER], F32_REGIONS,
                                         F32_HEADER)
    for name in FWD_SOURCES:
        if f'#include "{F32_HEADER}"' not in out[name]:
            raise ValueError(f"{name} does not include {F32_HEADER}")
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()


def _time(run, iters=3) -> float:
    import torch

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fwd_main() -> None:
    """Times #1, #10, #6 and #15 in the four forward variants."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")

    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    card = _card()
    csrc = REPO / "build" / "phase_split" / "fwd_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name, text in patched_fwd_sources(SOURCE_DIR).items():
        (csrc / name).write_text(text)
    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    g = torch.Generator().manual_seed(0)
    mlp = NeRFMLP()
    mlp.reset_parameters(g)
    packed = v2.pack([w.detach().to(dev) for w in fm.flatten_params(mlp)],
                     8, (4,), 10, 4, "bfloat16")
    mip = MipMLP(net_depth=8, net_width=256)
    mip.reset_parameters(g)
    mpacked = fmip.pack([w.detach().to(dev)
                         for w in fmip.flatten_mip_params(mip)], 8, 16,
                        "bfloat16")

    def unit(n):
        v = torch.randn(3, n, generator=g)
        return (v / v.norm(dim=0, keepdim=True)).to(dev)

    def nerf(n, row=False):
        pts = (torch.rand(3, n, generator=g) * 4 - 2).to(dev)
        views = unit(n)
        if row:
            pts, views = pts.T.contiguous(), views.T.contiguous()
        fwd = v2.fwd if row else v2.fwd_T
        return lambda: fwd(packed, pts, views, 8, (4,), 10, 4, "bfloat16")

    n_mip = 8192 * 96
    means = (torch.rand(3, n_mip, generator=g) * 3 - 1.5).to(dev)
    covs = (torch.rand(3, n_mip, generator=g) * 1e-4).to(dev)
    mviews = unit(n_mip)
    m_row = [x.T.contiguous() for x in (means, covs, mviews)]
    cases = {
        f"#1 fine chunk ({8192 * 192} points)": nerf(8192 * 192),
        f"#1 coarse chunk ({8192 * 64} points)": nerf(8192 * 64),
        f"#10 fine chunk ({8192 * 192} points, row-major)": nerf(
            8192 * 192, row=True),
        f"#6 chunk ({n_mip} points)": lambda: fmip.fwd_T(
            mpacked, means, covs, mviews, 8, 16, "bfloat16"),
        f"#15 chunk ({n_mip} points, row-major)": lambda: fmip.fwd(
            mpacked, *m_row, 8, 16, "bfloat16"),
    }
    base_flags = list(_build.NVCC_FLAGS)
    _build.CSRC = csrc
    times = {case: {} for case in cases}
    for name, flags in FWD_VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / f"fwd_{name}"
        _build._LIBS.clear()
        v2._entry.cache_clear()
        _build.build_all([s[:-3] for s in FWD_SOURCES])
        for case, run in cases.items():
            times[case][name] = _time(run)
            print(f"[{card}] {case} {name}: {times[case][name]:.3f} ms",
                  flush=True)
    for case, t_ in times.items():
        print(f"[{card}] {case}, bf16: heads "
              f"{t_['full'] - t_['no_heads']:.3f} ms, encoding (not hidden) "
              f"{t_['no_heads'] - t_['no_encode']:.3f} ms, epilogues "
              f"{t_['no_encode'] - t_['products']:.3f} ms, products and the "
              f"weight stream {t_['products']:.3f} ms, of "
              f"{t_['full']:.3f} ms", flush=True)

    # 6n on the same chunk, its normals tail cut in phases.
    ncsrc = REPO / "build" / "phase_split" / "normals_csrc"
    ncsrc.mkdir(parents=True, exist_ok=True)
    for name, text in patched_fwd_sources(SOURCE_DIR, normals=True).items():
        (ncsrc / name).write_text(text)
    _build.CSRC = ncsrc
    case = f"6n chunk ({n_mip} points)"
    t6n = {}
    for name, flags in NORMALS_VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / f"normals_{name}"
        _build._LIBS.clear()
        v2._entry.cache_clear()
        _build.build_all([NORMALS_SOURCE[:-3]])
        t6n[name] = _time(lambda: fmip.fused_mip_mlp_normals_T(
            mpacked, means, covs, mviews, 8, 16, "bfloat16"))
        print(f"[{card}] {case} {name}: {t6n[name]:.3f} ms", flush=True)
    print(f"[{card}] {case}, bf16: IPE Jacobian "
          f"{t6n['full'] - t6n['no_jacobian']:.3f} ms, walk back "
          f"{t6n['no_jacobian'] - t6n['forward']:.3f} ms, forward (with "
          f"the masks) {t6n['forward']:.3f} ms, of {t6n['full']:.3f} ms",
          flush=True)


def fwd32_main() -> None:
    """Times fp32 #1 and #6 in the three fp32 variants."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")

    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2

    card = _card()
    csrc = REPO / "build" / "phase_split" / "fwd32_csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name, text in patched_f32_sources(SOURCE_DIR).items():
        (csrc / name).write_text(text)
    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    g = torch.Generator().manual_seed(0)
    mlp = NeRFMLP()
    mlp.reset_parameters(g)
    packed = v2.pack([w.detach().to(dev) for w in fm.flatten_params(mlp)],
                     8, (4,), 10, 4, "float32")
    mip = MipMLP(net_depth=8, net_width=256)
    mip.reset_parameters(g)
    mpacked = fmip.pack([w.detach().to(dev)
                         for w in fmip.flatten_mip_params(mip)], 8, 16,
                        "float32")

    def unit(n):
        v = torch.randn(3, n, generator=g)
        return (v / v.norm(dim=0, keepdim=True)).to(dev)

    def nerf(n):
        pts = (torch.rand(3, n, generator=g) * 4 - 2).to(dev)
        views = unit(n)
        return lambda: v2.fwd_T(packed, pts, views, 8, (4,), 10, 4,
                                "float32")

    def mipnerf(n):
        means = (torch.rand(3, n, generator=g) * 3 - 1.5).to(dev)
        covs = (torch.rand(3, n, generator=g) * 1e-4).to(dev)
        views = unit(n)
        return lambda: fmip.fwd_T(mpacked, means, covs, views, 8, 16,
                                  "float32")
    cases = {
        f"#1 fine chunk ({8192 * 192} points)": nerf(8192 * 192),
        f"#1 fine patch level ({1024 * 192} points)": nerf(1024 * 192),
        f"#6 chunk ({8192 * 96} points)": mipnerf(8192 * 96),
        f"#6 patch rays ({1024 * 96} points)": mipnerf(1024 * 96),
    }
    base_flags = list(_build.NVCC_FLAGS)
    _build.CSRC = csrc
    times = {case: {} for case in cases}
    for name, flags in F32_VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / f"fwd32_{name}"
        _build._LIBS.clear()
        v2._entry.cache_clear()
        _build.build_all([s[:-3] for s in FWD_SOURCES])
        for case, run in cases.items():
            times[case][name] = _time(run)
            print(f"[{card}] {case} fp32 {name}: {times[case][name]:.3f} "
                  "ms", flush=True)
    for case, t_ in times.items():
        print(f"[{card}] {case}, fp32: heads "
              f"{t_['full'] - t_['no_heads']:.3f} ms, encoding (not hidden) "
              f"{t_['no_heads'] - t_['no_encode']:.3f} ms, products, "
              f"epilogues and the weight stream {t_['no_encode']:.3f} ms, "
              f"of {t_['full']:.3f} ms", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op

    card = _card()
    csrc = REPO / "build" / "phase_split" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name, text in patched_sources(SOURCE_DIR).items():
        (csrc / name).write_text(text)

    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    g = torch.Generator().manual_seed(0)
    mlp = NeRFMLP()
    mlp.reset_parameters(g)
    packed = v2.pack([w.detach().to(dev) for w in fm.flatten_params(mlp)],
                     8, (4,), 10, 4, "bfloat16")

    def vanilla(n_rays, seg):
        o = torch.randn(n_rays, 3, generator=g) * 0.3 - torch.tensor(
            [0.0, 0.0, 4.0])
        d = torch.randn(n_rays, 3, generator=g) * 0.2 + torch.tensor(
            [0.0, 0.0, 1.0])
        z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2,
                       -1).values
        o, d, z = o.to(dev), d.to(dev), z.to(dev).contiguous()
        pts, views = op._pts_views(o.T, d.T, (d / d.norm(
            dim=-1, keepdim=True)).T, z)
        rows = [torch.rand(n_rays, generator=g).to(dev) * 1e-3
                for _ in range(3)]
        tgt = torch.rand(n_rays, 3, generator=g).to(dev)
        args = (pts, views, z, d.norm(dim=-1), rows[0], tgt, rows[1],
                rows[2] + 4)
        return lambda: op.onepass_level(packed, *args, white_bkgd=True,
                                        compute_dtype="bfloat16")

    mip = MipMLP(net_depth=8, net_width=256)
    mip.reset_parameters(g)
    mpacked = fmip.pack([w.detach().to(dev)
                         for w in fmip.flatten_mip_params(mip)], 8, 16,
                        "bfloat16")
    n_rays, seg = 3072, 96
    t = torch.sort(torch.rand(n_rays, seg + 1, generator=g) * 4 + 2,
                   -1).values.to(dev)
    dn = (0.5 + torch.rand(n_rays, generator=g)).to(dev)
    vd = torch.randn(3, n_rays, generator=g)
    means = (torch.rand(3, n_rays * seg, generator=g) * 3 - 1.5).to(dev)
    covs = (torch.rand(3, n_rays * seg, generator=g) * 1e-4).to(dev)
    views = (vd / vd.norm(dim=0, keepdim=True)).to(dev).repeat_interleave(
        seg, 1).contiguous()
    crgb, cd = (torch.rand(n_rays, generator=g).to(dev) * 1e-3
                for _ in range(2))
    tgt = torch.rand(n_rays, 3, generator=g).to(dev)
    prior = torch.rand(n_rays, generator=g).to(dev) + 2
    margs = (means, covs, views, 0.5 * (t[:, 1:] + t[:, :-1]),
             (t[:, 1:] - t[:, :-1]) * dn[:, None], t[:, 0].contiguous(),
             t[:, -1].contiguous(), crgb, tgt, cd, prior)
    n_patch = 1024 * 192
    p_pts = (torch.rand(3, n_patch, generator=g) * 4 - 2).to(dev)
    p_views = torch.randn(3, n_patch, generator=g)
    p_views = (p_views / p_views.norm(dim=0, keepdim=True)).to(dev)
    p_g = (1e-3 * torch.randn(4, n_patch, generator=g)).to(dev)
    n_mpatch = 1024 * seg
    m_g = (1e-3 * torch.randn(4, n_mpatch, generator=g)).to(dev)
    m_streams = [x[:, :n_mpatch].contiguous() for x in (means, covs, views)]
    n_tc = TWOCALL_FINE
    tc_pts = (torch.rand(3, n_tc, generator=g) * 4 - 2).to(dev)
    tc_views = torch.randn(3, n_tc, generator=g)
    tc_views = (tc_views / tc_views.norm(dim=0, keepdim=True)).to(dev)
    tc_g = (1e-3 * torch.randn(4, n_tc, generator=g)).to(dev)
    tc_row = [x.T.contiguous() for x in (tc_pts, tc_views, tc_g)]
    packed_v1 = fm.pack_v1(packed.flat, 8, (4,), 10, 4, "bfloat16")
    ml_means = (torch.rand(3, MIP_LEVEL, generator=g) * 3 - 1.5).to(dev)
    ml_covs = (torch.rand(3, MIP_LEVEL, generator=g) * 1e-4).to(dev)
    ml_views = torch.randn(3, MIP_LEVEL, generator=g)
    ml_views = (ml_views / ml_views.norm(dim=0, keepdim=True)).to(dev)
    ml_g = (1e-3 * torch.randn(4, MIP_LEVEL, generator=g)).to(dev)
    ml_streams = (ml_means, ml_covs, ml_views)
    ml_row = [x.T.contiguous() for x in (*ml_streams, ml_g)]
    cases = {
        f"#3 fine ({4096 * 192} points)": vanilla(4096, 192),
        f"#3 coarse ({4096 * 64} points)": vanilla(4096, 64),
        f"#5 mip level ({n_rays * seg} points)":
            lambda: op.onepass_mip_level(
                mpacked, *margs, net_depth=8, num_freqs=16, white_bkgd=True,
                compute_dtype="bfloat16"),
        f"#2 fine patch ({n_patch} points)": lambda: v2.bwd_T(
            packed, p_pts, p_views, p_g, 8, (4,), 10, 4, "bfloat16"),
        f"#7 patch level ({n_mpatch} points)": lambda: fmip.bwd_T(
            mpacked, *m_streams, m_g, 8, 16, "bfloat16"),
        f"#2 two-call fine ({n_tc} points)": lambda: v2.bwd_T(
            packed, tc_pts, tc_views, tc_g, 8, (4,), 10, 4, "bfloat16"),
        f"#11 two-call fine ({n_tc} points)": lambda: v2.bwd(
            packed, *tc_row, 8, (4,), 10, 4, "bfloat16"),
        f"#14 two-call fine ({n_tc} points)": lambda: fmt.backward(
            packed_v1, *tc_row, 8, (4,), 10, 4, "bfloat16"),
        f"#7 mip level ({MIP_LEVEL} points)": lambda: fmip.bwd_T(
            mpacked, *ml_streams, ml_g, 8, 16, "bfloat16"),
        f"#16 mip level ({MIP_LEVEL} points)": lambda: fmip.bwd(
            mpacked, *ml_row, 8, 16, "bfloat16"),
    }

    base_flags = list(_build.NVCC_FLAGS)
    _build.CSRC = csrc
    times = {case: {} for case in cases}
    for name, flags in VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / name
        _build._LIBS.clear()
        op._kernel.cache_clear()
        op._mip_kernel.cache_clear()
        v2._entry.cache_clear()
        _build.build_all([s[:-3] for s in SOURCES])
        for case, run in cases.items():
            times[case][name] = _time(run)
            print(f"[{card}] {case} {name}: {times[case][name]:.3f} ms",
                  flush=True)
    for case, t_ in times.items():
        print(f"[{card}] {case}, bf16: dW GEMM "
              f"{t_['full'] - t_['no_dw']:.3f} ms, backward walk "
              f"{t_['no_dw'] - t_['fwd_saves']:.3f} ms, workspace saves "
              f"{t_['fwd_saves'] - t_['fwd']:.3f} ms, forward and "
              f"compositing (or the cotangent read) {t_['fwd']:.3f} ms, of "
              f"{t_['full']:.3f} ms",
              flush=True)


def fp32_main() -> None:
    """Times fp32 #3 (fine level), #2 (fine patch launch), #5 (a level of
    the regnerf3 presets' data rays) and #7 (their MiDaS patch rays) in
    the four level variants."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op

    card = _card()
    csrc = REPO / "build" / "phase_split" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for name, text in patched_sources(SOURCE_DIR).items():
        (csrc / name).write_text(text)
    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    g = torch.Generator().manual_seed(0)
    mlp = NeRFMLP()
    mlp.reset_parameters(g)
    packed = v2.pack([w.detach().to(dev) for w in fm.flatten_params(mlp)],
                     8, (4,), 10, 4, "float32")
    n_rays, seg = 4096, 192
    o = torch.randn(n_rays, 3, generator=g) * 0.3 - torch.tensor(
        [0.0, 0.0, 4.0])
    d = torch.randn(n_rays, 3, generator=g) * 0.2 + torch.tensor(
        [0.0, 0.0, 1.0])
    z = torch.sort(torch.rand(n_rays, seg, generator=g) * 4 + 2, -1).values
    o, d, z = o.to(dev), d.to(dev), z.to(dev).contiguous()
    pts, views = op._pts_views(o.T, d.T, (d / d.norm(
        dim=-1, keepdim=True)).T, z)
    rows = [torch.rand(n_rays, generator=g).to(dev) * 1e-3
            for _ in range(3)]
    args = (pts, views, z, d.norm(dim=-1), rows[0],
            torch.rand(n_rays, 3, generator=g).to(dev), rows[1], rows[2] + 4)
    n_patch = 1024 * 192
    p_pts = (torch.rand(3, n_patch, generator=g) * 4 - 2).to(dev)
    p_views = torch.randn(3, n_patch, generator=g)
    p_views = (p_views / p_views.norm(dim=0, keepdim=True)).to(dev)
    p_g = (1e-3 * torch.randn(4, n_patch, generator=g)).to(dev)
    # The mip preset's shapes (regnerf3 / mipnerf3: 1024 rays x 96 a
    # level of #5, 1024 MiDaS patch rays x 96 for #7), MipMLP 8x256.
    mip = MipMLP(net_depth=8, net_width=256)
    mip.reset_parameters(g)
    mpacked = fmip.pack([w.detach().to(dev)
                         for w in fmip.flatten_mip_params(mip)], 8, 16,
                        "float32")
    m_rays, m_seg = 1024, 96
    t = torch.sort(torch.rand(m_rays, m_seg + 1, generator=g) * 3 + 0.5,
                   -1).values.to(dev)
    dn = (0.5 + torch.rand(m_rays, generator=g)).to(dev)
    vd = torch.randn(3, m_rays, generator=g)
    m_pts = m_rays * m_seg
    means = (torch.rand(3, m_pts, generator=g) * 3 - 1.5).to(dev)
    covs = (torch.rand(3, m_pts, generator=g) * 1e-4).to(dev)
    mviews = (vd / vd.norm(dim=0, keepdim=True)).to(dev).repeat_interleave(
        m_seg, 1).contiguous()
    m_rows = [torch.rand(m_rays, generator=g).to(dev) * 1e-3
              for _ in range(2)]
    margs = (means, covs, mviews, 0.5 * (t[:, 1:] + t[:, :-1]),
             (t[:, 1:] - t[:, :-1]) * dn[:, None], t[:, 0].contiguous(),
             t[:, -1].contiguous(), m_rows[0],
             torch.rand(m_rays, 3, generator=g).to(dev), m_rows[1],
             torch.rand(m_rays, generator=g).to(dev) + 2)
    m_g = (1e-3 * torch.randn(4, m_pts, generator=g)).to(dev)
    cases = {
        f"#3 fine ({n_rays * seg} points)": lambda: op.onepass_level(
            packed, *args, white_bkgd=True, compute_dtype="float32"),
        f"#2 fine patch ({n_patch} points)": lambda: v2.bwd_T(
            packed, p_pts, p_views, p_g, 8, (4,), 10, 4, "float32"),
        f"#5 regnerf3 level ({m_pts} points)": lambda: op.onepass_mip_level(
            mpacked, *margs, net_depth=8, num_freqs=16, white_bkgd=False,
            compute_dtype="float32"),
        f"#7 regnerf3 patch rays ({m_pts} points)": lambda: fmip.bwd_T(
            mpacked, means, covs, mviews, m_g, 8, 16, "float32"),
    }
    base_flags = list(_build.NVCC_FLAGS)
    _build.CSRC = csrc
    times = {case: {} for case in cases}
    for name, flags in VARIANTS.items():
        _build.NVCC_FLAGS = base_flags + flags
        _build.BUILD_DIR = REPO / "build" / "phase_split" / f"fp32_{name}"
        _build._LIBS.clear()
        op._kernel.cache_clear()
        op._mip_kernel.cache_clear()
        v2._entry.cache_clear()
        _build.build_all(["onepass_level", "fused_mlp_bwd",
                          "onepass_mip_level", "fused_mip_bwd"])
        for case, run in cases.items():
            times[case][name] = _time(run)
            print(f"[{card}] {case} fp32 {name}: {times[case][name]:.3f} "
                  "ms", flush=True)
    for case, t_ in times.items():
        print(f"[{card}] {case}, fp32: dW GEMM "
              f"{t_['full'] - t_['no_dw']:.3f} ms, backward walk "
              f"{t_['no_dw'] - t_['fwd_saves']:.3f} ms, workspace saves "
              f"{t_['fwd_saves'] - t_['fwd']:.3f} ms, forward, heads and "
              f"compositing (or the cotangent read) {t_['fwd']:.3f} ms, of "
              f"{t_['full']:.3f} ms", flush=True)


if __name__ == "__main__":
    part = sys.argv[1] if len(sys.argv) > 1 else "all"
    if part not in ("all", "level", "fwd", "fp32", "fwd32"):
        sys.exit("usage: torch_phase_split.py [level|fwd|fp32|fwd32]")
    from consistentnerf_tpu_torch.ops import _build

    saved = (_build.CSRC, list(_build.NVCC_FLAGS), _build.BUILD_DIR)
    for run_part, fn in (("level", main), ("fwd", fwd_main),
                         ("fp32", fp32_main), ("fwd32", fwd32_main)):
        if part == run_part or (part == "all" and run_part in ("level",
                                                                "fwd")):
            fn()
            _build.CSRC, _build.NVCC_FLAGS, _build.BUILD_DIR = saved
