#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds every hand-written kernel of the port from `consistentnerf_tpu_torch/
csrc/` (one nvcc per source, in parallel) and drives the main paths, each
with the launch counts set to 0 just before it and read just after:

* the bf16 forward walk of #1, #6, #10, #12 / #13 and #15
  (`csrc/fwd_hopper.cuh`): the plans that pick it by shapes (fp32 and
  v1's shapes past #1's keep the old walk), and the kernels at ragged
  sizes (1, 127, 129 points and a half-empty last wave) against their
  plain versions and bit for bit: #10 against #1 and #15 against #6 (one
  walk, two layouts), #12 and #13 against #10, a repeat of each against
  its first launch; 6n, #6's walk with
  the normals tail, at the same sizes (rows 0-3 bit for bit #6's, a
  repeat bit for bit, rows 4-6 against the plain version in bf16 and
  fp32); the plans of 6n and #4 (the walk with the compositing tail) at
  the render's shapes, which in bf16 must take the walk;
* render: the deterministic bf16 render of the 6-view 128x128 synthetic
  scene through `build_render_fn` (full 8x256 model, 64 + 128 samples,
  seeded weights), then the render CLI on two test views;
* in the train and mip train phases, the weight-grad kernels #2 and #7
  (in bf16 `csrc/level_train.cuh`'s walk in mode 2, its dW GEMM and
  reduction; their plans are printed after the build), both at
  ragged sizes (1, 63, 65, 769, 3000 and 196,607 points) against their
  plain versions in bf16 and fp32 and bit for bit against a second bf16
  launch, beside the main-path gates of the train phases;
* train: the train CLI on the flagship config of `bench.py:66-84` (5120
  rays a step: 4096 random + 4x16x16 patch rays, hard mask, depth loss,
  MiDaS and SSIM patch terms, bf16, perturb 1, the one-pass kernel step)
  for a few steps, a checkpoint, and a resume from it;
* mip render: the same scene through the mip backbone's render (MipMLP
  8x256, 16 IPE frequencies, 96 samples x 2 levels, bf16, the fused mip
  forward);
* mip train: the train CLI on the mip config of `bench.py:241-258` (3072
  random + 4x16x16 MiDaS patch rays, hard mask, depth and MiDaS terms,
  bf16, randomized, the one-pass mip step) for a few steps and a resume;
* the switched paths: the vanilla render with `use_onepass_render` and
  `use_pdf_kernel` (kernels #4 and #8; #4 also at 1, 3 and 395 rays of
  64 and 192 samples, a repeat bit for bit, and its rows 3-5 against the
  plain compositing of #1's heads), the mip render with `use_pdf_kernel`
  and `disable_normals=false` (6n and #9; its peak memory), and both
  one-pass steps with `use_pdf_kernel` through the train CLI;
* the row-major kernels #10 / #11 at the two-call step's shapes and
  #15 / #16 at the mip level (against their plain versions and the
  transposed kernels; in bf16 #10 / #15 run #1's / #6's walk and #11 /
  #16 the level walk of #2 / #7, and each gives its twin's bits and a
  repeat's), #11 and #16 at the ragged sizes of #2 (#16 also bit for bit
  #7's), #16's peak memory, the op `fused_mip_mlp_train` (one launch
  each);
* the two-call fused step: the flagship with `softLpmask` through the
  train CLI for each `fused_kernel` (v2: #1/#2, v2row: #10/#11, v2h: the
  plain forward and #11), guarded against the eager step and, at the
  hardmask flagship, against the one-pass step; the v2row render (#10,
  and its time a launch at the render chunk's shapes);
* the mip two-call step (disp metrics) and the one-pass mip step, both
  with the RegNeRF TV norm on 2048 random-pose rays and near/far
  annealing, through the train CLI, guarded against the eager step;
* the v1 kernels: #12 at the render's chunk shapes and, at a small size,
  with a skip into the heads, the use_viewdirs=False output head and
  multires 21; #13 / #14 at the two-call step's levels (#12 / #13 in bf16
  at 8x256 on #10's walk, bit for bit #10's and a repeat's; #14 in bf16 on
  the level walk: bit-identical across repeats and to #11 on the same
  points), #14 at the ragged sizes and at the small v1 shapes with the
  plan each picks; the v1 and hybrid renders (#12 for every chunk); the
  two-call step with fused_kernel=v1 (#13, #14) and hybrid (#14) through
  the train CLI, timed and guarded against the eager step; and the
  reprojection hard masks on the card against the CPU. The train CLI
  computes the hard masks on the card in every hardmask phase.

Each kernel is held against its plain PyTorch version at the shapes its
path gives it, in bf16 and fp32 (the one-pass levels #3 and #5 and the
weight grads #2, #7, #11, #14 and #16, whose dW sums take a fixed order,
and #1 also against a second bf16 launch, bit for bit); the plans of the
weight grads on the level walk (#2, #7, #11, #14, #16) are printed after
the build, and the bf16 plans of #11 and #14 at the two-call step's
levels and of #16 at the mip level must pick the walk; the kernel train
step is
held against the plain eager step from the same state, batch and draws;
timings, and each timed step's peak device memory, are printed beside
the card's name and power limit. The last line is
`{"ok": true, "device": {...}}`; any failure exits non-zero before it.
Imports torch and the port only (no jax, nothing of consistentnerf_tpu).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense tensor-core bf16
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
CHUNK = 8192  # render_chunk_size of the bench config
BF16_TOL = 2e-2  # max|kernel - plain| / mean|plain|: sum-order flips of bf16
FP32_TOL = 1e-4  # the same at fp32: only the order of fp32 sums differs
RENDER_RGB_TOL = 2e-3  # mean |rgb(kernel) - rgb(plain)| over one view
# Train kernels vs their plain versions (autograd through _mlp_body): the
# largest ||dW(kernel) - dW(plain)|| / ||dW(plain)|| over the grad
# tensors. fp32: only the order of the sums differs. bf16: the kernels
# round where the JAX kernels round (bf16 cotangents into every product,
# fp32 bias sums), while autograd through the plain version rounds each
# cotangent at its casts and the final dW to bf16; a flipped rounding
# travels down the layers.
TRAIN_DW_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# One-pass output rows, each of rgb (3), depth, acc and w on its own:
# max |kernel - plain| / max |plain|. fp32: sum order; bf16: the forward's
# rounding flips (as for the render), measured at 5.5e-4 absolute on an
# H100 over all rows, ~1e-1 of a mean fine-level weight (1/192).
ROWS_TOL = {"bfloat16": 5e-3, "float32": 1e-4}
ROW_NAMES = ("r", "g", "b", "depth", "acc", "w")
# Step guard, kernel step vs plain eager step after one bf16 step from the
# same state, batch and draws: |loss difference| / loss, and the largest
# ||grad(kernel) - grad(eager)|| / ||grad(eager)|| over the parameters,
# read before the optimizer's update (Adam's first step moves every
# parameter by ~lr whatever the scale of its grad, so the update alone
# cannot show a wrong scale). The grads add the two kernels' dW, each
# within TRAIN_DW_TOL of its plain version.
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 5e-2
TRAIN_STEPS = 3  # CLI steps before the checkpoint; the resume adds 2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


GATE_FAILURES = []


def gate(ok: bool, msg: str) -> None:
    """A tolerance gate: the run goes on to report everything, then fails
    before its result lines if any gate failed."""
    if not ok:
        print(f"chip_smoke GATE FAILED: {msg}", file=sys.stderr, flush=True)
        GATE_FAILURES.append(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def enc_widths(multires, multires_views, ipe=False):
    """(point, view) encoding widths: the NeRFMLP's torch-Embedder PE, or
    the MipMLP's IPE (6 features per frequency, no identity)."""
    ve = 3 * (1 + 2 * multires_views)
    return (6 * multires if ipe else 3 * (1 + 2 * multires)), ve


def mlp_flops_per_point(net_depth, width, skips, multires, multires_views,
                        ipe=False, view_width=None):
    """FLOPs of one point through the MLP (2 per multiply-add)."""
    pe, ve = enc_widths(multires, multires_views, ipe)
    hv = view_width or width // 2
    macs = pe * width
    for i in range(1, net_depth):
        macs += (width + pe if i - 1 in skips else width) * width
    macs += width * 1 + width * width + (width + ve) * hv + hv * 3
    return 2 * macs


def mlp_train_flops_per_point(net_depth, width, skips, multires,
                              multires_views, ipe=False, view_width=None):
    """FLOPs of one point through the train kernels' work: the forward,
    dW of every layer, and the input gradient of every layer except where
    the kernels skip it (layer 0 and the skip layer's PE input, the views
    layer's view-encoding input: nothing upstream needs those)."""
    pe, ve = enc_widths(multires, multires_views, ipe)
    hv = view_width or width // 2
    fwd = mlp_flops_per_point(net_depth, width, skips, multires,
                              multires_views, ipe, view_width) // 2
    skipped = pe * width * (1 + sum(1 for i in range(1, net_depth)
                                    if i - 1 in skips)) + ve * hv
    return 2 * (2 * fwd + fwd - skipped)


def bound_ms(n_points, flops_pp, weight_bytes, peak_flops, bytes_pp=40):
    """Least time for one launch: operations over the peak rate, against
    bytes (bytes_pp per point, by default 6 floats in and 4 out; the
    weights, and any grads written, once) over the memory rate. Returns
    (ms, 'operations' | 'bytes')."""
    t_ops = n_points * flops_pp / peak_flops
    t_bytes = (bytes_pp * n_points + weight_bytes) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn):
    """Device time of one call under torch.profiler: (total ms, the top
    kernels as (name, ms, count)), or (None, []) without device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((e.key[:60], us / 1e3, e.count))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:6]


def peak_memory(label):
    """Logs the peak of torch.cuda.max_memory_allocated since the last
    reset (torch.cuda.reset_peak_memory_stats) and resets it."""
    log(f"{label}: peak torch.cuda.max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()


# The ragged sizes of the weight-grad kernels #2, #7, #11 and #14: one
# point, a 64-row sub-tile less one and plus one, a 768-point chunk plus
# one, 4 chunks with a ragged last one, and the one-pass step's fine patch
# launch less one point. Where a chunk ends inside a sub-tile, its
# padded rows hold activations (bias through ReLU) and must meet a zero
# cotangent.
RAGGED_BWD_N = (1, 63, 65, 769, 3000, 196_607)


def ragged_bwd_gates(name, packed, streams, kfn, plain, dev, row=False,
                     twin=None):
    """#2, #7, #11, #14 or #16 at RAGGED_BWD_N against its plain version,
    in bf16 and fp32 (dW rel L2 under TRAIN_DW_TOL), and a second bf16
    launch bit for bit. `packed(dtype)` packs the weights; `streams(n,
    gen)` makes the seeded inputs; kfn / plain take (w, *streams, g,
    dtype); g is [4, N], or [N, 4] with `row`. `twin`: (its kernel's name,
    a function of kfn's arguments that runs it on the same points), whose
    bf16 bits the kernel must give."""
    gen = torch.Generator(device=dev).manual_seed(11)
    for n in RAGGED_BWD_N:
        xs = streams(n, gen)
        g = 1e-3 * torch.randn((n, 4) if row else (4, n), generator=gen,
                               device=dev)
        for dtype in ("bfloat16", "float32"):
            w = packed(dtype)
            got = kfn(w, *xs, g, dtype)
            torch.cuda.synchronize()
            rel, mx = grads_err(got, plain(w, *xs, g, dtype))
            log(f"{name} vs plain, ragged N={n} {dtype}: dW max|diff| "
                f"{mx:.3e}, max rel L2 {rel:.3e} (tol "
                f"{TRAIN_DW_TOL[dtype]:g})")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"{name} N={n} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype], f"{name} N={n} {dtype} disagrees "
                 f"with its plain version ({rel:.3e})")
            if dtype == "bfloat16":
                repeat_gate(f"{name} N={n}", got, kfn(w, *xs, g, dtype))
            if dtype == "bfloat16" and twin:
                same = all(torch.equal(a, b) for a, b in zip(
                    got, twin[1](w, *xs, g, dtype)))
                log(f"{name} N={n} bf16: bit-identical to {twin[0]} on the "
                    f"same points {same}")
                gate(same, f"{name} N={n} bf16: other bits than {twin[0]}")
        del xs, g
        torch.cuda.empty_cache()


def row_nerf_streams(n_pts, gen):
    """Seeded row-major NeRF streams for the ragged gates of #11 and #14:
    points [n, 3] in [-2, 2) and unit view directions [n, 3]."""
    pts = torch.rand((n_pts, 3), generator=gen, device=gen.device) * 4 - 2
    views = torch.randn((n_pts, 3), generator=gen, device=gen.device)
    return pts, views / views.norm(dim=1, keepdim=True)


def row_mip_streams(n_pts, gen):
    """Seeded row-major mip streams for the ragged gates of #16: means
    [n, 3] in [-1.5, 1.5), diagonal covariances [n, 3] in [0, 1e-4) and
    unit view directions [n, 3]."""
    means = torch.rand((n_pts, 3), generator=gen, device=gen.device) * 3
    covs = torch.rand((n_pts, 3), generator=gen, device=gen.device) * 1e-4
    views = torch.randn((n_pts, 3), generator=gen, device=gen.device)
    return means - 1.5, covs, views / views.norm(dim=1, keepdim=True)


def rel_err(got, want):
    diff = (got - want).abs()
    return diff.max().item() / want.abs().mean().item(), diff.max().item()


def level_plan_text(out):
    """The nine slots of a level plan (#2, #3, #5, #7), in words."""
    ws_bytes = out[1] * (2 if out[5] else 4)
    text = (f"{out[3]} bytes of shared memory, {out[0]} blocks, chunks of "
            f"{out[4]} points, workspace {ws_bytes / 2 ** 30:.2f} GiB")
    if out[8]:
        text += (f", the level walk and a dW GEMM of {out[5]} splits of "
                 f"{out[7]} 64-point slabs")
    return text


def fwd_plan_text(plan):
    """A forward plan (#1, #6; fused_mlp_v2.PLAN_SLOTS), in words."""
    if not plan["hopper"]:
        return (f"mlp_fwd.cuh's walk: {plan['tiles']} blocks of "
                f"{plan['tile']} points, {plan['smem_bytes']} bytes of "
                "shared memory")
    return (f"the Hopper walk: {plan['blocks']} persistent blocks over "
            f"{plan['tiles']} tiles of {plan['tile']} points, a "
            f"{plan['stages']}-slot weight ring, {plan['pe_buffers']} pe "
            f"buffer(s), cluster {plan['cluster']}, {plan['smem_bytes']} "
            "bytes of shared memory")


def ptxas_report(_build, name):
    """Registers, spills and stack of each kernel in a build log."""
    entry = None
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = ("bf16" if "bfloat16" in mangled else
                     "fp32" if "reduce" not in mangled else "reduce")
            if "fwd_hopper_kernel" in mangled:
                args = re.findall(r"Li(\d+)E", mangled.split("Enc")[1])
                entry = (f"bf16 Hopper walk {args[0]}x64 / {args[1]}x64"
                         + ("", " normals tail", " render tail")[
                             int(args[2])])
            if "RowMajor" in mangled:
                entry += " row-major"
            if "dw_gemm" in mangled:
                entry = "dW GEMM"
            elif (("level_kernel" in mangled or "bwd_kernel" in mangled)
                  and "bfloat16" in mangled):
                entry += " level walk" if "Lb1E" in mangled else " legacy"
        elif "Used" in line or "spill" in line:
            log(f"  {name} [{entry}]: {line.strip()}")


def repeat_gate(label, first, again):
    """A second launch of a kernel whose sums take a fixed order (#3, #5:
    rows and dW; #2, #7: dW) gives the first one's bits: every tensor of
    `first` against `again` (tensors, or nested sequences of them)."""
    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [
            t for y in x for t in flat(y)]
    same = all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))
    log(f"{label} bf16 repeat: bit-identical {same}")
    gate(same, f"{label} bf16: a second launch gave other bits")


def grads_err(got, want):
    """(largest ||g - w|| / ||w|| over the tensors, largest |g - w|)."""
    rel = max((torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(
        1e-30)).item() for a, b in zip(got, want))
    mx = max((a - b).abs().max().item() for a, b in zip(got, want))
    return rel, mx


def guard_steps(label, kernel_step, eager_step, state, batch, draws=None):
    """The step guard: one step of the kernel step and one of the eager
    step from copies of `state`, with the same batch and draws. Gates the
    loss and the grads that the optimizer's update reads (Adam's first
    step moves every parameter by ~lr whatever the scale of its grad, so
    the update alone cannot show a wrong scale). Returns the kernel's and
    the eager step's (state, stats)."""
    import copy

    def grads_at_update(st):
        """Copies of the grads that the optimizer's next update reads."""
        opt, grads = st.optimizer, []
        update = opt.step

        def step(count):
            grads.extend(torch.zeros_like(q) if q.grad is None else
                         q.grad.detach().clone() for q in opt.params)
            update(count)

        opt.step = step
        return grads

    k_state, e_state = copy.deepcopy(state), copy.deepcopy(state)
    grads_k, grads_e = grads_at_update(k_state), grads_at_update(e_state)
    out_k = kernel_step(k_state, batch, draws)
    out_e = eager_step(e_state, batch, draws)
    torch.cuda.synchronize()
    st_k, st_e = out_k[1], out_e[1]
    grad_rel, _ = grads_err(grads_k, grads_e)
    norm_rel = abs(float(st_k["grad_norm"]) / float(st_e["grad_norm"]) - 1)
    d_loss = abs(float(st_k["loss"]) - float(st_e["loss"]))
    log(f"{label}: loss kernel {float(st_k['loss']):.6f} eager "
        f"{float(st_e['loss']):.6f}, |dloss| {d_loss:.3e}; grads max rel "
        f"L2 over the {len(grads_e)} parameters {grad_rel:.3e}, grad norm "
        f"kernel {float(st_k['grad_norm']):.6e} eager "
        f"{float(st_e['grad_norm']):.6e} (rel {norm_rel:.3e}; tol "
        f"{STEP_GRAD_TOL:g})")
    gate(d_loss < STEP_LOSS_TOL * abs(float(st_e["loss"])),
         f"{label}: kernel step loss disagrees with the eager step "
         f"({d_loss})")
    gate(grad_rel < STEP_GRAD_TOL and norm_rel < STEP_GRAD_TOL,
         f"{label}: kernel step grads disagree with the eager step "
         f"({grad_rel:.3e})")
    return out_k, out_e


def main() -> None:
    global torch
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    try:
        from consistentnerf_tpu_torch import configs
        from consistentnerf_tpu_torch.ops import _build
        from consistentnerf_tpu_torch.ops import fused_mlp as fm
        from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
        from consistentnerf_tpu_torch.ops import fused_onepass as op
    except ImportError as e:
        fail(f"the port is not importable from here ({e}); run this "
             "script from the root of a checkout")

    # 1. Device.
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else f"{name}, power limit not read"
    log(f"device: {name} (count {count}); nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    fm.strict_fp32(dev)

    # 2. Build every kernel from the checkout's sources, in parallel.
    from consistentnerf_tpu_torch.ops import fused_mip as fmip

    from consistentnerf_tpu_torch.ops import pdf_merge

    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt

    names = [v2.KERNEL, v2.BWD_KERNEL, op.KERNEL, fmip.KERNEL,
             fmip.BWD_KERNEL, op.MIP_KERNEL, op.RENDER_KERNEL,
             pdf_merge.KERNEL, pdf_merge.MIP_KERNEL, fm.KERNEL,
             fmt.BWD_KERNEL]
    t0 = time.perf_counter()
    _build.build_all(names)
    log(f"built {', '.join(n + '.cu' for n in names)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s; ptxas:")
    for n in names:
        ptxas_report(_build, n)
    smem = _build.load(v2.KERNEL).fused_mlp_fwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_int
    log("  dynamic shared memory per block at 8x256, multires 10/4: "
        f"{v2.KERNEL} bf16 {smem(256, 10, 4, 1)} bytes, fp32 "
        f"{smem(256, 10, 4, 0)} bytes")
    smem1 = _build.load(fm.KERNEL).fused_mlp_v1_fwd_smem_bytes
    smem1.argtypes, smem1.restype = [ctypes.c_int] * 4, ctypes.c_int
    plan1 = _build.load(fmt.BWD_KERNEL).fused_mlp_v1_bwd_plan
    plan1.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for mr in (10, 21):
        for bf, dt in ((1, "bfloat16"), (0, "float32")):
            out = (ctypes.c_longlong * 9)()
            if plan1(983040, 8, 256, 16, mr, 4, bf, out):
                fail(f"{fmt.BWD_KERNEL}_plan failed at multires {mr}")
            packed = fm.pack_v1(fm.flatten_params(NeRFMLP(
                input_ch=3 * (1 + 2 * mr))), 8, (4,), mr, 4, dt)
            # #14's own shared memory: the level walk's where its plan
            # runs it (slot 8), else train_block's.
            want = (fm.v1_smem_bytes(packed)[0],
                    fm.walk_smem_bytes(packed, -(-out[4] // 64) * 64)
                    if out[8] else fm.v1_smem_bytes(packed)[1])
            got = (smem1(256, mr, 4, bf), out[3])
            log(f"  v1 kernels at 8x256, multires {mr}/4, {dt}: "
                f"{fm.KERNEL} {got[0]} bytes of shared memory, "
                f"{fmt.BWD_KERNEL} {got[1]} bytes "
                f"({'the level walk' if out[8] else 'train_block'}), "
                f"{out[0]} blocks (the wrappers' plan: {want[0]}, {want[1]})")
            if tuple(got) != tuple(want):
                fail("the v1 wrappers' shared-memory plan disagrees with "
                     "the kernels'")
    plan_b = _build.load(v2.BWD_KERNEL).fused_mlp_bwd_plan
    plan_b.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    # #11 and #14 beside #2 at the two-call step's levels: in bf16 all
    # three run the level walk (slot 8), #11 and #14 with the row-major
    # staging; in fp32 train_block.
    plan_r = _build.load(v2.BWD_KERNEL).fused_mlp_bwd_row_plan
    plan_r.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for bf in (1, 0):
        for n_b in (983040, 327680):
            for label, fn in (("#2 " + v2.BWD_KERNEL, plan_b),
                              ("#11 " + v2.ROW_BWD_KERNEL, plan_r),
                              ("#14 " + fmt.BWD_KERNEL, plan1)):
                out = (ctypes.c_longlong * 9)()
                if fn(n_b, 8, 256, 16, 10, 4, bf, out):
                    fail(f"the plan of {label} failed")
                log(f"  {'bf16' if bf else 'fp32'}: {label} ({n_b} points) "
                    f"{level_plan_text(out)}")
                if bf and not out[8]:
                    fail(f"the bf16 plan of {label} at {n_b} points is not "
                         "the level walk")
    # #16 beside #7 at the mip level (MIP_LEVEL_N points, 8x256, 16 IPE
    # frequencies): in bf16 both run the level walk, #16 with the
    # row-major staging (9 x 64 floats more shared memory, the wrappers'
    # figure); in fp32 train_block.
    mpk = fmip.pack(fmip.flatten_mip_params(MipMLP()), 8, 16, "bfloat16")
    mcfg_args = fmip._cfg_args(mpk)[:-1]
    for bf in (1, 0):
        outs = {}
        for label, sym in (("#7 " + fmip.BWD_KERNEL, fmip.BWD_KERNEL),
                           ("#16 " + fmip.ROW_BWD_KERNEL,
                            fmip.ROW_BWD_KERNEL)):
            fn = _build.load(fmip.BWD_KERNEL)[sym + "_plan"]
            fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
            out = (ctypes.c_longlong * 9)()
            if fn(MIP_LEVEL_N, *mcfg_args, bf, out):
                fail(f"the plan of {label} failed")
            outs[sym] = list(out)
            log(f"  {'bf16' if bf else 'fp32'}: {label} ({MIP_LEVEL_N} "
                f"points, mip 8x256, 16 frequencies) {level_plan_text(out)}"
                f"; slot 8 (the level walk) {out[8]}")
        p16, p7 = outs[fmip.ROW_BWD_KERNEL], outs[fmip.BWD_KERNEL]
        gate(p16[8] == bf, f"the {'bf16' if bf else 'fp32'} plan of #16 "
             f"has slot 8 = {p16[8]}")
        if bf:
            want = fm.walk_smem_bytes(mpk, -(-p16[4] // 64) * 64)
            log(f"  #16 bf16 shared memory {p16[3]} bytes = #7's {p7[3]} + "
                f"{p16[3] - p7[3]} (the wrappers' plan: {want})")
            gate(p16[3] == want == p7[3] + 9 * 64 * 4 and
                 p16[:3] + p16[4:] == p7[:3] + p7[4:],
                 "#16's bf16 plan is not #7's with the row-major staging")
    plan_o = _build.load(op.KERNEL).onepass_level_plan
    plan_o.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for bf in (1, 0):
        for n_b in (196608, 65536):
            out = (ctypes.c_longlong * 9)()
            plan_b(n_b, 8, 256, 16, 10, 4, bf, out)
            log(f"  {'bf16' if bf else 'fp32'}: {v2.BWD_KERNEL} ({n_b} "
                f"points) {level_plan_text(out)}")
        for seg in (192, 64):
            outo = (ctypes.c_longlong * 9)()
            plan_o(4096, seg, 8, 256, 16, 10, 4, bf, outo)
            log(f"  {'bf16' if bf else 'fp32'}: {op.KERNEL} (4096 x {seg})"
                f" {level_plan_text(outo)}")
    plan_mb = _build.load(fmip.BWD_KERNEL).fused_mip_bwd_plan
    plan_mb.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plan_mo = _build.load(op.MIP_KERNEL).onepass_mip_level_plan
    plan_mo.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    for bf in (1, 0):
        out, outo = (ctypes.c_longlong * 9)(), (ctypes.c_longlong * 9)()
        plan_mb(98304, 8, 256, 128, 16, 16, 4, bf, out)
        plan_mo(3072, 96, 8, 256, 128, 16, 16, 4, bf, outo)
        log(f"  {'bf16' if bf else 'fp32'}: {fmip.BWD_KERNEL} (98304 "
            f"points) {level_plan_text(out)}; {op.MIP_KERNEL} (3072 x 96) "
            f"{level_plan_text(outo)}")

    tail_plans(fm, v2, fmip, op)

    t_phase = time.perf_counter()
    fwd_walk_phases(dev, fm, v2, fmip)
    log(f"forward walk phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    render = render_phases(dev, card, configs, fm, v2)
    train = train_phases(dev, card, configs, fm, v2, op)
    log(f"vanilla phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    mip_render = mip_render_phases(dev, card, configs, fm, fmip)
    mip_train = mip_train_phases(dev, card, configs, fm, fmip, op)
    log(f"mip phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    switched = switched_vanilla_phases(dev, card, configs, fm, v2, op,
                                       pdf_merge, render["render_ms"])
    mip_switched = switched_mip_phases(dev, card, configs, fm, fmip, op,
                                       pdf_merge, mip_render["render_ms"])
    log(f"switched phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    row = rowmajor_kernel_phases(dev, card, configs, fm, v2, fmip, op)
    twocall = twocall_phases(dev, card, configs, fm, v2, op,
                             render["render_ms"])
    mip_tv_phases(dev, card, configs, fm, fmip, op)
    log(f"two-call and TV phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    v1 = v1_phases(dev, card, configs, fm, v2, op, render["render_ms"],
                   twocall["step_ms"])
    log(f"v1 phases: {time.perf_counter() - t_phase:.1f} s")
    row_json = row["json"]
    for r in row_json[:2]:
        r["launches"] = twocall["launches"][r["name"]]

    kernels = {"kernels": [
        dict(name=v2.KERNEL, route="cuda",
             source="consistentnerf_tpu_torch/csrc/fused_mlp_fwd.cu",
             replaces="consistentnerf_tpu/ops/fused_mlp_v2.py:578",
             launches=render["launches"] + train["launches"][v2.KERNEL],
             **render["json"]),
    ] + train["json"] + [
        dict(name=fmip.KERNEL, route="cuda",
             source="consistentnerf_tpu_torch/csrc/fused_mip_fwd.cu",
             replaces="consistentnerf_tpu/ops/fused_mip.py:597",
             launches=(mip_render["launches"]
                       + mip_train["launches"][fmip.KERNEL]),
             **mip_render["json"]),
    ] + mip_train["json"] + [
        switched["json"][op.RENDER_KERNEL], mip_switched["json"],
        switched["json"][pdf_merge.KERNEL], mip_switched["mip_json"]]
        + row_json + v1["json"]}
    if GATE_FAILURES:
        fail(f"{len(GATE_FAILURES)} gate(s) failed: {GATE_FAILURES}")
    log(json.dumps(kernels))
    log(f"nvidia-smi: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


# The ragged sizes of #1 and #6: one point, a tile less one, a tile and
# one, and a tile count that leaves the persistent grid's last wave half
# empty (132 + 66 tiles on an H100, the last one ragged).
RAGGED_N = (1, 127, 129, 198 * 128 - 50)
# The mip two-call step's level: 4096 rays (3072 random + 4x16x16 MiDaS
# patch rays) x 96 samples, where #15 / #16 run.
MIP_LEVEL_N = 4096 * 96
# Points of the two-call step's fine level (5120 rays x 192 samples).
TWOCALL_FINE = 5120 * 192


def normals_plan_text(plan):
    """6n's plan (fused_mip.NORMALS_PLAN_SLOTS) in words."""
    if plan["hopper"]:
        return (fwd_plan_text(plan) + ", the masks in registers, no "
                "workspace")
    return (f"mode 5 (mlp_train.cuh): {plan['blocks']} blocks over "
            f"{plan['tiles']} chunks of {plan['tile']} points, "
            f"{plan['smem_bytes']} bytes of shared memory, a workspace of "
            f"{plan['workspace']} elements")


def render_plan_text(plan):
    """#4's plan (fused_onepass.RENDER_PLAN_SLOTS) in words."""
    if plan["hopper"]:
        return (f"the Hopper walk with the compositing tail: "
                f"{plan['blocks']} persistent blocks over {plan['groups']} "
                f"groups of {plan['group_points']} points ("
                f"{plan['group_tiles']} tiles, {plan['group_rays']} rays), "
                f"a {plan['stages']}-slot weight ring, "
                f"{plan['smem_bytes']} bytes of shared memory")
    return (f"the old kernel (mlp_fwd.cuh): {plan['blocks']} blocks of "
            f"{plan['group_rays']} rays ({plan['group_points']} points), "
            f"{plan['smem_bytes']} bytes of shared memory")


def tail_plans(fm, v2, fmip, op):
    """The plans of 6n (the render chunk, 786,432 points) and #4 (the fine
    and the coarse render chunk, 8192 x 192 and 8192 x 64), decided by
    shapes alone: in bf16 both run the Hopper walk with their tails
    (csrc/fwd_hopper.cuh), 6n with no workspace, #4 with the shared memory
    of the wrappers' mirror (fused_onepass.render_smem_bytes); fp32 keeps
    mode 5 and the old kernel."""
    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP

    mip = fmip.flatten_mip_params(MipMLP(net_depth=8, net_width=256))
    nerf = fm.flatten_params(NeRFMLP())
    for dt in ("bfloat16", "float32"):
        bf = dt == "bfloat16"
        plan = fmip.normals_plan(fmip.pack(mip, 8, 16, dt), CHUNK * 96)
        log(f"plan of 6n {dt}, render chunk ({CHUNK * 96} points): "
            f"{normals_plan_text(plan)}")
        gate(plan["hopper"] == int(bf) and (plan["workspace"] == 0) == bf,
             f"the {dt} plan of 6n picked "
             f"{'the Hopper walk' if plan['hopper'] else 'mode 5'}")
        packed = v2.pack(nerf, 8, (4,), 10, 4, dt)
        for seg in (192, 64):
            plan = op.render_plan(packed, CHUNK, seg)
            log(f"plan of #4 {dt}, {CHUNK} x {seg}: "
                f"{render_plan_text(plan)}")
            want = op.render_smem_bytes(packed, seg)
            gate(plan["hopper"] == int(bf) and (not bf or (
                plan["smem_bytes"], plan["stages"]) == want[:2]),
                f"the {dt} plan of #4 at S={seg} picked "
                f"{'the Hopper walk' if plan['hopper'] else 'the old kernel'}"
                f" (shared memory {plan['smem_bytes']}, the mirror's {want})")


def normals_gates(label, fmip, packed, packed32, means, covs, views, kw):
    """6n on the same points in bf16 (the Hopper walk) and fp32 (mode 5):
    bf16 rows 0-3 bit-identical to #6, a second launch bit-identical,
    rows 4-6 under normals_bf16_gate; fp32 rows 0-3 under mip_fwd_gate and
    rows 4-6 each within NORMALS_FP32_TOL of the row's largest value.
    Returns the bf16 max|diff| against the plain version."""
    with torch.no_grad():
        got = fmip.fused_mip_mlp_normals_T(packed, means, covs, views,
                                           compute_dtype="bfloat16", **kw)
        torch.cuda.synchronize()
        again = fmip.fused_mip_mlp_normals_T(packed, means, covs, views,
                                             compute_dtype="bfloat16", **kw)
        six = fmip.fwd_T(packed, means, covs, views,
                         compute_dtype="bfloat16", **kw)
        got32 = fmip.fused_mip_mlp_normals_T(packed32, means, covs, views,
                                             compute_dtype="float32", **kw)
        torch.cuda.synchronize()
        want = fmip.plain_fwd_normals_T(packed, means, covs, views,
                                        compute_dtype="bfloat16", **kw)
        want32 = fmip.plain_fwd_normals_T(packed32, means, covs, views,
                                          compute_dtype="float32", **kw)
    m = min(means.shape[1], NORMALS_HOST_POINTS)
    host = fmip.plain_fwd_normals_T(
        fmip.pack([x.cpu() for x in packed.flat], kw["net_depth"],
                  kw["num_freqs"], "bfloat16"),
        *[x[:, :m].cpu() for x in (means, covs, views)],
        compute_dtype="bfloat16", **kw)
    for x, dt in ((got, "bf16"), (got32, "fp32")):
        if not torch.isfinite(x).all():
            fail(f"{label} {dt}: non-finite output")
    same6, rep_ = torch.equal(got[:4], six), torch.equal(got, again)
    log(f"{label} bf16: rows 0-3 bit-identical to {fmip.KERNEL} {same6}; "
        f"a second launch bit-identical {rep_}")
    gate(same6, f"{label} bf16 rows 0-3 are not {fmip.KERNEL}'s bits")
    gate(rep_, f"{label} bf16: a second launch gave other bits")
    normals_bf16_gate(f"{label} bf16", got, want, want32, host)
    mip_fwd_gate(f"{label} fp32, rows 0-3", got32[:4], want32[:4],
                 "float32")
    rows = row_max_rel(got32[4:], want32[4:])
    log(f"{label} fp32 rows 4-6: per row max|diff|/max|plain| {rows:.3e} "
        f"(tol {NORMALS_FP32_TOL:g})")
    gate(rows < NORMALS_FP32_TOL, f"{label} fp32 rows 4-6 disagree "
         f"({rows:.3e})")
    return (got - want).abs().max().item()


def fwd_walk_phases(dev, fm, v2, fmip):
    """The Hopper walk of #1, #6, #10, #12 / #13 and #15
    (csrc/fwd_hopper.cuh): the shape-decided plans (in bf16 #1, #6, #10,
    #12 / #13 and #15 at 8x256 take the walk; fp32 and v1's shapes past
    #1's keep mlp_fwd.cuh's walk), and the kernels at the ragged sizes in
    bf16 against their plain versions (the render chunk's gates) and bit
    for bit: #10 against #1 and #15 against #6 (two layouts of one walk),
    #12 and #13 against #10 (one instance of it), and a repeat of each
    against its first launch."""
    from consistentnerf_tpu_torch.models.mlp import MipMLP, NeRFMLP
    from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt

    mlp = NeRFMLP(net_depth=8, net_width=256)
    mlp.reset_parameters(torch.Generator().manual_seed(1))
    flat = [w.detach().to(dev) for w in fm.flatten_params(mlp)]
    mip = MipMLP(net_depth=8, net_width=256)
    mip.reset_parameters(torch.Generator().manual_seed(1))
    mflat = [w.detach().to(dev) for w in fmip.flatten_mip_params(mip)]
    nerf_kw = dict(net_depth=8, skips=(4,), multires=10, multires_views=4)
    mip_kw = dict(net_depth=8, num_freqs=16)
    for label, plan in (
            ("#1 bf16, fine render chunk", v2.fwd_plan(
                v2.pack(flat, compute_dtype="bfloat16", **nerf_kw),
                CHUNK * 192)),
            ("#1 bf16, coarse render chunk", v2.fwd_plan(
                v2.pack(flat, compute_dtype="bfloat16", **nerf_kw),
                CHUNK * 64)),
            ("#1 fp32, fine render chunk", v2.fwd_plan(
                v2.pack(flat, compute_dtype="float32", **nerf_kw),
                CHUNK * 192)),
            ("#10 bf16 (row-major), fine render chunk", v2.fwd_plan(
                v2.pack(flat, compute_dtype="bfloat16", **nerf_kw),
                CHUNK * 192, row=True)),
            ("#10 bf16 (row-major), two-call fine level", v2.fwd_plan(
                v2.pack(flat, compute_dtype="bfloat16", **nerf_kw),
                TWOCALL_FINE, row=True)),
            ("#10 fp32 (row-major), fine render chunk", v2.fwd_plan(
                v2.pack(flat, compute_dtype="float32", **nerf_kw),
                CHUNK * 192, row=True)),
            ("#12 bf16 (v1), fine render chunk", fm.fwd_plan(
                fm.pack_v1(flat, compute_dtype="bfloat16", **nerf_kw),
                CHUNK * 192)),
            ("#13 bf16 (v1), two-call fine level", fm.fwd_plan(
                fm.pack_v1(flat, compute_dtype="bfloat16", **nerf_kw),
                TWOCALL_FINE)),
            ("#12 fp32 (v1), fine render chunk", fm.fwd_plan(
                fm.pack_v1(flat, compute_dtype="float32", **nerf_kw),
                CHUNK * 192)),
            ("#6 bf16, render chunk", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "bfloat16"), CHUNK * 96)),
            ("#6 fp32, render chunk", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "float32"), CHUNK * 96)),
            ("#15 bf16 (row-major), mip level", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "bfloat16"), MIP_LEVEL_N,
                row=True)),
            ("#15 fp32 (row-major), mip level", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "float32"), MIP_LEVEL_N,
                row=True))):
        log(f"plan of {label}: {fwd_plan_text(plan)}")
        want_hopper = "bf16" in label
        gate(plan["hopper"] == int(want_hopper), f"the plan of {label} "
             f"picked the {'Hopper' if plan['hopper'] else 'legacy'} walk")
    # v1's shapes past #1's keep mlp_fwd.cuh's walk in bf16 too.
    for label, (depth, sk, mr, mv, uv) in V1_SHAPES.items():
        m = NeRFMLP(net_depth=depth, net_width=256, input_ch=3 * (1 + 2 * mr),
                    input_ch_views=3 * (1 + 2 * mv), skips=sk,
                    use_viewdirs=uv, output_ch=5)
        ws = [x.detach().to(dev) for x in fm.flatten_params(m, uv, depth)]
        plan = fm.fwd_plan(fm.pack_v1(ws, depth, sk, mr, mv, "bfloat16",
                                      use_viewdirs=uv), V1_SMALL_N)
        log(f"plan of #12 bf16 (v1), {label} (depth {depth}, multires {mr}, "
            f"{V1_SMALL_N} points): {fwd_plan_text(plan)}")
        gate(plan["hopper"] == 0, f"the plan of #12 at {label} picked the "
             "Hopper walk")

    packed = v2.pack(flat, compute_dtype="bfloat16", **nerf_kw)
    packed1 = fm.pack_v1(flat, compute_dtype="bfloat16", **nerf_kw)
    mpacked = fmip.pack(mflat, 8, 16, "bfloat16")
    mpacked32 = fmip.pack(mflat, 8, 16, "float32")
    for n in RAGGED_N:
        g = torch.Generator().manual_seed(0)
        pts = (torch.rand(3, n, generator=g) * 4 - 2).to(dev)
        views = torch.randn(3, n, generator=g)
        views = (views / views.norm(dim=0, keepdim=True)).to(dev)
        pts_r, views_r = pts.T.contiguous(), views.T.contiguous()
        with torch.no_grad():
            got = v2.fwd_T(packed, pts, views, compute_dtype="bfloat16",
                           **nerf_kw)
            torch.cuda.synchronize()
            want = v2.plain_fwd_T(packed, pts, views,
                                  compute_dtype="bfloat16", **nerf_kw)
            twin = v2.fwd(packed, pts_r, views_r, compute_dtype="bfloat16",
                          **nerf_kw)
        rel, mx = rel_err(got, want)
        same = torch.equal(got, twin.T)
        log(f"{v2.KERNEL} bf16 vs plain, N={n}: max|diff| {mx:.3e}, "
            f"max|diff|/mean|plain| {rel:.3e} (tol {BF16_TOL}); "
            f"bit-identical to {v2.ROW_KERNEL} (the same walk under the "
            f"row-major layout) {same}")
        gate(bool(torch.isfinite(got).all()) and rel < BF16_TOL,
             f"{v2.KERNEL} N={n} disagrees with its plain version ({rel})")
        gate(same, f"{v2.KERNEL} N={n}: other bits than {v2.ROW_KERNEL}")
        v1_bit_gates(f"N={n}", fm, fmt, v2, packed, packed1, pts_r, views_r,
                     twin, nerf_kw)
        g = torch.Generator().manual_seed(0)
        means = (torch.rand(3, n, generator=g) * 3 - 1.5).to(dev)
        covs = (torch.rand(3, n, generator=g) * 1e-4).to(dev)
        mviews = torch.randn(3, n, generator=g)
        mviews = (mviews / mviews.norm(dim=0, keepdim=True)).to(dev)
        with torch.no_grad():
            got = fmip.fwd_T(mpacked, means, covs, mviews,
                             compute_dtype="bfloat16", **mip_kw)
            torch.cuda.synchronize()
            want = fmip.plain_fwd_T(mpacked, means, covs, mviews,
                                    compute_dtype="bfloat16", **mip_kw)
            twin = fmip.fwd(mpacked, means.T.contiguous(),
                            covs.T.contiguous(), mviews.T.contiguous(),
                            compute_dtype="bfloat16", **mip_kw).T
        if not torch.isfinite(got).all():
            fail(f"{fmip.KERNEL} N={n}: non-finite output")
        mip_fwd_gate(f"{fmip.KERNEL} vs plain, N={n}", got, want,
                     "bfloat16")
        same = torch.equal(got, twin)
        log(f"{fmip.KERNEL} bf16 N={n}: bit-identical to {fmip.ROW_KERNEL} "
            f"(the same walk under the row-major layout) {same}")
        gate(same, f"{fmip.KERNEL} N={n}: other bits than "
             f"{fmip.ROW_KERNEL}")
        with torch.no_grad():
            again = fmip.fwd(mpacked, means.T.contiguous(),
                             covs.T.contiguous(), mviews.T.contiguous(),
                             compute_dtype="bfloat16", **mip_kw).T
        repeat_gate(f"{fmip.ROW_KERNEL} N={n}", [twin], [again])
        # 6n (#6's walk with the normals tail) on the same points.
        normals_gates(f"{fmip.NORMALS_KERNEL} N={n}", fmip, mpacked,
                      mpacked32, means, covs, mviews, mip_kw)


def v1_bit_gates(label, fm, fmt, v2, packed, packed1, pts, views, first,
                 kw):
    """At 8x256 in bf16, #10, #12 and #13 run one instance of the Hopper
    walk under the row-major layout: #12 and #13 on the v1 packing give
    #10's bits (`first`, #10 on pts / views [N, 3]), and a second launch
    of each gives its first one's."""
    with torch.no_grad():
        r12 = fm.fused_mlp(packed1, pts, views, compute_dtype="bfloat16",
                           **kw)
        r13 = fmt.forward(packed1, pts, views, compute_dtype="bfloat16", **kw)
        again = [v2.fwd(packed, pts, views, compute_dtype="bfloat16", **kw),
                 fm.fused_mlp(packed1, pts, views, compute_dtype="bfloat16",
                              **kw),
                 fmt.forward(packed1, pts, views, compute_dtype="bfloat16",
                             **kw)]
        torch.cuda.synchronize()
    same = (torch.equal(r12, first), torch.equal(r13, first))
    rep_ = [torch.equal(a, b) for a, b in zip((first, r12, r13), again)]
    log(f"#12 / #13 ({fm.KERNEL}) bf16, {label}: bit-identical to #10 "
        f"{same[0]} / {same[1]}; a second launch of #10 / #12 / #13 "
        f"bit-identical {rep_[0]} / {rep_[1]} / {rep_[2]}")
    gate(all(same), f"#12 / #13 {label}: other bits than #10 ({same})")
    gate(all(rep_), f"#10 / #12 / #13 {label}: a second launch gave other "
         f"bits ({rep_})")


def render_phases(dev, card, configs, fm, v2):
    """The render path: kernel vs plain on a chunk, the
    6-view render through the kernel, the render CLI, timings."""
    from consistentnerf_tpu_torch.cli import render as render_cli
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.ops import pdf_merge
    from consistentnerf_tpu_torch.train import evaluation
    from consistentnerf_tpu_torch.train import render as render_lib
    # The bench render configuration.
    cfg = configs.Config(
        N_samples=64, N_importance=128, white_bkgd=True,
        compute_dtype="bfloat16", render_chunk_size=CHUNK,
        use_fused_render=True,
    )
    skips = (4,)
    scene = synthetic.make_scene(n_views=6, H=128, W=128).to_scene_data()
    model = make_model(cfg, dev).eval()
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    n_rays = stacked.origins[..., 0].numel()

    def packed(level, dtype):
        return v2.pack(fm.flatten_params(getattr(model, level)),
                       cfg.netdepth, skips, cfg.multires,
                       cfg.multires_views, dtype)

    def call(fn, w, pts_T, views_T, dtype):
        return fn(w, pts_T, views_T, cfg.netdepth, skips, cfg.multires,
                  cfg.multires_views, dtype)

    # 3. Kernel vs plain on the main path's inputs: the first 8192-ray
    # chunk of view 0, coarse (64 samples) and fine (64 + 128) levels.
    chunk = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:CHUNK])
    n = chunk.origins.shape[0]

    def level_inputs(z_vals):
        s = z_vals.shape[1]
        pts_T = (chunk.origins.T[:, :, None] + chunk.directions.T[:, :, None]
                 * z_vals[None]).reshape(3, n * s)
        views_T = chunk.viewdirs.T[:, :, None].expand(3, n, s).reshape(
            3, n * s)
        return pts_T, views_T

    with torch.no_grad():
        z_c = sampling.vanilla_z_vals(chunk.near, chunk.far, cfg.N_samples,
                                      False, None)
        pc, vc = level_inputs(z_c)
        raw_c = call(v2.plain_fwd_T, packed("coarse", "bfloat16"), pc, vc,
                     "bfloat16")
        w_c = rendering.raw2outputs_T(raw_c.reshape(4, n, -1), z_c,
                                      chunk.directions, None, True)[3]
        z_f = pdf_merge.fine_z_vals(z_c, w_c, cfg.N_importance)
        pf, vf = level_inputs(z_f)
        n_fine, n_coarse = pf.shape[1], pc.shape[1]
        if n_fine != CHUNK * 192:
            fail(f"fine chunk has {n_fine} points, expected {CHUNK * 192}")

        # The gates are on the fine chunk. The coarse level is reported
        # only: its outputs' mean is smaller, so the same bf16 rounding
        # flips weigh more in max|diff| / mean|plain| (2.01e-2 on an H100).
        errs = {}
        for label, level, pts_T, views_T, dtype, tol in (
                ("fine bf16", "fine", pf, vf, "bfloat16", BF16_TOL),
                ("fine fp32", "fine", pf, vf, "float32", FP32_TOL),
                ("coarse bf16", "coarse", pc, vc, "bfloat16", None)):
            w = packed(level, dtype)
            got = call(v2.fwd_T, w, pts_T, views_T, dtype)
            torch.cuda.synchronize()
            want = call(v2.plain_fwd_T, w, pts_T, views_T, dtype)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"{label}: kernel output is not finite")
            rel, mx = rel_err(got, want)
            errs[label] = mx
            log(f"kernel vs plain, {label}, N={pts_T.shape[1]}: max|diff| "
                f"{mx:.3e}, max|diff|/mean|plain| {rel:.3e} (tol {tol})")
            if tol is not None and not rel < tol:
                fail(f"{label}: kernel disagrees with its plain version "
                     f"({rel:.3e} >= {tol:g})")
            if label == "fine bf16":
                again = call(v2.fwd_T, w, pts_T, views_T, dtype)
                same = torch.equal(got, again)
                log(f"{v2.KERNEL} fine bf16 repeat: bit-identical {same}")
                gate(same, f"{v2.KERNEL} bf16: a second launch gave other "
                     "bits")
                del again
            del got, want

    # 4. The render path: the 6 views through build_render_fn.
    render = render_lib.build_render_fn(model, cfg)
    v2.launches = 0
    out = render(stacked)
    torch.cuda.synchronize()
    launches = v2.launches
    expected = 2 * (-(-n_rays // CHUNK))
    log(f"render of {len(all_rays)} views x {scene.H}x{scene.W}: "
        f"{v2.KERNEL} launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"main path launched {v2.KERNEL} {launches} times, expected "
             f"{expected}")
    for k, shape in (("rgb", (6, 128, 128, 3)), ("depth", (6, 128, 128)),
                     ("acc", (6, 128, 128))):
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            fail(f"render output {k} has shape {tuple(out[k].shape)} or "
                 "non-finite values")
    plain_cfg = cfg.replace(use_fused_render=False)
    plain_out = render_lib.build_render_fn(model, plain_cfg)(all_rays[0])
    torch.cuda.synchronize()
    rgb_diff = (out["rgb"][0] - plain_out["rgb"]).abs().mean().item()
    log(f"view 0, fused vs plain render (bf16): mean|rgb diff| "
        f"{rgb_diff:.3e} (tol {RENDER_RGB_TOL:g})")
    if not rgb_diff < RENDER_RGB_TOL:
        fail(f"fused render disagrees with the plain render ({rgb_diff})")

    # 5. The render CLI on two test views.
    with tempfile.TemporaryDirectory() as tmp:
        v2.launches = 0
        out_dir = render_cli.main([
            "--render-test", "--out", f"{tmp}/out",
            "--set", "dataset_type=synthetic", "--set", "synthetic_views=6",
            "--set", "synthetic_hw=128", "--set", "synthetic_n_test=2",
            "--set", "white_bkgd=true", "--set", "compute_dtype=bfloat16",
            "--set", f"basedir={tmp}",
        ])
        torch.cuda.synchronize()
        cli_launches = v2.launches
        pngs = sorted(os.listdir(out_dir))
        log(f"cli.render wrote {pngs} ({v2.KERNEL} launches {cli_launches})")
        if len(pngs) != 4 or cli_launches == 0:
            fail("cli.render did not render two views through the kernel")

    # 6. Timings, tagged with the card.
    tag = f"[{card}]"
    with torch.no_grad():
        wf = packed("fine", "bfloat16")
        wc = packed("coarse", "bfloat16")
        ms_fine = time_ms(lambda: call(v2.fwd_T, wf, pf, vf, "bfloat16"), 5)
        ms_coarse = time_ms(lambda: call(v2.fwd_T, wc, pc, vc, "bfloat16"),
                            10)
        plain_ms = time_ms(
            lambda: call(v2.plain_fwd_T, wf, pf, vf, "bfloat16"), 3)
        wf32 = packed("fine", "float32")
        ms_fine32 = time_ms(lambda: call(v2.fwd_T, wf32, pf, vf, "float32"),
                            2)
    render_s = time_ms(lambda: render(stacked), 3) / 1e3
    dev_ms, top = device_time(lambda: render(stacked))
    flops_pp = mlp_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                   cfg.multires, cfg.multires_views)
    wbytes = wf.w.numel() * wf.w.element_size() + wf.b.numel() * 4
    b_fine, by_fine = bound_ms(n_fine, flops_pp, wbytes, PEAK_BF16_FLOPS)
    b_coarse, _ = bound_ms(n_coarse, flops_pp, wbytes, PEAK_BF16_FLOPS)
    b_fine32, _ = bound_ms(n_fine, flops_pp, 2 * wbytes, PEAK_FP32_FLOPS)
    b_render = sum(bound_ms(CHUNK * s, flops_pp, wbytes, PEAK_BF16_FLOPS)[0]
                   for s in (64, 192)) * launches / 2
    log(f"{tag} {v2.KERNEL} bf16 fine chunk (N={n_fine}): {ms_fine:.3f} ms"
        f"/launch, bound {b_fine:.3f} ms ({by_fine}, "
        f"{100 * b_fine / ms_fine:.1f}% of it)")
    log(f"{tag} {v2.KERNEL} bf16 coarse chunk (N={n_coarse}): "
        f"{ms_coarse:.3f} ms/launch, bound {b_coarse:.3f} ms "
        f"({100 * b_coarse / ms_coarse:.1f}% of it)")
    log(f"{tag} {v2.KERNEL} fp32 fine chunk: {ms_fine32:.3f} ms/launch, "
        f"bound {b_fine32:.3f} ms (fp32 CUDA-core peak)")
    log(f"{tag} plain version, bf16 fine chunk: {plain_ms:.3f} ms")
    log(f"{tag} render {len(all_rays)} views: {1e3 * render_s:.2f} ms, "
        f"{n_rays / render_s:.1f} rays/s; MLP bound {b_render:.2f} ms "
        f"({launches} launches, {flops_pp} FLOP/point)")
    if dev_ms is None:
        log(f"{tag} render device time: not measured (the profiler saw no "
            "device time)")
    else:
        log(f"{tag} profiled render: device time {dev_ms:.2f} ms, "
            f"{100 * dev_ms / (1e3 * render_s):.1f}% of the event-timed "
            f"render (idle share {1 - dev_ms / (1e3 * render_s):.3f}); by "
            "kernel: " + "; ".join(
                f"{k} {ms:.2f} ms x{n}" for k, ms, n in top))
    return {"launches": launches + cli_launches, "json": dict(
        max_abs_err=errs["fine bf16"], ms=ms_fine, plain_ms=plain_ms,
        bound_ms=b_fine, bound_by=by_fine, library_ms=None),
        "render_ms": 1e3 * render_s}


FLAGSHIP = dict(  # bench.py:66-84
    backbone="vanilla", N_samples=64, N_importance=128, N_rand=4096,
    n_patches=4, patch_size=16, hardmask=True, with_depth_loss=True,
    white_bkgd=True, compute_dtype="bfloat16", perturb=1.0,
    use_fused_train=True, use_onepass_train=True)
SCENE = dict(n_views=6, H=128, W=128)  # bench.py:50-53
GUARD_N_RAND = 1024  # random rays of the step guard's batch
TIMED_STEPS = 20  # bench.py:106-116


def train_phases(dev, card, configs, fm, v2, op):
    """The train path: kernels #2 and #3 vs their plain versions at the
    flagship step's shapes, the train CLI with a checkpoint and a resume,
    the step guard, timings and a profile of one step."""
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.ops import pdf_merge
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    cfg = configs.Config(**FLAGSHIP)
    skips = op.model_skips(cfg.netdepth)
    mlp_kw = dict(net_depth=cfg.netdepth, skips=skips,
                  multires=cfg.multires, multires_views=cfg.multires_views)
    s_c, s_f = cfg.N_samples, cfg.N_samples + cfg.N_importance
    # The bench scene: 6 views, 4 train, 2 test.
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    state = loop.init_state(cfg, dev)
    batcher = VanillaBatcher(scene, cfg)
    batch = to_device(batcher.next_batch(), dev)
    n = batch["rgb"].shape[0]
    p = cfg.n_patches * cfg.patch_size ** 2
    log(f"flagship step: {n} rays ({p} patch + {n - p} random), "
        f"{s_c} + {cfg.N_importance} samples, {cfg.compute_dtype}")
    draws = step_lib.make_draws(
        cfg, n, step_lib.step_generator(cfg.seed, 0, dev), dev)
    rays = step_lib.rays_from_batch(batch, cfg.near, cfg.far)
    z_c = sampling.vanilla_z_vals(rays.near, rays.far, s_c, False,
                                  draws["t_rand"])
    o_T, d_T = rays.origins.T.contiguous(), rays.directions.T.contiguous()
    v_T = rays.viewdirs.T.contiguous()
    dnorm = torch.linalg.norm(rays.directions, dim=-1)
    flat = {lvl: [w.detach() for w in fm.flatten_params(
        getattr(state.model, lvl), True, cfg.netdepth)]
        for lvl in ("coarse", "fine")}

    def packed(level, dtype):
        return v2.pack(flat[level], compute_dtype=dtype, **mlp_kw)

    def streams(sl, z):
        return op._pts_views(o_T[:, sl], d_T[:, sl], v_T[:, sl], z)

    # Level inputs as the step makes them: patch rays [:p] take #1 + #2,
    # random rays [p:] take #3; fine depths from the coarse weights.
    with torch.no_grad():
        pc, vc = streams(slice(0, p), z_c[:p])
        raw = v2.plain_fwd_T(packed("coarse", "bfloat16"), pc, vc,
                             compute_dtype="bfloat16", **mlp_kw)
        w_p = rendering.raw2outputs_T(raw.reshape(4, p, s_c), z_c[:p],
                                      rays.directions[:p], None, True)[3]
        z_fp = pdf_merge.fine_z_vals(z_c[:p], w_p, cfg.N_importance,
                                     u=draws["u"][:p], det=False)
        pf, vf = streams(slice(0, p), z_fp)
        mask = batch["mask"]
        m_sum = mask.sum()
        coeff_rgb = 2.0 * (mask / (3.0 * m_sum) + cfg.hardmask_coef
                           * (1.0 - mask) / (3.0 * (n - m_sum)))
        coeff_d = 2.0 * mask / (cfg.far ** 2 * m_sum)
        ray_rows = (dnorm[p:], coeff_rgb[p:], batch["rgb"][p:],
                    coeff_d[p:], batch["depth"][p:])
        rc, rvc = streams(slice(p, n), z_c[p:])
        out_c = op.plain_onepass_level(
            packed("coarse", "bfloat16"), rc, rvc, z_c[p:].contiguous(),
            *ray_rows, white_bkgd=True, compute_dtype=torch.bfloat16,
            **mlp_kw)[0]
        z_fr = pdf_merge.fine_z_vals(
            z_c[p:], out_c[5].reshape(n - p, s_c), cfg.N_importance,
            u=draws["u"][p:], det=False).contiguous()
        rf, rvf = streams(slice(p, n), z_fr)
    gen = torch.Generator(device=dev).manual_seed(5)
    levels2 = {"fine": (pf, vf), "coarse": (pc, vc)}
    g2 = {lvl: 1e-3 * torch.randn((4, x[0].shape[1]), generator=gen,
                                  device=dev)
          for lvl, x in levels2.items()}
    levels3 = {"fine": (rf, rvf, z_fr), "coarse": (rc, rvc,
                                                   z_c[p:].contiguous())}

    # 6. Kernels #2 and #3 vs their plain versions at these shapes.
    errs = {}
    for dtype in ("bfloat16", "float32"):
        for lvl in ("fine", "coarse"):
            w = packed(lvl, dtype)
            pts, views = levels2[lvl]
            got = v2.bwd_T(w, pts, views, g2[lvl], compute_dtype=dtype,
                           **mlp_kw)
            torch.cuda.synchronize()
            want = v2.plain_bwd_T(w, pts, views, g2[lvl],
                                  compute_dtype=dtype, **mlp_kw)
            rel, mx = grads_err(got, want)
            errs[(v2.BWD_KERNEL, lvl, dtype)] = mx
            log(f"{v2.BWD_KERNEL} vs plain, patch {lvl} {dtype}, "
                f"N={pts.shape[1]}: dW max|diff| {mx:.3e}, max rel L2 "
                f"{rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g})")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"{v2.BWD_KERNEL} {lvl} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype],
                 f"{v2.BWD_KERNEL} {lvl} {dtype} disagrees with its plain "
                 f"version ({rel:.3e})")
            if dtype == "bfloat16":
                repeat_gate(f"{v2.BWD_KERNEL} {lvl}", got, v2.bwd_T(
                    w, pts, views, g2[lvl], compute_dtype=dtype, **mlp_kw))
            del got, want
            pts, views, z = levels3[lvl]
            got_rows, got = op.onepass_level(
                w, pts, views, z, *ray_rows, white_bkgd=True,
                compute_dtype=dtype, **mlp_kw)
            torch.cuda.synchronize()
            want_rows, want = op.plain_onepass_level(
                w, pts, views, z, *ray_rows, white_bkgd=True,
                compute_dtype=fm.as_dtype(dtype), **mlp_kw)
            rel, mx = grads_err(got, want)
            row_errs = ((got_rows - want_rows).abs().amax(1)
                        / want_rows.abs().amax(1).clamp_min(1e-30)).tolist()
            errs[(op.KERNEL, lvl, dtype)] = mx
            log(f"{op.KERNEL} vs plain, random-ray {lvl} {dtype}, "
                f"N={pts.shape[1]}: rows max|diff| "
                f"{(got_rows - want_rows).abs().max().item():.3e}, per row "
                f"max|diff|/max|plain| " + ", ".join(
                    f"{k} {e:.2e}" for k, e in zip(ROW_NAMES, row_errs))
                + f" (tol {ROWS_TOL[dtype]:g}); dW max|diff| {mx:.3e}, max "
                f"rel L2 {rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g})")
            if not (torch.isfinite(got_rows).all()
                    and all(torch.isfinite(x).all() for x in got)):
                fail(f"{op.KERNEL} {lvl} {dtype}: non-finite output")
            gate(rel < TRAIN_DW_TOL[dtype]
                 and max(row_errs) < ROWS_TOL[dtype],
                 f"{op.KERNEL} {lvl} {dtype} disagrees with its plain "
                 f"version (rows {max(row_errs):.3e}, dW {rel:.3e})")
            if dtype == "bfloat16":
                again = op.onepass_level(w, pts, views, z, *ray_rows,
                                         white_bkgd=True, compute_dtype=dtype,
                                         **mlp_kw)
                repeat_gate(f"{op.KERNEL} {lvl}", (got_rows, got), again)
                del again
            del got, want, got_rows, want_rows
            torch.cuda.empty_cache()

    # 6b. #2 at ragged sizes (the fine level's weights, seeded points).
    def nerf_streams(n_pts, gen):
        pts = torch.rand((3, n_pts), generator=gen, device=dev) * 4 - 2
        views = torch.randn((3, n_pts), generator=gen, device=dev)
        return pts, views / views.norm(dim=0, keepdim=True)

    ragged_bwd_gates(
        v2.BWD_KERNEL, lambda dtype: packed("fine", dtype), nerf_streams,
        lambda w, pts, views, g, dtype: v2.bwd_T(
            w, pts, views, g, compute_dtype=dtype, **mlp_kw),
        lambda w, pts, views, g, dtype: v2.plain_bwd_T(
            w, pts, views, g, compute_dtype=dtype, **mlp_kw), dev)

    # 7. The train path: the train CLI, a checkpoint, a resume.
    counted = (v2, "launches", v2.KERNEL), (v2, "bwd_launches",
                                             v2.BWD_KERNEL), \
        (op, "launches", op.KERNEL)
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", f"checkpoint_every={TRAIN_STEPS}"] + [
        f"{k}={v}" for k, v in FLAGSHIP.items()]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", str(dev)] + [
            x for s_ in sets + [f"basedir={tmp}"] for x in ("--set", s_)]
        for steps, label in ((TRAIN_STEPS, "train"),
                             (TRAIN_STEPS + 2, "resume")):
            for mod, attr, _ in counted:
                setattr(mod, attr, 0)
            res = train_cli.main(args + ["--num-steps", str(steps)])
            torch.cuda.synchronize()
            got = {k: getattr(mod, attr) for mod, attr, k in counted}
            ran = steps - (0 if label == "train" else TRAIN_STEPS)
            log(f"cli.train {label}: steps {ran}, launches {got} (expected "
                f"2 of each per step), loss "
                f"{float(res.stats_history[-1]['loss']):.5f}")
            if any(v != 2 * ran for v in got.values()):
                fail(f"the train path did not launch 2 of each kernel per "
                     f"step: {got}")
            if res.state.step != steps or not all(
                    np.isfinite(float(h["loss"])) for h in
                    res.stats_history):
                fail(f"cli.train {label} ended at step {res.state.step} or "
                     "with a non-finite loss")
            if label == "train":
                launches = got
                ckpts = os.listdir(os.path.join(tmp, "exp", "checkpoints"))
                log(f"checkpoints: {ckpts}")
                if f"step_{TRAIN_STEPS:08d}.pt" not in ckpts:
                    fail("cli.train wrote no checkpoint")

    # 8. Step guard: kernel step vs plain eager step, same state, batch and
    # draws, one bf16 step. N_rand 1024: the eager step's autograd keeps
    # every activation of its 2048 rays x 256 samples.
    g_cfg = cfg.replace(N_rand=GUARD_N_RAND)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
    g_draws = step_lib.make_draws(
        g_cfg, g_batch["rgb"].shape[0],
        step_lib.step_generator(g_cfg.seed, 0, dev), dev)

    (s_k, _), (s_e, _) = guard_steps(
        f"step guard (N_rand {GUARD_N_RAND}, bf16)",
        op.build_onepass_vanilla_train_step(g_cfg),
        step_lib.build_vanilla_train_step(g_state.model, g_cfg), g_state,
        g_batch, g_draws)
    deltas = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        s_k.model.parameters(), s_e.model.parameters())])
    lr0 = g_cfg.lrate
    share = (deltas > 0.1 * lr0).float().mean().item()
    log(f"step guard update: max|dparam| {deltas.max().item():.3e} (one "
        f"Adam step moves a parameter by at most ~lr = {lr0:g}); share of "
        f"parameters apart by > 0.1 lr: {share:.4f}")
    gate(deltas.max().item() <= 2.0 * lr0 * 1.001 and share <= 0.05,
         "kernel step update disagrees with the eager step")
    del s_k, s_e, g_state
    torch.cuda.empty_cache()

    # 9. Timings, tagged with the card.
    tag = f"[{card}]"
    t_state = loop.init_state(cfg, dev)
    step_fn = loop.select_train_step(cfg, t_state.model)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    t_state, _ = step_fn(t_state, batches[0])  # warm-up
    torch.cuda.synchronize()
    n_steps = TIMED_STEPS
    t0 = time.perf_counter()
    for i in range(n_steps):
        t_state, stats = step_fn(t_state, batches[i % 4])
    float(stats["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = 1e3 * dt / n_steps
    # The step's least MLP work: forward, dW and the needed input grads
    # of every point once (the patch rays' forward, which kernel #2
    # recomputes, counted once).
    train_pp = mlp_train_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                         cfg.multires, cfg.multires_views)
    step_bound = 1e3 * train_pp * n * (s_c + s_f) / PEAK_BF16_FLOPS
    log(f"{tag} train step (flagship, {n} rays): {step_ms:.2f} ms/step, "
        f"{n_steps * n / dt:.1f} rays/s over {n_steps} steps; bf16 bound "
        f"{step_bound:.2f} ms ({train_pp} FLOP/point, "
        f"{100 * step_bound / step_ms:.1f}% of it)")
    peak_memory(f"{tag} train step (flagship)")
    wall0 = time.perf_counter()
    dev_ms, top = device_time(lambda: step_fn(t_state, batches[1]))
    wall_ms = 1e3 * (time.perf_counter() - wall0)
    if dev_ms is None:
        log(f"{tag} train step device time: not measured (the profiler "
            "saw no device time)")
    else:
        log(f"{tag} profiled step: device time {dev_ms:.2f} ms of "
            f"{step_ms:.2f} ms/step (event-free loop), idle share "
            f"{max(0.0, 1 - dev_ms / step_ms):.3f} (profiled wall "
            f"{wall_ms:.1f} ms); by kernel: " + "; ".join(
                f"{k} {ms:.2f} ms x{c}" for k, ms, c in top))

    def runner(kern, lvl, fn):
        """A call of `fn` (the kernel wrapper or its plain version) on
        the level's bf16 inputs."""
        w = packed(lvl, "bfloat16")
        if kern == v2.BWD_KERNEL:
            pts, views = levels2[lvl]
            return lambda: fn(w, pts, views, g2[lvl],
                              compute_dtype="bfloat16", **mlp_kw)
        pts, views, z = levels3[lvl]
        return lambda: fn(w, pts, views, z, *ray_rows, white_bkgd=True,
                          compute_dtype=torch.bfloat16, **mlp_kw)

    # Bytes per point each kernel must move: #2 reads pts, views and g
    # (10 floats); #3 reads pts, views, z and writes 6 output rows (13
    # floats), plus 7 floats per ray. Weights read once in bf16, dW and db
    # written once in fp32.
    n_w = sum(v2.grad_numel(packed("fine", "bfloat16")))
    rows = []
    for kern, plain, kfn, bpp in (
            (v2.BWD_KERNEL, v2.plain_bwd_T, v2.bwd_T, 40),
            (op.KERNEL, op.plain_onepass_level, op.onepass_level,
             52 + 28 / s_f)):
        res_ms = {}
        for lvl in ("fine", "coarse"):
            npts = (levels2 if kern == v2.BWD_KERNEL else levels3)[lvl][
                0].shape[1]
            ms = time_ms(runner(kern, lvl, kfn), 5 if lvl == "fine" else 10)
            bound, by = bound_ms(npts, train_pp, 6 * n_w,
                                 PEAK_BF16_FLOPS, bpp)
            res_ms[lvl] = (ms, bound, by)
            log(f"{tag} {kern} bf16 {lvl} (N={npts}): {ms:.3f} ms/launch, "
                f"bound {bound:.3f} ms ({by}, {100 * bound / ms:.1f}% of "
                "it)")
        plain_ms = time_ms(runner(kern, "fine", plain), 2)
        log(f"{tag} plain version of {kern}, bf16 fine: {plain_ms:.3f} ms")
        if kern == v2.BWD_KERNEL:
            # The step's two launches of #1, on the patch rays' levels.
            fwd_pp = mlp_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                         cfg.multires, cfg.multires_views)
            for lvl in ("fine", "coarse"):
                w = packed(lvl, "bfloat16")
                pts, views = levels2[lvl]
                with torch.no_grad():
                    ms1 = time_ms(lambda: v2.fwd_T(
                        w, pts, views, compute_dtype="bfloat16", **mlp_kw),
                        10)
                b1, by1 = bound_ms(pts.shape[1], fwd_pp, w.w.numel() * 2
                                   + w.b.numel() * 4, PEAK_BF16_FLOPS)
                log(f"{tag} {v2.KERNEL} bf16 one-pass step, patch {lvl} "
                    f"(N={pts.shape[1]}): {ms1:.3f} ms/launch, bound "
                    f"{b1:.3f} ms ({by1}, {100 * b1 / ms1:.1f}% of it)")
        ms, bound, by = res_ms["fine"]
        rows.append(dict(
            name=kern, route="cuda",
            source=f"consistentnerf_tpu_torch/csrc/{kern}.cu",
            replaces=("consistentnerf_tpu/ops/fused_mlp_v2.py:718"
                      if kern == v2.BWD_KERNEL else
                      "consistentnerf_tpu/ops/fused_onepass.py:188"),
            launches=launches[kern],
            max_abs_err=errs[(kern, "fine", "bfloat16")], ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
    return {"launches": launches, "json": rows}


MIP = dict(  # bench.py:241-258 (train_rays_per_sec_mip_96x2)
    backbone="mipnerf", mip_num_samples=96, mip_num_levels=2,
    N_rand=4096 - 4 * 256, disable_normals=True, white_bkgd=True,
    compute_dtype="bfloat16", use_hardmask=True,
    compute_depth_metrics=True, compute_mono_depth_metrics=True,
    dataset_type="blender", randomized=True, use_fused_train=True,
    use_onepass_train=True)
MIP_PATCH = 4 * 16 * 16  # the MiDaS patch rays at the head of a batch
# #6 in bf16 against its plain version. Both round at the same points and
# differ only in the order of their fp32 sums, which now and then flips a
# bf16 rounding of an activation; the flip travels down the layers. The
# largest such difference was ~3e-3 on an H100 (about the vanilla MLP's
# 2.2e-3), but the MipMLP's raw heads are small at init (mean |raw|
# ~0.09 against the NeRFMLP's ~0.18), so max|diff| / mean|plain| reads
# 2.6e-2 to 3.7e-2, over the 2e-2 that the vanilla gate holds; the mean
# difference stays ~1e-5, while a wrong rounding point would move it to
# the bf16-vs-fp32 level (~6e-4). The gates are therefore each row's
# max|diff| / max|plain| (as for #5's rows) and mean|diff| / mean|plain|;
# max|diff| / mean|plain| is reported beside them.
MIP_BF16_ROW_TOL = 2e-2
MIP_BF16_MEAN_TOL = 1e-3


def mip_fwd_errs(got, want):
    """(max|diff| / mean|plain|, the largest row's max|diff| / max|plain|,
    mean|diff| / mean|plain|, max|diff|) of raw heads [4, N]."""
    diff = (got - want).abs()
    rows = (diff.amax(1) / want.abs().amax(1).clamp_min(1e-30)).max()
    mean_abs = want.abs().mean()
    return ((diff.max() / mean_abs).item(), rows.item(),
            (diff.mean() / mean_abs).item(), diff.max().item())


def mip_fwd_gate(label, got, want, dtype):
    """Log and gate #6 against its plain version (see MIP_BF16_ROW_TOL)."""
    rel, rows, mean, mx = mip_fwd_errs(got, want)
    if dtype == "float32":
        log(f"{label}: max|diff| {mx:.3e}, max|diff|/mean|plain| {rel:.3e} "
            f"(tol {FP32_TOL:g})")
        gate(rel < FP32_TOL, f"{label} disagrees with its plain version "
             f"({rel:.3e})")
    else:
        log(f"{label}: max|diff| {mx:.3e}, per row max|diff|/max|plain| "
            f"{rows:.3e} (tol {MIP_BF16_ROW_TOL:g}), mean|diff|/mean|plain| "
            f"{mean:.3e} (tol {MIP_BF16_MEAN_TOL:g}); max|diff|/mean|plain| "
            f"{rel:.3e}")
        gate(rows < MIP_BF16_ROW_TOL and mean < MIP_BF16_MEAN_TOL,
             f"{label} disagrees with its plain version (rows {rows:.3e}, "
             f"mean {mean:.3e})")
    return mx
# #5's inputs per point: means, covs, views (9 floats), tmid, delta and
# the noise row (3), the 6 output rows; per ray tlo, thi, the rgb and
# distance coefficients, the target (3) and the prior.
MIP_LEVEL_BPP = 4 * (9 + 3 + 6)
MIP_LEVEL_BPR = 4 * 8


def mip_mlp_kw(cfg):
    return dict(net_depth=cfg.netdepth, num_freqs=cfg.max_deg_point)


def mip_flops(cfg, fmip, train=False):
    fn = mlp_train_flops_per_point if train else mlp_flops_per_point
    return fn(cfg.netdepth, cfg.netwidth, fmip.mip_skips(cfg.netdepth),
              cfg.max_deg_point, fmip.DEG_VIEW, ipe=True, view_width=128)


def mip_render_phases(dev, card, configs, fm, fmip):
    """The mip render path: #6 vs plain on a render chunk, the 6-view
    mip render through the fused forward, timings."""
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.models.mlp import softplus
    from consistentnerf_tpu_torch.train import evaluation
    from consistentnerf_tpu_torch.train import render as render_lib

    cfg = configs.Config(**{**MIP, "render_chunk_size": CHUNK,
                            "use_fused_render": True})
    kw = mip_mlp_kw(cfg)
    s = cfg.mip_num_samples
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    model = make_model(cfg, dev).eval()
    flat = [w.detach() for w in fmip.flatten_mip_params(model.mlp,
                                                        cfg.netdepth)]
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    n_rays = stacked.origins[..., 0].numel()

    # 10. #6 vs plain on the first 8192-ray chunk of view 0, both levels
    # as the render makes them (level 1 resampled from level 0's plain
    # weights).
    chunk = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:CHUNK])
    n = chunk.origins.shape[0]
    views = chunk.viewdirs.T[:, :, None].expand(3, n, s).reshape(
        3, n * s).contiguous()

    def streams(samples):
        m, c = samples
        return (m.reshape(3, n * s).contiguous(),
                c.reshape(3, n * s).contiguous(), views)

    with torch.no_grad():
        t0_, smp0 = sampling.sample_along_rays(
            None, chunk.origins, chunk.directions, chunk.radii, s,
            chunk.near, chunk.far, None, "cone", transposed=True)
        lvl0 = streams(smp0)
        raw0 = fmip.plain_fwd_T(flat, *lvl0, compute_dtype="bfloat16", **kw)
        w0 = rendering.compute_alpha_weights(
            softplus(raw0[3] + fmip.DENSITY_BIAS).reshape(n, s), t0_,
            chunk.directions)[0]
        _, smp1 = sampling.resample_along_rays(
            None, chunk.origins, chunk.directions, chunk.radii, t0_, w0,
            "cone", True, cfg.resample_padding_final, transposed=True)
        lvl1 = streams(smp1)
        errs = {}
        for label, inputs, dtype in (
                ("level 1 bf16", lvl1, "bfloat16"),
                ("level 1 fp32", lvl1, "float32"),
                ("level 0 bf16", lvl0, "bfloat16")):
            w = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, dtype)
            got = fmip.fwd_T(w, *inputs, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            want = fmip.plain_fwd_T(w, *inputs, compute_dtype=dtype, **kw)
            if not torch.isfinite(got).all():
                fail(f"{fmip.KERNEL} {label}: output is not finite")
            errs[label] = mip_fwd_gate(
                f"{fmip.KERNEL} vs plain, render chunk {label}, "
                f"N={inputs[0].shape[1]}", got, want, dtype)
            del got, want

    # 11. The mip render path: the 6 views through build_render_fn.
    render = render_lib.build_render_fn(model, cfg)
    fmip.launches = 0
    out = render(stacked)
    torch.cuda.synchronize()
    launches = fmip.launches
    expected = cfg.mip_num_levels * (-(-n_rays // CHUNK))
    log(f"mip render of {len(all_rays)} views x {scene.H}x{scene.W}: "
        f"{fmip.KERNEL} launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"the mip render launched {fmip.KERNEL} {launches} times, "
             f"expected {expected}")
    views_hw = (len(all_rays), scene.H, scene.W)
    for k in ("rgb", "depth", "acc", "distance_median"):
        shape = views_hw + ((3,) if k == "rgb" else ())
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            fail(f"mip render output {k} has shape {tuple(out[k].shape)} "
                 "or non-finite values")
    plain_out = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(all_rays[0])
    torch.cuda.synchronize()
    rgb_diff = (out["rgb"][0] - plain_out["rgb"]).abs().mean().item()
    log(f"view 0, fused vs plain mip render (bf16): mean|rgb diff| "
        f"{rgb_diff:.3e} (tol {RENDER_RGB_TOL:g})")
    gate(rgb_diff < RENDER_RGB_TOL,
         f"fused mip render disagrees with the plain render ({rgb_diff})")

    # 12. Timings, tagged with the card.
    tag = f"[{card}]"
    w16 = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, "bfloat16")
    with torch.no_grad():
        ms = time_ms(lambda: fmip.fwd_T(w16, *lvl1, compute_dtype="bfloat16",
                                        **kw), 3)
        plain_ms = time_ms(lambda: fmip.plain_fwd_T(
            w16, *lvl1, compute_dtype="bfloat16", **kw), 2)
    render_s = time_ms(lambda: render(stacked), 2) / 1e3
    dev_ms, top = device_time(lambda: render(stacked))
    flops_pp = mip_flops(cfg, fmip)
    wbytes = w16.w.numel() * 2 + w16.b.numel() * 4
    npts = lvl1[0].shape[1]
    bound, by = bound_ms(npts, flops_pp, wbytes, PEAK_BF16_FLOPS, 52)
    b_render = bound_ms(n_rays * s * cfg.mip_num_levels, flops_pp,
                        wbytes * launches, PEAK_BF16_FLOPS, 52)[0]
    log(f"{tag} {fmip.KERNEL} bf16 render chunk (N={npts}): {ms:.3f} "
        f"ms/launch, bound {bound:.3f} ms ({by}, {100 * bound / ms:.1f}% "
        f"of it); plain version {plain_ms:.3f} ms")
    log(f"{tag} mip render {len(all_rays)} views: {1e3 * render_s:.2f} ms, "
        f"{n_rays / render_s:.1f} rays/s; MLP bound {b_render:.2f} ms "
        f"({launches} launches, {flops_pp} FLOP/point)")
    if dev_ms is None:
        log(f"{tag} mip render device time: not measured (the profiler saw "
            "no device time)")
    else:
        log(f"{tag} profiled mip render: device time {dev_ms:.2f} ms, "
            f"{100 * dev_ms / (1e3 * render_s):.1f}% of the event-timed "
            f"render (idle share {1 - dev_ms / (1e3 * render_s):.3f}); by "
            "kernel: " + "; ".join(
                f"{k} {t:.2f} ms x{c}" for k, t, c in top))
    return {"launches": launches, "json": dict(
        max_abs_err=errs["level 1 bf16"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None),
        "render_ms": 1e3 * render_s}


def mip_train_phases(dev, card, configs, fm, fmip, op):
    """The mip train path: #7 and #5 (and #6 on the patch rays) vs their
    plain versions at the step's shapes, the train CLI with a checkpoint
    and a resume, the step guard, timings and a profile of one step."""
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.core import sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import losses as losses_lib
    from consistentnerf_tpu_torch.train import step as step_lib

    cfg = configs.Config(**{**MIP, "density_noise": 1.0})
    kw = mip_mlp_kw(cfg)
    s = cfg.mip_num_samples
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    state = loop.init_state(cfg, dev)
    batcher = MipBatcher(scene, cfg)
    batch = to_device(batcher.next_batch(), dev)
    rays = batch["rays"]
    n, p = rays.origins.shape[0], MIP_PATCH
    log(f"mip step: {n} rays ({p} patch + {n - p} random), {s} samples x "
        f"{cfg.mip_num_levels} levels, {cfg.compute_dtype}; the kernel "
        "checks add density noise (density_noise 1)")
    draws = step_lib.make_mip_draws(
        cfg, n, step_lib.step_generator(cfg.seed, 0, dev), dev)
    flat = [w.detach() for w in fmip.flatten_mip_params(state.model.mlp,
                                                        cfg.netdepth)]
    dnorm = torch.linalg.norm(rays.directions, dim=-1)
    lossmult = rays.lossmult[:, 0]
    base_crgb = 2.0 * lossmult / (lossmult.sum() + 1e-4)
    mask, scale = losses_lib.depth_scale_and_mask(batch, cfg, n, dev)
    base_cd = 2.0 * mask * mask / (scale ** 2 * n)

    # Level inputs as the step makes them: patch rays [:p] take #6 + #7,
    # random rays [p:] take #5; level 1 resamples from level 0's weights.
    def level_streams(sl, t_vals, samples):
        m, c = samples
        k = t_vals.shape[0]
        views = rays.viewdirs[sl].T[:, :, None].expand(3, k, s).reshape(
            3, k * s).contiguous()
        return (m.reshape(3, k * s).contiguous(),
                c.reshape(3, k * s).contiguous(), views)

    def sample(sl, lvl, t_vals=None, w=None):
        r = rays.map(lambda x: x[sl])
        if lvl == 0:
            return sampling.sample_along_rays(
                draws["t_rand"][sl], r.origins, r.directions, r.radii, s,
                r.near, r.far, None, "cone", transposed=True)
        return sampling.resample_along_rays(
            draws["jitter"][lvl][sl], r.origins, r.directions, r.radii,
            t_vals, w, "cone", True, 0.01, transposed=True)

    def ray_rows(sl, t_vals, lvl):
        lw = [cfg.coarse_loss_mult, 1.0][lvl]
        return (0.5 * (t_vals[:, :-1] + t_vals[:, 1:]),
                (t_vals[:, 1:] - t_vals[:, :-1]) * dnorm[sl][:, None],
                t_vals[:, 0].contiguous(), t_vals[:, -1].contiguous(),
                lw * base_crgb[sl], batch["rgb"][sl, :3],
                0.1 * lw * base_cd[sl], batch["dpts"][sl],
                draws["noise"][lvl][sl])

    patch, data = slice(0, p), slice(p, n)
    levels_p, levels_r = {}, {}
    w16 = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, "bfloat16")
    with torch.no_grad():
        t_p, smp = sample(patch, 0)
        levels_p[0] = level_streams(patch, t_p, smp)
        raw = fmip.plain_fwd_T(w16, *levels_p[0], compute_dtype="bfloat16",
                               **kw)
        w_p = op._mip_composite_fwd(
            raw.reshape(4, p, s), 0.5 * (t_p[:, :-1] + t_p[:, 1:]),
            (t_p[:, 1:] - t_p[:, :-1]) * dnorm[patch][:, None], t_p[:, 0],
            t_p[:, -1], True, fmip.RGB_PADDING, fmip.DENSITY_BIAS,
            draws["noise"][0][patch])[3]
        t_p1, smp = sample(patch, 1, t_p, w_p)
        levels_p[1] = level_streams(patch, t_p1, smp)
        t_r, smp = sample(data, 0)
        levels_r[0] = (*level_streams(data, t_r, smp),
                       *ray_rows(data, t_r, 0))
        out0 = op.plain_onepass_mip_level(
            w16, *levels_r[0], compute_dtype=torch.bfloat16,
            white_bkgd=True, **kw)[0]
        t_r1, smp = sample(data, 1, t_r, out0[5].reshape(n - p, s))
        levels_r[1] = (*level_streams(data, t_r1, smp),
                       *ray_rows(data, t_r1, 1))
    gen = torch.Generator(device=dev).manual_seed(5)
    g7 = {lvl: 1e-3 * torch.randn((4, p * s), generator=gen, device=dev)
          for lvl in (0, 1)}

    # 13. #6 on the patch rays, #7 and #5 vs their plain versions.
    errs = {}
    for dtype in ("bfloat16", "float32"):
        w = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, dtype)
        for lvl in (1, 0):
            got = fmip.fwd_T(w, *levels_p[lvl], compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            want = fmip.plain_fwd_T(w, *levels_p[lvl], compute_dtype=dtype,
                                    **kw)
            mip_fwd_gate(f"{fmip.KERNEL} vs plain, patch level {lvl} "
                         f"{dtype}, N={got.shape[1]}", got, want, dtype)
            got = fmip.bwd_T(w, *levels_p[lvl], g7[lvl],
                             compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            want = fmip.plain_bwd_T(w, *levels_p[lvl], g7[lvl],
                                    compute_dtype=dtype, **kw)
            rel, mx = grads_err(got, want)
            errs[(fmip.BWD_KERNEL, lvl, dtype)] = mx
            log(f"{fmip.BWD_KERNEL} vs plain, patch level {lvl} {dtype}, "
                f"N={levels_p[lvl][0].shape[1]}: dW max|diff| {mx:.3e}, "
                f"max rel L2 {rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g})")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"{fmip.BWD_KERNEL} level {lvl} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype],
                 f"{fmip.BWD_KERNEL} level {lvl} {dtype} disagrees with its "
                 f"plain version ({rel:.3e})")
            if dtype == "bfloat16":
                repeat_gate(f"{fmip.BWD_KERNEL} level {lvl}", got,
                            fmip.bwd_T(w, *levels_p[lvl], g7[lvl],
                                       compute_dtype=dtype, **kw))
            del got, want
            got_rows, got = op.onepass_mip_level(
                w, *levels_r[lvl], compute_dtype=dtype, white_bkgd=True,
                **kw)
            torch.cuda.synchronize()
            want_rows, want = op.plain_onepass_mip_level(
                w, *levels_r[lvl], compute_dtype=fm.as_dtype(dtype),
                white_bkgd=True, **kw)
            rel, mx = grads_err(got, want)
            row_errs = ((got_rows - want_rows).abs().amax(1)
                        / want_rows.abs().amax(1).clamp_min(1e-30)).tolist()
            errs[(op.MIP_KERNEL, lvl, dtype)] = mx
            log(f"{op.MIP_KERNEL} vs plain, random-ray level {lvl} {dtype} "
                f"(noise row on), N={levels_r[lvl][0].shape[1]}: rows "
                f"max|diff| {(got_rows - want_rows).abs().max().item():.3e}"
                ", per row max|diff|/max|plain| " + ", ".join(
                    f"{k} {e:.2e}" for k, e in zip(
                        ("r", "g", "b", "dist", "acc", "w"), row_errs))
                + f" (tol {ROWS_TOL[dtype]:g}); dW max|diff| {mx:.3e}, max "
                f"rel L2 {rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g})")
            if not (torch.isfinite(got_rows).all()
                    and all(torch.isfinite(x).all() for x in got)):
                fail(f"{op.MIP_KERNEL} level {lvl} {dtype}: non-finite "
                     "output")
            gate(rel < TRAIN_DW_TOL[dtype]
                 and max(row_errs) < ROWS_TOL[dtype],
                 f"{op.MIP_KERNEL} level {lvl} {dtype} disagrees with its "
                 f"plain version (rows {max(row_errs):.3e}, dW {rel:.3e})")
            if dtype == "bfloat16":
                again = op.onepass_mip_level(
                    w, *levels_r[lvl], compute_dtype=dtype, white_bkgd=True,
                    **kw)
                repeat_gate(f"{op.MIP_KERNEL} level {lvl}", (got_rows, got),
                            again)
                del again
            del got, want, got_rows, want_rows
            torch.cuda.empty_cache()

    # 13b. #7 at ragged sizes (seeded Gaussians and view directions).
    def mip_streams(n_pts, gen):
        means = torch.rand((3, n_pts), generator=gen, device=dev) * 3 - 1.5
        covs = torch.rand((3, n_pts), generator=gen, device=dev) * 1e-4
        views = torch.randn((3, n_pts), generator=gen, device=dev)
        return means, covs, views / views.norm(dim=0, keepdim=True)

    ragged_bwd_gates(
        fmip.BWD_KERNEL,
        lambda dtype: fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, dtype),
        mip_streams,
        lambda w, means, covs, views, g, dtype: fmip.bwd_T(
            w, means, covs, views, g, compute_dtype=dtype, **kw),
        lambda w, means, covs, views, g, dtype: fmip.plain_bwd_T(
            w, means, covs, views, g, compute_dtype=dtype, **kw), dev)

    # 14. The mip train path: the train CLI, a checkpoint, a resume. The
    # CLI loads the synthetic scene only through dataset_type=synthetic,
    # whose depth loss is unscaled and MiDaS term x1 (Blender: /far^2 and
    # x0.01); the kernels' work is the same.
    counted = (fmip, "launches", fmip.KERNEL), (fmip, "bwd_launches",
                                                fmip.BWD_KERNEL), \
        (op, "mip_launches", op.MIP_KERNEL)
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", f"checkpoint_every={TRAIN_STEPS}"] + [
        f"{k}={v}" for k, v in MIP.items() if k != "dataset_type"]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", str(dev)] + [
            x for s_ in sets + [f"basedir={tmp}"] for x in ("--set", s_)]
        for steps, label in ((TRAIN_STEPS, "train"),
                             (TRAIN_STEPS + 2, "resume")):
            for mod, attr, _ in counted:
                setattr(mod, attr, 0)
            res = train_cli.main(args + ["--num-steps", str(steps)])
            torch.cuda.synchronize()
            got = {k: getattr(mod, attr) for mod, attr, k in counted}
            ran = steps - (0 if label == "train" else TRAIN_STEPS)
            log(f"mip cli.train {label}: steps {ran}, launches {got} "
                f"(expected 2 of each per step), loss "
                f"{float(res.stats_history[-1]['loss']):.5f}")
            if any(v != 2 * ran for v in got.values()):
                fail(f"the mip train path did not launch 2 of each kernel "
                     f"per step: {got}")
            if res.state.step != steps or not all(
                    np.isfinite(float(h["loss"])) for h in
                    res.stats_history):
                fail(f"mip cli.train {label} ended at step "
                     f"{res.state.step} or with a non-finite loss")
            if label == "train":
                launches = got
                ckpts = os.listdir(os.path.join(tmp, "exp", "checkpoints"))
                if f"step_{TRAIN_STEPS:08d}.pt" not in ckpts:
                    fail("mip cli.train wrote no checkpoint")

    # 15. Step guard: the one-pass mip step vs the eager mip step from the
    # same state and batch, one bf16 step, randomized=False (a stochastic
    # level 1 magnifies ~1e-7 differences through its inverse CDF).
    g_cfg = configs.Config(**{**MIP, "N_rand": GUARD_N_RAND,
                              "randomized": False})
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(MipBatcher(scene, g_cfg).next_batch(), dev)
    guard_steps(f"mip step guard (N_rand {GUARD_N_RAND}, bf16)",
                op.build_onepass_mip_train_step(g_cfg),
                step_lib.build_mip_train_step(g_state.model, g_cfg), g_state,
                g_batch)
    del g_state
    torch.cuda.empty_cache()

    # 16. Timings, tagged with the card.
    tag = f"[{card}]"
    t_state = loop.init_state(cfg.replace(density_noise=0.0), dev)
    step_fn = loop.select_train_step(cfg.replace(density_noise=0.0),
                                     t_state.model)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    t_state, _ = step_fn(t_state, batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        t_state, stats = step_fn(t_state, batches[i % 4])
    float(stats["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = 1e3 * dt / TIMED_STEPS
    train_pp = mip_flops(cfg, fmip, train=True)
    step_bound = 1e3 * train_pp * n * s * cfg.mip_num_levels \
        / PEAK_BF16_FLOPS
    log(f"{tag} mip train step ({n} rays): {step_ms:.2f} ms/step, "
        f"{TIMED_STEPS * n / dt:.1f} rays/s over {TIMED_STEPS} steps; bf16 "
        f"bound {step_bound:.2f} ms ({train_pp} FLOP/point, "
        f"{100 * step_bound / step_ms:.1f}% of it)")
    peak_memory(f"{tag} mip train step")
    wall0 = time.perf_counter()
    dev_ms, top = device_time(lambda: step_fn(t_state, batches[1]))
    wall_ms = 1e3 * (time.perf_counter() - wall0)
    if dev_ms is None:
        log(f"{tag} mip train step device time: not measured (the profiler "
            "saw no device time)")
    else:
        log(f"{tag} profiled mip step: device time {dev_ms:.2f} ms of "
            f"{step_ms:.2f} ms/step (event-free loop), idle share "
            f"{max(0.0, 1 - dev_ms / step_ms):.3f} (profiled wall "
            f"{wall_ms:.1f} ms); by kernel: " + "; ".join(
                f"{k} {t:.2f} ms x{c}" for k, t, c in top))

    n_w = sum(v2.grad_numel(w16))
    rows = []
    for kern, plain, kfn, levels, bpp, replaces in (
            (fmip.BWD_KERNEL, fmip.plain_bwd_T, fmip.bwd_T, levels_p, 52,
             "consistentnerf_tpu/ops/fused_mip.py:651"),
            (op.MIP_KERNEL, op.plain_onepass_mip_level, op.onepass_mip_level,
             levels_r, MIP_LEVEL_BPP + MIP_LEVEL_BPR / s,
             "consistentnerf_tpu/ops/fused_onepass.py:374")):
        def runner(fn, lvl):
            if kern == fmip.BWD_KERNEL:
                return lambda: fn(w16, *levels[lvl], g7[lvl],
                                  compute_dtype="bfloat16", **kw)
            return lambda: fn(w16, *levels[lvl], white_bkgd=True,
                              compute_dtype=torch.bfloat16, **kw)

        res_ms = {}
        for lvl in (1, 0):
            npts = levels[lvl][0].shape[1]
            ms = time_ms(runner(kfn, lvl), 3)
            bound, by = bound_ms(npts, train_pp, 6 * n_w, PEAK_BF16_FLOPS,
                                 bpp)
            res_ms[lvl] = (ms, bound, by)
            log(f"{tag} {kern} bf16 level {lvl} (N={npts}): {ms:.3f} "
                f"ms/launch, bound {bound:.3f} ms ({by}, "
                f"{100 * bound / ms:.1f}% of it)")
        plain_ms = time_ms(runner(plain, 1), 1)
        log(f"{tag} plain version of {kern}, bf16 level 1: {plain_ms:.3f} ms")
        ms, bound, by = res_ms[1]
        rows.append(dict(
            name=kern, route="cuda",
            source=f"consistentnerf_tpu_torch/csrc/{kern}.cu",
            replaces=replaces, launches=launches[kern],
            max_abs_err=errs[(kern, 1, "bfloat16")], ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
    ms6 = time_ms(lambda: fmip.fwd_T(w16, *levels_p[1],
                                     compute_dtype="bfloat16", **kw), 5)
    b6, by6 = bound_ms(levels_p[1][0].shape[1], mip_flops(cfg, fmip),
                       w16.w.numel() * 2 + w16.b.numel() * 4,
                       PEAK_BF16_FLOPS, 52)
    log(f"{tag} {fmip.KERNEL} bf16 patch level 1 "
        f"(N={levels_p[1][0].shape[1]}): {ms6:.3f} ms/launch, bound "
        f"{b6:.3f} ms ({by6}, {100 * b6 / ms6:.1f}% of it)")
    return {"launches": launches, "json": rows}


# The resampling kernels #8 and #9 against their plain versions: the
# inverse CDF is ill-conditioned where a bin's pdf nears the 1e-5 floor
# (ROADMAP Queue 3 note D), so the order of the kernel's and the plain
# version's fp32 sums alone moves a few samples by up to a bin. The gates:
# exactly sorted output, every coarse depth present exactly (#8), |dz| /
# (far - near) within PDF_REL_TOL at the 99.9th percentile, and no sample
# further than one coarse bin.
PDF_REL_TOL = 1e-4
PDF_QUANTILE = 0.999
# 6n's rows 4-6 (the density's gradient by the means) against its plain
# version. fp32: each row's max|diff| / max|plain| < NORMALS_FP32_TOL.
# bf16: mean|diff| / mean|plain| < MIP_BF16_MEAN_TOL, and the kernel no
# further from the fp32 function (the fp32 plain version) than the bf16
# plain version is, in the mean and at the 99.9th percentile of the
# points' max|diff| / max|fp32| (NORMALS_BF16_RATIO). Each row's
# max|diff| / max|plain| is reported, not gated: the walk's ReLU masks
# come from the forward's bf16 activations, and where the two sides' fp32
# sums round an activation to neighbouring bf16 values a pre-activation
# near 0 can change sign, which switches a unit's whole contribution on
# or off at that point. Two plain bf16 computations that differ only in
# their sum order (card and host) differ so too.
NORMALS_FP32_TOL = 1e-4
NORMALS_BF16_RATIO = 1.25
NORMALS_HOST_POINTS = 65536


def row_max_rel(got, want):
    """Each row's max|diff| / max|want|, the largest row's."""
    return ((got - want).abs().amax(1)
            / want.abs().amax(1).clamp_min(1e-30)).max().item()


def normals_bf16_gate(label, got, want, want32, host):
    """Gate 6n's bf16 rows 4-6 (see NORMALS_BF16_RATIO); `host` is the
    bf16 plain version on the host for the first points. Returns the
    per-row max|diff| / max|plain|."""
    g, w, t = got[4:], want[4:], want32[4:]
    diff = (g - w).abs()
    rows = row_max_rel(g, w)
    mean = (diff.mean() / w.abs().mean()).item()
    far = ((diff / w.abs().amax(1, keepdim=True)).amax(0)
           > 1e-2).float().mean().item()
    m = host.shape[1]
    host_rows = row_max_rel(w[:, :m].cpu(), host[4:])

    def from_fp32(x):
        d = (x - t).abs()
        per_point = (d / t.abs().amax(1, keepdim=True)).amax(0)
        return ((d.mean() / t.abs().mean()).item(),
                torch.quantile(per_point, 0.999).item())

    k_mean, k_q = from_fp32(g)
    p_mean, p_q = from_fp32(w)
    log(f"{label}, rows 4-6 (d density / d means): max|diff| "
        f"{diff.max().item():.3e}, per row max|diff|/max|plain| {rows:.3e} "
        f"(share of points off by more than 1e-2 of a row's max: {far:.3e}; "
        f"the plain version on the card vs on the host over {m} points: "
        f"{host_rows:.3e}), "
        f"mean|diff|/mean|plain| {mean:.3e} (tol {MIP_BF16_MEAN_TOL:g}); "
        f"from the fp32 function: kernel mean {k_mean:.3e}, 99.9th "
        f"percentile {k_q:.3e}; plain bf16 mean {p_mean:.3e}, 99.9th "
        f"percentile {p_q:.3e} (ratio tol {NORMALS_BF16_RATIO:g})")
    gate(mean < MIP_BF16_MEAN_TOL and k_mean <= NORMALS_BF16_RATIO * p_mean
         and k_q <= NORMALS_BF16_RATIO * p_q,
         f"{label} rows 4-6 disagree (mean {mean:.3e}; from fp32 kernel "
         f"{k_mean:.3e} / {k_q:.3e}, plain {p_mean:.3e} / {p_q:.3e})")
    return rows


def resample_gate(label, got, want, span, bin_width, z_c=None):
    """Gate a resampler's output [N, K] against its plain version; returns
    max |diff|."""
    err = (got - want).abs()
    q = torch.quantile(err.flatten() / span, PDF_QUANTILE).item()
    mx = err.max().item()
    ok_sorted = bool(torch.all(got[:, 1:] >= got[:, :-1]))
    present = True
    if z_c is not None:
        idx = torch.searchsorted(got, z_c).clamp(max=got.shape[1] - 1)
        present = bool(torch.equal(got.gather(1, idx), z_c))
    log(f"{label}: max|dz| {mx:.3e} (one coarse bin {bin_width:.3e}), "
        f"{100 * PDF_QUANTILE:g}th percentile |dz|/(far - near) {q:.3e} "
        f"(tol {PDF_REL_TOL:g}); sorted {ok_sorted}"
        + ("" if z_c is None else f"; coarse depths present {present}"))
    gate(ok_sorted and present and q <= PDF_REL_TOL and mx <= bin_width,
         f"{label} disagrees with its plain version (max {mx:.3e}, "
         f"quantile {q:.3e}, sorted {ok_sorted}, present {present})")
    return mx


# #4's rows 3-5 (depth, acc, each sample's weight) against the plain
# compositing (fused_onepass._composite_fwd) of #1's raw heads on the same
# points, max|diff| / max|plain| per row: the heads #4 composites are #1's
# bits, so only the compositing's fp32 order differs (the warp's scan of
# the transmittance, the lane sums).
RENDER_HEADS_TOL = 1e-5
# #4's ragged ray counts: one ray, 3 rays (a group and a half at S = 192
# and 64: 2 rays a group) and 395 (198 groups, 132 + 66 on an H100: the
# last wave half empty, its last group one ray).
RAGGED_RAYS = (1, 3, 395)


def render_bf16_gates(label, op, v2, w, rows_in, kw, got=None):
    """#4 in bf16 on rows_in (pts, views, z row, |d| row): every row
    within ROWS_TOL of the plain version (unless `got` is given, gated by
    the caller), a second launch bit-identical, and rows 3-5 within
    RENDER_HEADS_TOL of the plain compositing of #1's raw heads on the
    same points. Returns max|diff| against the plain version (or 0)."""
    seg = kw["seg"]
    mx = 0.0
    with torch.no_grad():
        if got is None:
            got = op.render_level_T(w, *rows_in, **kw)
            torch.cuda.synchronize()
            want = op.plain_render_level_T(w, *rows_in, **kw)
            if not torch.isfinite(got).all():
                fail(f"{label}: output is not finite")
            errs = ((got - want).abs().amax(1)
                    / want.abs().amax(1).clamp_min(1e-30)).tolist()
            mx = (got - want).abs().max().item()
            log(f"{label} vs plain: per row max|diff|/max|plain| " + ", ".join(
                f"{k} {e:.2e}" for k, e in zip(ROW_NAMES, errs))
                + f" (tol {ROWS_TOL['bfloat16']:g})")
            gate(max(errs) < ROWS_TOL["bfloat16"],
                 f"{label} disagrees with its plain version "
                 f"({max(errs):.3e})")
        again = op.render_level_T(w, *rows_in, **kw)
        pts, views, z_row, dn_row = rows_in
        k = pts.shape[1] // seg
        raw = v2.fwd_T(w, pts, views, compute_dtype="bfloat16",
                       **{x: kw[x] for x in ("net_depth", "skips",
                                             "multires", "multires_views")})
        rgb, dep, acc, wt, _ = op._composite_fwd(
            raw.reshape(4, k, seg), z_row.reshape(k, seg),
            dn_row[0, ::seg], kw["white_bkgd"])
        comp = op._out_rows(rgb, dep, acc, wt, seg)
    same = torch.equal(got, again)
    rel = ((got[3:] - comp[3:]).abs().amax(1)
           / comp[3:].abs().amax(1).clamp_min(1e-30)).max().item()
    log(f"{label}: a second launch bit-identical {same}; rows 3-5 vs the "
        f"plain compositing of {v2.KERNEL}'s raw heads: per row "
        f"max|diff|/max|plain| {rel:.3e} (tol {RENDER_HEADS_TOL:g})")
    gate(same, f"{label}: a second launch gave other bits")
    gate(rel < RENDER_HEADS_TOL, f"{label} rows 3-5 are not the "
         f"compositing of {v2.KERNEL}'s heads ({rel:.3e})")
    return mx


def pdf_bound_ms(n_rays, s_c, s_i):
    """#8's least time: bytes per ray (z_c, w, u in; merged, z_s out)
    against the operations (the cdf, a binary search and an interpolation
    per draw, a merge rank per output) at the fp32 rate."""
    nbytes = 4 * (s_c + (s_c - 2) + s_i + (s_c + s_i) + s_i) * n_rays
    ops = n_rays * (3 * s_c + s_i * (2 * math.log2(s_c) + 8)
                    + (s_c + s_i) * 2 * math.log2(max(s_c, s_i)))
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FP32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def mip_resample_bound_ms(n_rays, s):
    """#9's least time: t, w, u in, t' out per ray, against the blur, the
    cdf, a binary search and an interpolation per draw at the fp32 rate."""
    nbytes = 4 * ((s + 1) + s + (s + 1) + (s + 1)) * n_rays
    ops = n_rays * (8 * s + (s + 1) * (2 * math.log2(s + 1) + 8))
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FP32_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def cli_switched_steps(label, dev, train_cli, sets, counted, expected):
    """The train CLI for TRAIN_STEPS steps with the switches on; checks
    each counted kernel's launches per step. Returns the counts."""
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", str(dev)] + [
            x for s_ in sets + [f"basedir={tmp}"] for x in ("--set", s_)]
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)
        res = train_cli.main(args + ["--num-steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        got = {k: getattr(mod, attr) for mod, attr, k in counted}
    log(f"{label}: steps {TRAIN_STEPS}, launches {got} (expected "
        f"{expected} per step), loss "
        f"{float(res.stats_history[-1]['loss']):.5f}")
    if got != {k: v * TRAIN_STEPS for k, v in expected.items()}:
        fail(f"{label} did not launch the kernels as expected: {got}")
    if res.state.step != TRAIN_STEPS or not all(
            np.isfinite(float(h["loss"])) for h in res.stats_history):
        fail(f"{label} ended at step {res.state.step} or with a non-finite "
             "loss")
    return got


def time_steps(cfg, dev, loop, batches):
    """ms per step of the configured kernel step over TIMED_STEPS steps
    (bench.py's count: host clock, one sync at the end)."""
    state = loop.init_state(cfg, dev)
    step_fn = loop.select_train_step(cfg, state.model)
    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        state, stats = step_fn(state, batches[i % len(batches)])
    float(stats["loss"])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / TIMED_STEPS


def switched_vanilla_phases(dev, card, configs, fm, v2, op, pdf_merge,
                            default_render_ms):
    """The vanilla paths with use_onepass_render and use_pdf_kernel: #8 at
    the render chunk's and the train step's shapes, #4 on a fine and a
    coarse chunk, the switched render, the one-pass step with the pdf
    kernel through the train CLI, its step guard and timings."""
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.core import sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    cfg = configs.Config(
        N_samples=64, N_importance=128, white_bkgd=True,
        compute_dtype="bfloat16", render_chunk_size=CHUNK,
        use_fused_render=True, use_onepass_render=True, use_pdf_kernel=True)
    s_c, s_i = cfg.N_samples, cfg.N_importance
    skips = op.model_skips(cfg.netdepth)
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    model = make_model(cfg, dev).eval()
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    n_rays = stacked.origins[..., 0].numel()
    chunk = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:CHUNK])
    n = chunk.origins.shape[0]
    span = float(cfg.far - cfg.near)
    bin_width = span / (s_c - 1)
    mlp_kw = dict(net_depth=cfg.netdepth, skips=skips, multires=cfg.multires,
                  multires_views=cfg.multires_views)

    def packed(level, dtype):
        return v2.pack(fm.flatten_params(getattr(model, level), True,
                                         cfg.netdepth),
                       compute_dtype=dtype, **mlp_kw)

    def level_rows(rays, z):
        k, s = z.shape
        pts, views = op._pts_views(rays.origins.T, rays.directions.T,
                                   rays.viewdirs.T, z)
        dn = op._rep_row(torch.linalg.norm(rays.directions, dim=-1),
                         s).contiguous()
        return pts, views, z.reshape(1, k * s).contiguous(), dn

    def coarse_weights(rays, z):
        """The coarse level's weights, from the plain level (#4's plain
        version) in bf16."""
        return op.plain_render_level_T(
            packed("coarse", "bfloat16"), *level_rows(rays, z), seg=s_c,
            white_bkgd=True, compute_dtype="bfloat16", **mlp_kw)[5].reshape(
                z.shape)

    # 17. #8 vs plain: the render chunk (deterministic draws) and the
    # flagship step's data and patch rays (ascending random draws).
    errs = {}
    with torch.no_grad():
        z_c = sampling.vanilla_z_vals(chunk.near, chunk.far, s_c, False,
                                      None)
        w_c = coarse_weights(chunk, z_c)
        render_in = (z_c.contiguous(), w_c[:, 1:-1].contiguous(),
                     pdf_merge.fine_z_draws(None, n, s_i, True,
                                            dev).contiguous())
        t_cfg = configs.Config(**FLAGSHIP, use_pdf_kernel=True)
        t_batch = to_device(VanillaBatcher(scene, t_cfg).next_batch(), dev)
        t_rays = step_lib.rays_from_batch(t_batch, t_cfg.near, t_cfg.far)
        nt = t_rays.origins.shape[0]
        p = t_cfg.n_patches * t_cfg.patch_size ** 2
        t_draws = step_lib.make_draws(t_cfg, nt, step_lib.step_generator(
            t_cfg.seed, 0, dev), dev)
        z_t = sampling.vanilla_z_vals(t_rays.near, t_rays.far, s_c, False,
                                      t_draws["t_rand"])
        w_t = coarse_weights(t_rays, z_t)
        cases = [("render chunk, deterministic draws", render_in)]
        for name, sl in (("step data rays", slice(p, nt)),
                         ("step patch rays", slice(0, p))):
            cases.append((f"{name}, ascending random draws",
                          (z_t[sl].contiguous(),
                           w_t[sl, 1:-1].contiguous(),
                           t_draws["u"][sl].contiguous())))
        for label, args in cases:
            got, got_s = pdf_merge.sample_pdf_merged(*args)
            torch.cuda.synchronize()
            want, want_s = pdf_merge.plain_sample_pdf_merged(*args)
            lab = f"{pdf_merge.KERNEL} vs plain, {label}, {args[0].shape[0]}"
            errs[label] = resample_gate(
                f"{lab} x {s_c}+{s_i}", got, want, span, bin_width,
                args[0])
            resample_gate(f"{lab}: the samples", got_s, want_s, span,
                          bin_width)
    pdf_err = errs[cases[0][0]]

    # 18. #4 vs plain on a fine and a coarse chunk, bf16 and fp32.
    with torch.no_grad():
        z_f = pdf_merge.fine_z_vals(z_c, w_c, s_i, det=True,
                                    use_kernel=True)
        fine_in, coarse_in = level_rows(chunk, z_f), level_rows(chunk, z_c)
        r_errs = {}
        for label, level, rows_in, seg, dtype in (
                ("fine bf16", "fine", fine_in, s_c + s_i, "bfloat16"),
                ("fine fp32", "fine", fine_in, s_c + s_i, "float32"),
                ("coarse bf16", "coarse", coarse_in, s_c, "bfloat16"),
                ("coarse fp32", "coarse", coarse_in, s_c, "float32")):
            w = packed(level, dtype)
            kw = dict(seg=seg, white_bkgd=True, compute_dtype=dtype,
                      **mlp_kw)
            got = op.render_level_T(w, *rows_in, **kw)
            torch.cuda.synchronize()
            want = op.plain_render_level_T(w, *rows_in, **kw)
            if not torch.isfinite(got).all():
                fail(f"{op.RENDER_KERNEL} {label}: output is not finite")
            row_errs = ((got - want).abs().amax(1)
                        / want.abs().amax(1).clamp_min(1e-30)).tolist()
            r_errs[label] = (got - want).abs().max().item()
            log(f"{op.RENDER_KERNEL} vs plain, {label} chunk, "
                f"N={rows_in[0].shape[1]}: max|diff| {r_errs[label]:.3e}, "
                "per row max|diff|/max|plain| " + ", ".join(
                    f"{k} {e:.2e}" for k, e in zip(ROW_NAMES, row_errs))
                + f" (tol {ROWS_TOL[dtype]:g})")
            gate(max(row_errs) < ROWS_TOL[dtype],
                 f"{op.RENDER_KERNEL} {label} disagrees with its plain "
                 f"version ({max(row_errs):.3e})")
            if dtype == "bfloat16":
                render_bf16_gates(f"{op.RENDER_KERNEL} {label} chunk", op,
                                  v2, w, rows_in, kw, got)
            del got, want
        # 18b. #4 in bf16 at the ragged ray counts, fine and coarse.
        for level, z_all, seg in (("fine", z_f, s_c + s_i),
                                  ("coarse", z_c, s_c)):
            w = packed(level, "bfloat16")
            kw = dict(seg=seg, white_bkgd=True, compute_dtype="bfloat16",
                      **mlp_kw)
            for k in RAGGED_RAYS:
                sub = chunk.map(lambda x: x[:k])
                render_bf16_gates(
                    f"{op.RENDER_KERNEL} bf16 {level}, {k} ray(s) x {seg}",
                    op, v2, w, level_rows(sub, z_all[:k].contiguous()), kw)

    # 19. The switched render of the 6 views: #4 per level and chunk, #8
    # per chunk, #1 never.
    render = render_lib.build_render_fn(model, cfg)
    v2.launches = op.render_launches = pdf_merge.launches = 0
    out = render(stacked)
    torch.cuda.synchronize()
    counts = (op.render_launches, pdf_merge.launches, v2.launches)
    n_chunks = -(-n_rays // CHUNK)
    log(f"switched render of {len(all_rays)} views: launches "
        f"{op.RENDER_KERNEL} {counts[0]}, {pdf_merge.KERNEL} {counts[1]}, "
        f"{v2.KERNEL} {counts[2]} (expected {2 * n_chunks}, {n_chunks}, 0)")
    if counts != (2 * n_chunks, n_chunks, 0):
        fail(f"the switched render launched {counts}")
    for k in ("rgb", "depth", "acc"):
        if not torch.isfinite(out[k]).all():
            fail(f"switched render output {k} is not finite")
    plain_out = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(all_rays[0])
    rgb_diff = (out["rgb"][0] - plain_out["rgb"]).abs().mean().item()
    log(f"view 0, switched vs plain render (bf16): mean|rgb diff| "
        f"{rgb_diff:.3e} (tol {RENDER_RGB_TOL:g})")
    gate(rgb_diff < RENDER_RGB_TOL,
         f"switched render disagrees with the plain render ({rgb_diff})")
    render_launches, pdf_launches = counts[0], counts[1]

    # 20. The one-pass step with use_pdf_kernel: the train CLI (#8 on the
    # data rays and the patch rays), the step guard, timings.
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", f"checkpoint_every={TRAIN_STEPS}",
            "use_pdf_kernel=true"] + [f"{k}={v}" for k, v in FLAGSHIP.items()]
    got = cli_switched_steps(
        "cli.train with use_pdf_kernel", dev, train_cli, sets,
        ((pdf_merge, "launches", pdf_merge.KERNEL),
         (op, "launches", op.KERNEL)), {pdf_merge.KERNEL: 2, op.KERNEL: 2})
    pdf_launches += got[pdf_merge.KERNEL]
    g_cfg = t_cfg.replace(N_rand=GUARD_N_RAND)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
    g_draws = step_lib.make_draws(g_cfg, g_batch["rgb"].shape[0],
                                  step_lib.step_generator(g_cfg.seed, 0,
                                                          dev), dev)
    guard_steps(f"step guard with use_pdf_kernel (N_rand {GUARD_N_RAND}, "
                "bf16)", op.build_onepass_vanilla_train_step(g_cfg),
                step_lib.build_vanilla_train_step(g_state.model, g_cfg),
                g_state, g_batch, g_draws)
    del g_state
    torch.cuda.empty_cache()
    batcher = VanillaBatcher(scene, t_cfg)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
    step_ms = {k: time_steps(t_cfg.replace(use_pdf_kernel=k), dev, loop,
                                batches)
               for k in (True, False)}
    log(f"{tag} train step (flagship, {nt} rays) with use_pdf_kernel: "
        f"{step_ms[True]:.2f} ms/step, {1e3 * nt / step_ms[True]:.1f} "
        f"rays/s; without it, same call: {step_ms[False]:.2f} ms/step, "
        f"{1e3 * nt / step_ms[False]:.1f} rays/s")

    # 21. Timings, tagged with the card.
    with torch.no_grad():
        wf, wc = packed("fine", "bfloat16"), packed("coarse", "bfloat16")
        kf = dict(seg=s_c + s_i, white_bkgd=True, compute_dtype="bfloat16",
                  **mlp_kw)
        kc = dict(kf, seg=s_c)
        ms4 = time_ms(lambda: op.render_level_T(wf, *fine_in, **kf), 5)
        ms4c = time_ms(lambda: op.render_level_T(wc, *coarse_in, **kc), 10)
        plain4 = time_ms(lambda: op.plain_render_level_T(wf, *fine_in,
                                                          **kf), 2)
        ms8 = time_ms(lambda: pdf_merge.sample_pdf_merged(*render_in), 50)
        plain8 = time_ms(lambda: pdf_merge.plain_sample_pdf_merged(
            *render_in), 10)
    render_ms = time_ms(lambda: render(stacked), 3)
    dev_ms, top = device_time(lambda: render(stacked))
    flops_pp = mlp_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                   cfg.multires, cfg.multires_views)
    wbytes = wf.w.numel() * 2 + wf.b.numel() * 4
    n_fine, n_coarse = fine_in[0].shape[1], coarse_in[0].shape[1]
    # #4 moves 7 floats in (points, views, z) and 6 out per point, and
    # |d| per ray.
    b4, by4 = bound_ms(n_fine, flops_pp, wbytes, PEAK_BF16_FLOPS,
                       52 + 4 / (s_c + s_i))
    b4c, _ = bound_ms(n_coarse, flops_pp, wbytes, PEAK_BF16_FLOPS,
                      52 + 4 / s_c)
    b8, by8 = pdf_bound_ms(n, s_c, s_i)
    log(f"{tag} {op.RENDER_KERNEL} bf16 fine chunk (N={n_fine}): "
        f"{ms4:.3f} ms/launch, bound {b4:.3f} ms ({by4}, "
        f"{100 * b4 / ms4:.1f}% of it); coarse (N={n_coarse}) {ms4c:.3f} "
        f"ms, bound {b4c:.3f} ({100 * b4c / ms4c:.1f}% of it); plain "
        f"version, fine: {plain4:.3f} ms")
    log(f"{tag} {pdf_merge.KERNEL} render chunk ({n} rays, {s_c}+{s_i}): "
        f"{1e3 * ms8:.1f} us/launch, bound {1e3 * b8:.2f} us ({by8}, "
        f"{100 * b8 / ms8:.1f}% of it); plain version {1e3 * plain8:.1f} us")
    log(f"{tag} switched render {len(all_rays)} views: {render_ms:.2f} ms, "
        f"{1e3 * n_rays / render_ms:.1f} rays/s; default fused render of "
        f"this run {default_render_ms:.2f} ms, "
        f"{1e3 * n_rays / default_render_ms:.1f} rays/s")
    if dev_ms is None:
        log(f"{tag} switched render device time: not measured (the "
            "profiler saw no device time)")
    else:
        log(f"{tag} profiled switched render: device time {dev_ms:.2f} ms, "
            f"{100 * dev_ms / render_ms:.1f}% of the event-timed render; "
            "by kernel: " + "; ".join(f"{k} {t:.2f} ms x{c}"
                                      for k, t, c in top))
    return {"json": {
        op.RENDER_KERNEL: dict(
            name=op.RENDER_KERNEL, route="cuda",
            source="consistentnerf_tpu_torch/csrc/render_level.cu",
            replaces="consistentnerf_tpu/ops/fused_onepass.py:508",
            launches=render_launches, max_abs_err=r_errs["fine bf16"],
            ms=ms4, plain_ms=plain4, bound_ms=b4, bound_by=by4,
            library_ms=None),
        pdf_merge.KERNEL: dict(
            name=pdf_merge.KERNEL, route="cuda",
            source="consistentnerf_tpu_torch/csrc/pdf_merge.cu",
            replaces="consistentnerf_tpu/ops/pdf_merge.py:158",
            launches=pdf_launches, max_abs_err=pdf_err, ms=ms8,
            plain_ms=plain8, bound_ms=b8, bound_by=by8, library_ms=None)}}


def switched_mip_phases(dev, card, configs, fm, fmip, op, pdf_merge,
                        default_render_ms):
    """The mip paths with use_pdf_kernel and disable_normals=false: #9 at
    the render chunk's and the train step's shapes, 6n on a render chunk,
    the switched mip render, the one-pass mip step with the pdf kernel
    through the train CLI, its step guard and timings."""
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.models.mlp import softplus
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    cfg = configs.Config(**{**MIP, "render_chunk_size": CHUNK,
                            "use_fused_render": True,
                            "use_pdf_kernel": True,
                            "disable_normals": False})
    kw = mip_mlp_kw(cfg)
    s = cfg.mip_num_samples
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    model = make_model(cfg, dev).eval()
    flat = [w.detach() for w in fmip.flatten_mip_params(model.mlp,
                                                        cfg.netdepth)]
    w16 = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, "bfloat16")
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    n_rays = stacked.origins[..., 0].numel()
    chunk = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:CHUNK])
    n = chunk.origins.shape[0]
    span = float(cfg.far - cfg.near)

    def streams(rays, samples):
        m, c = samples
        k = rays.origins.shape[0]
        views = rays.viewdirs.T[:, :, None].expand(3, k, s).reshape(
            3, k * s).contiguous()
        return (m.reshape(3, k * s).contiguous(),
                c.reshape(3, k * s).contiguous(), views)

    def level0(rays, t_rand):
        """Level 0's fenceposts and weights (plain #6 in bf16)."""
        t0, smp = sampling.sample_along_rays(
            t_rand, rays.origins, rays.directions, rays.radii, s,
            rays.near, rays.far, None, "cone", transposed=True)
        raw = fmip.plain_fwd_T(w16, *streams(rays, smp),
                               compute_dtype="bfloat16", **kw)
        k = rays.origins.shape[0]
        w = rendering.compute_alpha_weights(
            softplus(raw[3] + fmip.DENSITY_BIAS).reshape(k, s), t0,
            rays.directions)[0]
        return t0.contiguous(), w.contiguous()

    # 22. #9 vs plain: the render chunk (deterministic draws) and the mip
    # step's data and patch rays (jittered draws).
    with torch.no_grad():
        t0, w0 = level0(chunk, None)
        render_in = (t0, w0, sampling.piecewise_pdf_draws(
            None, (n,), s + 1, dev).contiguous(), cfg.resample_padding_final)
        t_cfg = configs.Config(**{**MIP, "use_pdf_kernel": True})
        t_batch = to_device(MipBatcher(scene, t_cfg).next_batch(), dev)
        t_rays = t_batch["rays"]
        nt, p = t_rays.origins.shape[0], MIP_PATCH
        t_draws = step_lib.make_mip_draws(t_cfg, nt, step_lib.step_generator(
            t_cfg.seed, 0, dev), dev)
        tt, wt = level0(t_rays, t_draws["t_rand"])
        u_t = sampling.piecewise_pdf_draws(t_draws["jitter"][1], (nt,),
                                           s + 1).contiguous()
        pad = step_lib.resample_padding(t_cfg, 0)
        cases = [("render chunk, deterministic draws", render_in)]
        for name, sl in (("step data rays", slice(p, nt)),
                         ("step patch rays", slice(0, p))):
            cases.append((f"{name}, jittered draws",
                          (tt[sl].contiguous(), wt[sl].contiguous(),
                           u_t[sl].contiguous(), pad)))
        errs9 = {}
        for label, args in cases:
            got = pdf_merge.mip_resample_t_vals(*args)
            torch.cuda.synchronize()
            want = pdf_merge.plain_mip_resample_t_vals(*args)
            errs9[label] = resample_gate(
                f"{pdf_merge.MIP_KERNEL} vs plain, {label}, "
                f"{args[0].shape[0]} x {s + 1}", got, want, span, span / s)
    mip_err = errs9[cases[0][0]]

    # 23. 6n vs plain on the render chunk's level 1, bf16 and fp32.
    with torch.no_grad():
        _, smp1 = sampling.resample_along_rays(
            None, chunk.origins, chunk.directions, chunk.radii, t0, w0,
            "cone", True, cfg.resample_padding_final, transposed=True,
            use_kernel=True)
        lvl1 = streams(chunk, smp1)
        n_errs, out = {}, {}
        for dtype in ("float32", "bfloat16"):
            w = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, dtype)
            got = fmip.fused_mip_mlp_normals_T(w, *lvl1, compute_dtype=dtype,
                                               **kw)
            torch.cuda.synchronize()
            want = fmip.plain_fwd_normals_T(w, *lvl1, compute_dtype=dtype,
                                            **kw)
            if not torch.isfinite(got).all():
                fail(f"{fmip.NORMALS_KERNEL} {dtype}: output is not finite")
            label = (f"{fmip.NORMALS_KERNEL} vs plain, render chunk level 1 "
                     f"{dtype}, N={got.shape[1]}")
            mip_fwd_gate(f"{label}, rows 0-3", got[:4], want[:4], dtype)
            n_errs[dtype] = (got - want).abs().max().item()
            if dtype == "float32":
                out["fp32"] = want
                rows = row_max_rel(got[4:], want[4:])
                log(f"{label}, rows 4-6 (d density / d means): max|diff| "
                    f"{(got[4:] - want[4:]).abs().max().item():.3e}, per "
                    f"row max|diff|/max|plain| {rows:.3e} (tol "
                    f"{NORMALS_FP32_TOL:g})")
                gate(rows < NORMALS_FP32_TOL,
                     f"{label} rows 4-6 disagree ({rows:.3e})")
            else:
                again = fmip.fused_mip_mlp_normals_T(
                    w, *lvl1, compute_dtype=dtype, **kw)
                six = fmip.fwd_T(w, *lvl1, compute_dtype=dtype, **kw)
                same6, rep_ = (torch.equal(got[:4], six),
                               torch.equal(got, again))
                log(f"{label}: rows 0-3 bit-identical to {fmip.KERNEL} "
                    f"{same6}; a second launch bit-identical {rep_}")
                gate(same6, f"{label} rows 0-3 are not {fmip.KERNEL}'s bits")
                gate(rep_, f"{label}: a second launch gave other bits")
                del again, six
                # Two plain computations that differ in sum order only.
                host = fmip.plain_fwd_normals_T(
                    fmip.pack([x.cpu() for x in flat], cfg.netdepth,
                              cfg.max_deg_point, dtype),
                    *[x[:, :NORMALS_HOST_POINTS].cpu() for x in lvl1],
                    compute_dtype=dtype, **kw)
                normals_bf16_gate(label, got, want, out["fp32"], host)
            del got, want
        del out

    # 24. The switched mip render: 6n per level and chunk, #9 per chunk,
    # #6 never.
    render = render_lib.build_render_fn(model, cfg)
    fmip.launches = fmip.normals_launches = pdf_merge.mip_launches = 0
    out = render(stacked)
    torch.cuda.synchronize()
    counts = (fmip.normals_launches, pdf_merge.mip_launches, fmip.launches)
    n_chunks = -(-n_rays // CHUNK)
    log(f"switched mip render of {len(all_rays)} views: launches "
        f"{fmip.NORMALS_KERNEL} {counts[0]}, {pdf_merge.MIP_KERNEL} "
        f"{counts[1]}, {fmip.KERNEL} {counts[2]} (expected "
        f"{cfg.mip_num_levels * n_chunks}, {n_chunks}, 0)")
    if counts != (cfg.mip_num_levels * n_chunks, n_chunks, 0):
        fail(f"the switched mip render launched {counts}")
    views_hw = (len(all_rays), scene.H, scene.W)
    for k in ("rgb", "depth", "acc", "normals"):
        shape = views_hw + ((3,) if k in ("rgb", "normals") else ())
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            fail(f"switched mip render output {k} has shape "
                 f"{tuple(out[k].shape)} or non-finite values")
    plain_out = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(all_rays[0])
    diffs = {k: (out[k][0] - plain_out[k]).abs().mean().item()
             for k in ("rgb", "normals")}
    log(f"view 0, switched vs plain mip render (bf16): mean|rgb diff| "
        f"{diffs['rgb']:.3e}, mean|normals diff| {diffs['normals']:.3e} "
        f"(tol {RENDER_RGB_TOL:g})")
    gate(max(diffs.values()) < RENDER_RGB_TOL,
         f"switched mip render disagrees with the plain render ({diffs})")
    normals_launches, mip_launches = counts[0], counts[1]

    # 25. The one-pass mip step with use_pdf_kernel: the train CLI (#9 on
    # the data rays' and the patch rays' level 1), the step guard, timings.
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", f"checkpoint_every={TRAIN_STEPS}",
            "use_pdf_kernel=true"] + [
        f"{k}={v}" for k, v in MIP.items() if k != "dataset_type"]
    got = cli_switched_steps(
        "mip cli.train with use_pdf_kernel", dev, train_cli, sets,
        ((pdf_merge, "mip_launches", pdf_merge.MIP_KERNEL),
         (op, "mip_launches", op.MIP_KERNEL)),
        {pdf_merge.MIP_KERNEL: 2, op.MIP_KERNEL: 2})
    mip_launches += got[pdf_merge.MIP_KERNEL]
    g_cfg = t_cfg.replace(N_rand=GUARD_N_RAND, randomized=False)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(MipBatcher(scene, g_cfg).next_batch(), dev)
    guard_steps(f"mip step guard with use_pdf_kernel (N_rand "
                f"{GUARD_N_RAND}, bf16)",
                op.build_onepass_mip_train_step(g_cfg),
                step_lib.build_mip_train_step(g_state.model, g_cfg), g_state,
                g_batch)
    del g_state
    torch.cuda.empty_cache()
    batcher = MipBatcher(scene, t_cfg)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
    step_ms = {k: time_steps(t_cfg.replace(use_pdf_kernel=k), dev, loop,
                                batches)
               for k in (True, False)}
    log(f"{tag} mip train step ({nt} rays) with use_pdf_kernel: "
        f"{step_ms[True]:.2f} ms/step, {1e3 * nt / step_ms[True]:.1f} "
        f"rays/s; without it, same call: {step_ms[False]:.2f} ms/step, "
        f"{1e3 * nt / step_ms[False]:.1f} rays/s")

    # 26. Timings, tagged with the card.
    with torch.no_grad():
        ms6n = time_ms(lambda: fmip.fused_mip_mlp_normals_T(
            w16, *lvl1, compute_dtype="bfloat16", **kw), 3)
        plain6n = time_ms(lambda: fmip.plain_fwd_normals_T(
            w16, *lvl1, compute_dtype="bfloat16", **kw), 1)
        ms9 = time_ms(lambda: pdf_merge.mip_resample_t_vals(*render_in), 50)
        plain9 = time_ms(lambda: pdf_merge.plain_mip_resample_t_vals(
            *render_in), 10)
    torch.cuda.reset_peak_memory_stats()
    render_ms = time_ms(lambda: render(stacked), 2)
    peak_memory(f"{tag} switched mip render {len(all_rays)} views")
    dev_ms, top = device_time(lambda: render(stacked))
    # 6n's work per point: the forward and the walk back through the
    # trunk (every trunk layer's product once more: the input gradient,
    # and the encoding's at layer 0 and the post-skip layer); 9 floats in,
    # 7 out.
    fwd_pp = mip_flops(cfg, fmip)
    pe, _ = enc_widths(cfg.max_deg_point, fmip.DEG_VIEW, ipe=True)
    width = cfg.netwidth
    trunk_macs = pe * width + sum(
        (width + pe if i in fmip.post_skip_layers(cfg.netdepth) else width)
        * width for i in range(1, cfg.netdepth))
    flops_pp = fwd_pp + 2 * trunk_macs
    npts = lvl1[0].shape[1]
    wbytes = w16.w.numel() * 2 + w16.b.numel() * 4
    b6n, by6n = bound_ms(npts, flops_pp, wbytes, PEAK_BF16_FLOPS, 64)
    b9, by9 = mip_resample_bound_ms(n, s)
    log(f"{tag} {fmip.NORMALS_KERNEL} bf16 render chunk (N={npts}): "
        f"{ms6n:.3f} ms/launch, bound {b6n:.3f} ms ({by6n}, {flops_pp} "
        f"FLOP/point, {100 * b6n / ms6n:.1f}% of it); plain version "
        f"{plain6n:.3f} ms")
    log(f"{tag} {pdf_merge.MIP_KERNEL} render chunk ({n} rays, {s + 1} "
        f"fenceposts): {1e3 * ms9:.1f} us/launch, bound {1e3 * b9:.2f} us "
        f"({by9}, {100 * b9 / ms9:.1f}% of it); plain version "
        f"{1e3 * plain9:.1f} us")
    log(f"{tag} switched mip render {len(all_rays)} views: {render_ms:.2f} "
        f"ms, {1e3 * n_rays / render_ms:.1f} rays/s; default fused mip "
        f"render of this run {default_render_ms:.2f} ms, "
        f"{1e3 * n_rays / default_render_ms:.1f} rays/s")
    if dev_ms is None:
        log(f"{tag} switched mip render device time: not measured (the "
            "profiler saw no device time)")
    else:
        log(f"{tag} profiled switched mip render: device time {dev_ms:.2f} "
            f"ms, {100 * dev_ms / render_ms:.1f}% of the event-timed "
            "render; by kernel: " + "; ".join(f"{k} {t:.2f} ms x{c}"
                                              for k, t, c in top))
    return {
        "json": dict(
            name=fmip.NORMALS_KERNEL, route="cuda",
            source="consistentnerf_tpu_torch/csrc/fused_mip_fwd.cu",
            replaces="consistentnerf_tpu/ops/fused_mip.py:768",
            launches=normals_launches, max_abs_err=n_errs["bfloat16"],
            ms=ms6n, plain_ms=plain6n, bound_ms=b6n, bound_by=by6n,
            library_ms=None),
        "mip_json": dict(
            name=pdf_merge.MIP_KERNEL, route="cuda",
            source="consistentnerf_tpu_torch/csrc/mip_resample.cu",
            replaces="consistentnerf_tpu/ops/pdf_merge.py:284",
            launches=mip_launches, max_abs_err=mip_err, ms=ms9,
            plain_ms=plain9, bound_ms=b9, bound_by=by9, library_ms=None)}


# The two-call fused steps (PR 5): the flagship with softLpmask, whose two
# prediction-dependent denominators send it to the two-call step, once per
# fused_kernel; the launches each kind makes per step of #1, #2, #10, #11.
TWOCALL = dict(FLAGSHIP, hardmask=False, softLpmask=True)
TWOCALL_LAUNCHES = {"v2": (2, 2, 0, 0), "v2row": (0, 0, 2, 2),
                    "v2h": (0, 0, 0, 2)}
# A row-major kernel against the transposed one on the same points, fp32:
# the same walk, so bit-identical; otherwise max|diff| / max|T| under this.
ROW_VS_T_TOL = 1e-6
# The RegNeRF regularizer of the JAX package's regnerf3 settings
# (configs/scenes.py:78-87) at its batch_size_random and patch size. Its
# depth_tvnorm_mask_weight is left at 0 there, which makes the TV term 0
# in both packages; the JAX package's own test of the step sets 1, and so
# does this script, so the guards see the TV norm's gradients.
REGNERF_TV = dict(
    depth_tvnorm_loss_mult=0.1, depth_tvnorm_decay=True,
    depth_tvnorm_maxstep=512, depth_tvnorm_loss_mult_start=400.0,
    depth_tvnorm_loss_mult_end=0.1, depth_tvnorm_mask_weight=1.0,
    anneal_nearfar=True, load_random_rays=True, batch_size_random=2048,
    random_patch_size=8)
MIP_TV = dict(MIP, compute_disp_metrics=True, **REGNERF_TV)


def row_vs_t(label, got, want_T):
    """Log and gate a row-major result [N, C] (or a grad list) against the
    transposed kernel's on the same points; returns max|diff|."""
    if isinstance(got, torch.Tensor):
        got, want_T = [got], [want_T.T]
    same = all(torch.equal(a, b) for a, b in zip(got, want_T))
    mx = max((a - b).abs().max().item() for a, b in zip(got, want_T))
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(got, want_T))
    log(f"{label}: row-major vs transposed kernel, bit-identical {same}, "
        f"max|diff| {mx:.3e}, max|diff|/max|T| {rel:.3e} (tol "
        f"{ROW_VS_T_TOL:g})")
    return same, rel, mx


def rowmajor_kernel_phases(dev, card, configs, fm, v2, fmip, op):
    """27. Kernels #10 / #11 at the two-call step's shapes and #15 / #16 at
    the mip level, against their plain versions and against the
    transposed kernels on the same points (in bf16 bit for bit: one walk
    under two layouts), with a bf16 repeat; #11 and #16 at the ragged
    sizes; the op fused_mip_mlp_train through autograd (its path);
    timings."""
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (MipBatcher,
                                                        VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.ops import pdf_merge
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    cfg = configs.Config(**TWOCALL)
    skips = op.model_skips(cfg.netdepth)
    mlp_kw = dict(net_depth=cfg.netdepth, skips=skips,
                  multires=cfg.multires, multires_views=cfg.multires_views)
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    state = loop.init_state(cfg, dev)
    batch = to_device(VanillaBatcher(scene, cfg).next_batch(), dev)
    n = batch["rgb"].shape[0]
    draws = step_lib.make_draws(
        cfg, n, step_lib.step_generator(cfg.seed, 0, dev), dev)
    rays = step_lib.rays_from_batch(batch, cfg.near, cfg.far)
    flat = {lvl: [w.detach() for w in fm.flatten_params(
        getattr(state.model, lvl), True, cfg.netdepth)]
        for lvl in ("coarse", "fine")}

    def row_streams(z):
        s = z.shape[1]
        pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
        views = rays.viewdirs[:, None].expand(n, s, 3)
        return (pts.reshape(n * s, 3).contiguous(),
                views.reshape(n * s, 3).contiguous())

    # The level inputs as the two-call step makes them: every ray, coarse
    # depths from t_rand, fine depths from the coarse weights.
    with torch.no_grad():
        z_c = sampling.vanilla_z_vals(rays.near, rays.far, cfg.N_samples,
                                      False, draws["t_rand"])
        pc, vc = row_streams(z_c)
        raw = v2.plain_fwd_row(flat["coarse"], pc, vc,
                               compute_dtype="bfloat16", **mlp_kw)
        w_c = rendering.raw2outputs(raw.reshape(n, -1, 4), z_c,
                                    rays.directions, None, True)[3]
        z_f = pdf_merge.fine_z_vals(z_c, w_c, cfg.N_importance,
                                    u=draws["u"], det=False)
        levels = {"fine": row_streams(z_f), "coarse": (pc, vc)}
    gen = torch.Generator(device=dev).manual_seed(7)
    g = {lvl: 1e-3 * torch.randn((x[0].shape[0], 4), generator=gen,
                                 device=dev) for lvl, x in levels.items()}
    log(f"row-major kernels at the two-call step's shapes: {n} rays, "
        f"coarse {levels['coarse'][0].shape[0]} and fine "
        f"{levels['fine'][0].shape[0]} points")
    errs = {}
    for dtype in ("bfloat16", "float32"):
        for lvl in ("fine", "coarse"):
            w = v2.pack(flat[lvl], compute_dtype=dtype, **mlp_kw)
            pts, views = levels[lvl]
            pts_T, views_T = pts.T.contiguous(), views.T.contiguous()
            got = v2.fwd(w, pts, views, compute_dtype=dtype, **mlp_kw)
            torch.cuda.synchronize()
            want = v2.plain_fwd_row(w, pts, views, compute_dtype=dtype,
                                    **mlp_kw)
            if not torch.isfinite(got).all():
                fail(f"{v2.ROW_KERNEL} {lvl} {dtype}: non-finite output")
            rel, mx = rel_err(got, want)
            tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
            errs[(v2.ROW_KERNEL, lvl, dtype)] = mx
            log(f"{v2.ROW_KERNEL} vs plain, {lvl} {dtype}, N={pts.shape[0]}"
                f": max|diff| {mx:.3e}, max|diff|/mean|plain| {rel:.3e} "
                f"(tol {tol:g})")
            gate(rel < tol, f"{v2.ROW_KERNEL} {lvl} {dtype} disagrees with "
                 f"its plain version ({rel:.3e})")
            same, rel_t, _ = row_vs_t(
                f"{v2.ROW_KERNEL} {lvl} {dtype}", got,
                v2.fwd_T(w, pts_T, views_T, compute_dtype=dtype, **mlp_kw))
            if dtype == "float32":
                gate(same or rel_t < ROW_VS_T_TOL,
                     f"{v2.ROW_KERNEL} {lvl} disagrees with {v2.KERNEL}")
            else:
                # bf16: one Hopper walk under the two layouts.
                gate(same, f"{v2.ROW_KERNEL} {lvl} bf16 is not bit-identical"
                     f" to {v2.KERNEL} on the same points")
            del got, want
            got = v2.bwd(w, pts, views, g[lvl], compute_dtype=dtype,
                         **mlp_kw)
            torch.cuda.synchronize()
            want = v2.plain_bwd_row(w, pts, views, g[lvl],
                                    compute_dtype=dtype, **mlp_kw)
            rel, mx = grads_err(got, want)
            errs[(v2.ROW_BWD_KERNEL, lvl, dtype)] = mx
            log(f"{v2.ROW_BWD_KERNEL} vs plain, {lvl} {dtype}: dW max|diff| "
                f"{mx:.3e}, max rel L2 {rel:.3e} (tol "
                f"{TRAIN_DW_TOL[dtype]:g})")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"{v2.ROW_BWD_KERNEL} {lvl} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype], f"{v2.ROW_BWD_KERNEL} {lvl} "
                 f"{dtype} disagrees with its plain version ({rel:.3e})")
            del want
            # The same walk in both dtypes (bf16: the level walk, whose
            # row-major staging changes no value or order): the same bits.
            same, rel_t, _ = row_vs_t(
                f"{v2.ROW_BWD_KERNEL} {lvl} {dtype}", got,
                v2.bwd_T(w, pts_T, views_T, g[lvl].T.contiguous(),
                         compute_dtype=dtype, **mlp_kw))
            if dtype == "float32":
                gate(same or rel_t < ROW_VS_T_TOL, f"{v2.ROW_BWD_KERNEL} "
                     f"{lvl} disagrees with {v2.BWD_KERNEL}")
            else:
                gate(same, f"{v2.ROW_BWD_KERNEL} {lvl} bf16 is not "
                     f"bit-identical to {v2.BWD_KERNEL} on the same points")
            del got, pts_T, views_T
            torch.cuda.empty_cache()

    # #11 at the ragged sizes (the fine level's weights, seeded points).
    ragged_bwd_gates(
        v2.ROW_BWD_KERNEL,
        lambda dtype: v2.pack(flat["fine"], compute_dtype=dtype, **mlp_kw),
        row_nerf_streams,
        lambda w, pts, views, g, dtype: v2.bwd(
            w, pts, views, g, compute_dtype=dtype, **mlp_kw),
        lambda w, pts, views, g, dtype: v2.plain_bwd_row(
            w, pts, views, g, compute_dtype=dtype, **mlp_kw), dev, row=True)

    # Timings, bf16: the row-major kernels, the transposed kernels on the
    # same points (same call, same card), the plain versions.
    fwd_pp = mlp_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                 cfg.multires, cfg.multires_views)
    train_pp = mlp_train_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                         cfg.multires, cfg.multires_views)
    rows, times = [], {}
    for kern, tkern, kfn, tfn, plain, flops, bpp, replaces in (
            (v2.ROW_KERNEL, v2.KERNEL, v2.fwd, v2.fwd_T, v2.plain_fwd_row,
             fwd_pp, 40, "consistentnerf_tpu/ops/fused_mlp_v2.py:528"),
            (v2.ROW_BWD_KERNEL, v2.BWD_KERNEL, v2.bwd, v2.bwd_T,
             v2.plain_bwd_row, train_pp, 40,
             "consistentnerf_tpu/ops/fused_mlp_v2.py:644")):
        res = {}
        for lvl in ("fine", "coarse"):
            w = v2.pack(flat[lvl], compute_dtype="bfloat16", **mlp_kw)
            pts, views = levels[lvl]
            pts_T, views_T = pts.T.contiguous(), views.T.contiguous()
            fwd = kern == v2.ROW_KERNEL
            extra = () if fwd else (g[lvl],)
            extra_T = () if fwd else (g[lvl].T.contiguous(),)
            iters = (5 if fwd else 2) if lvl == "fine" else (10 if fwd else 4)
            with torch.no_grad():
                ms = time_ms(lambda: kfn(w, pts, views, *extra,
                                         compute_dtype="bfloat16",
                                         **mlp_kw), iters)
                ms_T = time_ms(lambda: tfn(w, pts_T, views_T, *extra_T,
                                           compute_dtype="bfloat16",
                                           **mlp_kw), iters)
            # Weights read once in bf16; the bwd also writes dW and db
            # once in fp32.
            numel = w.w.numel() + w.b.numel()
            wbytes = (w.w.numel() * 2 + w.b.numel() * 4) if fwd else \
                6 * numel
            bound, by = bound_ms(pts.shape[0], flops, wbytes,
                                 PEAK_BF16_FLOPS, bpp)
            res[lvl] = (ms, bound, by)
            times[(kern, lvl)] = ms
            plan = ("; plan: " + fwd_plan_text(
                v2.fwd_plan(w, pts.shape[0], row=True)) if fwd else "")
            log(f"{tag} {kern} bf16 {lvl} (N={pts.shape[0]}): {ms:.3f} "
                f"ms/launch ({1e6 * ms / pts.shape[0]:.2f} ns/point); "
                f"{tkern} on the same points {ms_T:.3f} ms "
                f"({100 * (ms / ms_T - 1):+.1f}%); bound {bound:.3f} ms "
                f"({by}, {100 * bound / ms:.1f}% of it, "
                f"{100 * bound / ms_T:.1f}% of {tkern}'s){plan}")
            del pts_T, views_T
        w = v2.pack(flat["fine"], compute_dtype="bfloat16", **mlp_kw)
        pts, views = levels["fine"]
        extra = () if kern == v2.ROW_KERNEL else (g["fine"],)
        with torch.no_grad():
            plain_ms = time_ms(lambda: plain(w, pts, views, *extra,
                                             compute_dtype="bfloat16",
                                             **mlp_kw), 1)
        log(f"{tag} plain version of {kern}, bf16 fine: {plain_ms:.3f} ms")
        torch.cuda.empty_cache()
        ms, bound, by = res["fine"]
        rows.append(dict(
            name=kern, route="cuda",
            source=("consistentnerf_tpu_torch/csrc/fused_mlp_fwd.cu"
                    if kern == v2.ROW_KERNEL else
                    "consistentnerf_tpu_torch/csrc/fused_mlp_bwd.cu"),
            replaces=replaces, max_abs_err=errs[(kern, "fine", "bfloat16")],
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
    del levels, g
    torch.cuda.empty_cache()

    # #15 / #16 at the mip two-call step's level: 4096 rays x 96 samples.
    mcfg = configs.Config(**MIP)
    kw = mip_mlp_kw(mcfg)
    mstate = loop.init_state(mcfg, dev)
    mbatch = to_device(MipBatcher(scene, mcfg).next_batch(), dev)
    mrays = mbatch["rays"]
    nm, s = mrays.origins.shape[0], mcfg.mip_num_samples
    mdraws = step_lib.make_mip_draws(
        mcfg, nm, step_lib.step_generator(mcfg.seed, 0, dev), dev)
    with torch.no_grad():
        _, (means, covs) = sampling.sample_along_rays(
            mdraws["t_rand"], mrays.origins, mrays.directions, mrays.radii,
            s, mrays.near, mrays.far, None, "cone")
    means = means.reshape(nm * s, 3).contiguous()
    covs = covs.reshape(nm * s, 3).contiguous()
    mviews = mrays.viewdirs[:, None].expand(nm, s, 3).reshape(
        nm * s, 3).contiguous()
    streams_T = [x.T.contiguous() for x in (means, covs, mviews)]
    mflat = fmip.flatten_mip_params(mstate.model.mlp, mcfg.netdepth)
    mflat_d = [w.detach() for w in mflat]
    gm = 1e-3 * torch.randn((nm * s, 4), generator=gen, device=dev)
    log(f"{fmip.ROW_KERNEL} / {fmip.ROW_BWD_KERNEL} at the mip level: {nm} "
        f"rays x {s} samples = {nm * s} points")
    for dtype in ("bfloat16", "float32"):
        w = fmip.pack(mflat_d, mcfg.netdepth, mcfg.max_deg_point, dtype)
        got = fmip.fwd(w, means, covs, mviews, compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        want = fmip.plain_fwd_row(w, means, covs, mviews,
                                  compute_dtype=dtype, **kw)
        if not torch.isfinite(got).all():
            fail(f"{fmip.ROW_KERNEL} {dtype}: non-finite output")
        errs[(fmip.ROW_KERNEL, dtype)] = mip_fwd_gate(
            f"{fmip.ROW_KERNEL} vs plain, {dtype}", got.T, want.T, dtype)
        same, rel_t, _ = row_vs_t(
            f"{fmip.ROW_KERNEL} {dtype}", got,
            fmip.fwd_T(w, *streams_T, compute_dtype=dtype, **kw))
        if dtype == "float32":
            gate(same or rel_t < ROW_VS_T_TOL,
                 f"{fmip.ROW_KERNEL} disagrees with {fmip.KERNEL}")
        else:
            # bf16: one Hopper walk under the two layouts.
            gate(same, f"{fmip.ROW_KERNEL} bf16 is not bit-identical to "
                 f"{fmip.KERNEL} on the same points")
            repeat_gate(f"{fmip.ROW_KERNEL} mip level", [got], [fmip.fwd(
                w, means, covs, mviews, compute_dtype=dtype, **kw)])
        del got, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got = fmip.bwd(w, means, covs, mviews, gm, compute_dtype=dtype, **kw)
        torch.cuda.synchronize()
        peak_memory(f"{fmip.ROW_BWD_KERNEL} {dtype} at the mip level "
                    f"({nm * s} points)")
        want = fmip.plain_bwd_row(w, means, covs, mviews, gm,
                                  compute_dtype=dtype, **kw)
        rel, mx = grads_err(got, want)
        errs[(fmip.ROW_BWD_KERNEL, dtype)] = mx
        log(f"{fmip.ROW_BWD_KERNEL} vs plain, {dtype}: dW max|diff| "
            f"{mx:.3e}, max rel L2 {rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g})")
        if not all(torch.isfinite(x).all() for x in got):
            fail(f"{fmip.ROW_BWD_KERNEL} {dtype}: non-finite dW")
        gate(rel < TRAIN_DW_TOL[dtype], f"{fmip.ROW_BWD_KERNEL} {dtype} "
             f"disagrees with its plain version ({rel:.3e})")
        del want
        same, rel_t, _ = row_vs_t(
            f"{fmip.ROW_BWD_KERNEL} {dtype}", got,
            fmip.bwd_T(w, *streams_T, gm.T.contiguous(),
                       compute_dtype=dtype, **kw))
        if dtype == "float32":
            gate(same or rel_t < ROW_VS_T_TOL,
                 f"{fmip.ROW_BWD_KERNEL} disagrees with {fmip.BWD_KERNEL}")
        else:
            # bf16: the level walk under the two layouts, whose row-major
            # staging changes no value or order.
            gate(same, f"{fmip.ROW_BWD_KERNEL} bf16 is not bit-identical "
                 f"to {fmip.BWD_KERNEL} on the same points")
            repeat_gate(f"{fmip.ROW_BWD_KERNEL} mip level", got, fmip.bwd(
                w, means, covs, mviews, gm, compute_dtype=dtype, **kw))
        del got
        torch.cuda.empty_cache()

    # #16 at the ragged sizes (the mip level's weights, seeded Gaussians),
    # and bit for bit #7's on the same points in bf16.
    ragged_bwd_gates(
        fmip.ROW_BWD_KERNEL,
        lambda dtype: fmip.pack(mflat_d, mcfg.netdepth, mcfg.max_deg_point,
                                dtype),
        row_mip_streams,
        lambda w, m, c, v, g_, dtype: fmip.bwd(
            w, m, c, v, g_, compute_dtype=dtype, **kw),
        lambda w, m, c, v, g_, dtype: fmip.plain_bwd_row(
            w, m, c, v, g_, compute_dtype=dtype, **kw), dev, row=True,
        twin=(fmip.BWD_KERNEL, lambda w, m, c, v, g_, dtype: fmip.bwd_T(
            w, m.T.contiguous(), c.T.contiguous(), v.T.contiguous(),
            g_.T.contiguous(), compute_dtype=dtype, **kw)))

    # 28. The op's path: fused_mip_mlp_train forward and, by autograd, its
    # weight grads at the mip level (one launch of #15 and of #16).
    fmip.row_launches = fmip.row_bwd_launches = 0
    leaves = [w.clone().requires_grad_() for w in mflat_d]
    raw = fmip.fused_mip_mlp_train(leaves, means, covs, mviews,
                                   compute_dtype="bfloat16", **kw)
    (raw * gm).sum().backward()
    torch.cuda.synchronize()
    op_launches = {fmip.ROW_KERNEL: fmip.row_launches,
                   fmip.ROW_BWD_KERNEL: fmip.row_bwd_launches}
    log(f"fused_mip_mlp_train forward + backward: launches {op_launches} "
        "(expected 1 of each)")
    if list(op_launches.values()) != [1, 1]:
        fail(f"fused_mip_mlp_train did not launch #15 and #16 once each: "
             f"{op_launches}")
    if not all(torch.isfinite(w.grad).all() for w in leaves):
        fail("fused_mip_mlp_train: non-finite grads")

    def op_step():
        for w in leaves:
            w.grad = None
        out = fmip.fused_mip_mlp_train(leaves, means, covs, mviews,
                                       compute_dtype="bfloat16", **kw)
        (out * gm).sum().backward()
    op_ms = time_ms(op_step, 3)
    log(f"{tag} fused_mip_mlp_train forward + backward, bf16 (N={nm * s}): "
        f"{op_ms:.3f} ms (the op's #15 and #16 and the torch work around "
        "them)")
    del leaves, raw

    w16 = fmip.pack(mflat_d, mcfg.netdepth, mcfg.max_deg_point, "bfloat16")
    mip_fwd_pp = mip_flops(mcfg, fmip)
    mip_train_pp = mip_flops(mcfg, fmip, train=True)
    wbytes = w16.w.numel() * 2 + w16.b.numel() * 4
    for kern, tkern, kfn, tfn, plain, flops, bpp, nwb, replaces in (
            (fmip.ROW_KERNEL, fmip.KERNEL, fmip.fwd, fmip.fwd_T,
             fmip.plain_fwd_row, mip_fwd_pp, 52, wbytes,
             "consistentnerf_tpu/ops/fused_mip.py:488"),
            (fmip.ROW_BWD_KERNEL, fmip.BWD_KERNEL, fmip.bwd, fmip.bwd_T,
             fmip.plain_bwd_row, mip_train_pp, 52,
             6 * (w16.w.numel() + w16.b.numel()),
             "consistentnerf_tpu/ops/fused_mip.py:527")):
        fwd = kern == fmip.ROW_KERNEL
        extra = () if fwd else (gm,)
        extra_T = () if fwd else (gm.T.contiguous(),)
        with torch.no_grad():
            ms = time_ms(lambda: kfn(w16, means, covs, mviews, *extra,
                                     compute_dtype="bfloat16", **kw),
                         10 if fwd else 3)
            ms_T = time_ms(lambda: tfn(w16, *streams_T, *extra_T,
                                       compute_dtype="bfloat16", **kw),
                           10 if fwd else 3)
            plain_ms = time_ms(lambda: plain(w16, means, covs, mviews,
                                             *extra,
                                             compute_dtype="bfloat16",
                                             **kw), 1)
        bound, by = bound_ms(nm * s, flops, nwb, PEAK_BF16_FLOPS, bpp)
        plan = ("; plan: " + fwd_plan_text(fmip.fwd_plan(
            w16, nm * s, row=True)) if fwd else "")
        log(f"{tag} {kern} bf16 (N={nm * s}): {ms:.3f} ms/launch "
            f"({1e6 * ms / (nm * s):.2f} ns/point); {tkern} on the same "
            f"points {ms_T:.3f} ms ({100 * (ms / ms_T - 1):+.1f}%); bound "
            f"{bound:.3f} ms ({by}, {100 * bound / ms:.1f}% of it, "
            f"{100 * bound / ms_T:.1f}% of {tkern}'s); plain version "
            f"{plain_ms:.3f} ms{plan}")
        rows.append(dict(
            name=kern, route="cuda",
            source=("consistentnerf_tpu_torch/csrc/fused_mip_fwd.cu"
                    if fwd else
                    "consistentnerf_tpu_torch/csrc/fused_mip_bwd.cu"),
            replaces=replaces, launches=op_launches[kern],
            max_abs_err=errs[(kern, "bfloat16")], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None))
    del means, covs, mviews, streams_T, gm
    torch.cuda.empty_cache()
    return {"json": rows}


def cli_train_twice(label, sets, dev, counted, expected, check=None):
    """The train CLI for TRAIN_STEPS steps and a resume for 2, with the
    launch counts set to 0 before each run and read after: each run must
    launch `expected[k]` of kernel k per step. Returns the first run's
    counts and the last stats."""
    from consistentnerf_tpu_torch.cli import train as train_cli

    launches, last = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", str(dev)] + [
            x for s_ in sets + [f"basedir={tmp}"] for x in ("--set", s_)]
        for steps, run in ((TRAIN_STEPS, "train"),
                           (TRAIN_STEPS + 2, "resume")):
            for mod, attr, _ in counted:
                setattr(mod, attr, 0)
            res = train_cli.main(args + ["--num-steps", str(steps)])
            torch.cuda.synchronize()
            got = {k: getattr(mod, attr) for mod, attr, k in counted}
            ran = steps - (0 if run == "train" else TRAIN_STEPS)
            last = res.stats_history[-1]
            log(f"{label} cli.train {run}: steps {ran}, launches {got} "
                f"(expected per step {expected}), loss "
                f"{float(last['loss']):.5f}")
            if any(got[k] != expected[k] * ran for k in got):
                fail(f"{label}: the train path launched {got}, expected "
                     f"{expected} per step")
            if res.state.step != steps or not all(
                    np.isfinite(float(h["loss"])) for h in
                    res.stats_history):
                fail(f"{label} cli.train {run} ended at step "
                     f"{res.state.step} or with a non-finite loss")
            if run == "train":
                launches = got
                ckpts = os.listdir(os.path.join(tmp, "exp", "checkpoints"))
                if f"step_{TRAIN_STEPS:08d}.pt" not in ckpts:
                    fail(f"{label} cli.train wrote no checkpoint")
            if check is not None:
                check(last)
    return launches, last


def bench_steps(label, tag, step_fn, state, batches, n_rays, bound=None):
    """bench.py's count: TIMED_STEPS steps over alternating batches, host
    clock, one sync, and the peak device memory; then one profiled step.
    Returns ms/step."""
    torch.cuda.reset_peak_memory_stats()
    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_STEPS):
        state, stats = step_fn(state, batches[i % len(batches)])
    float(stats["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = 1e3 * dt / TIMED_STEPS
    extra = ("" if bound is None else f"; bf16 bound {bound:.2f} ms "
             f"({100 * bound / step_ms:.1f}% of it)")
    log(f"{tag} {label}: {step_ms:.2f} ms/step, "
        f"{TIMED_STEPS * n_rays / dt:.1f} rays/s over {TIMED_STEPS} steps"
        + extra)
    peak_memory(f"{tag} {label}")
    dev_ms, top = device_time(lambda: step_fn(state, batches[1]))
    if dev_ms is None:
        log(f"{tag} {label} device time: not measured (the profiler saw no "
            "device time)")
    else:
        log(f"{tag} profiled {label}: device time {dev_ms:.2f} ms of "
            f"{step_ms:.2f} ms/step, idle share "
            f"{max(0.0, 1 - dev_ms / step_ms):.3f}; by kernel: " + "; ".join(
                f"{k} {t:.2f} ms x{c}" for k, t, c in top))
    return step_ms


def twocall_phases(dev, card, configs, fm, v2, op, render_ms):
    """29-32. The vanilla two-call step through the train CLI for each
    fused_kernel, its timings and guards, and the v2row render."""
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.ops import fused_train
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    counted = ((v2, "launches", v2.KERNEL), (v2, "bwd_launches",
                                             v2.BWD_KERNEL),
               (v2, "row_launches", v2.ROW_KERNEL),
               (v2, "row_bwd_launches", v2.ROW_BWD_KERNEL),
               (op, "launches", op.KERNEL))
    base_sets = ["dataset_type=synthetic",
                 f"synthetic_views={SCENE['n_views']}",
                 f"synthetic_hw={SCENE['H']}",
                 "synthetic_interleave_test=false", "i_print=1",
                 f"checkpoint_every={TRAIN_STEPS}"]
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    launches = {v2.ROW_KERNEL: 0, v2.ROW_BWD_KERNEL: 0}
    step_ms = {}
    # 29. The train CLI, 3 steps and a resume, then bench.py's timing.
    for kind, per_step in TWOCALL_LAUNCHES.items():
        cfg = configs.Config(**{**TWOCALL, "fused_kernel": kind})
        expected = dict(zip((v2.KERNEL, v2.BWD_KERNEL, v2.ROW_KERNEL,
                             v2.ROW_BWD_KERNEL), per_step), **{op.KERNEL: 0})
        got, _ = cli_train_twice(
            f"two-call step {kind}",
            base_sets + [f"{k}={v}" for k, v in TWOCALL.items()]
            + [f"fused_kernel={kind}"], dev, counted, expected)
        for k in launches:
            launches[k] += got[k]
        t_state = loop.init_state(cfg, dev)
        step_fn = loop.select_train_step(cfg, t_state.model)
        batcher = VanillaBatcher(scene, cfg)
        batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
        step_ms[kind] = bench_steps(f"two-call train step {kind} (softLpmask, "
                                   f"{batches[0]['rgb'].shape[0]} rays)", tag,
                                   step_fn, t_state, batches,
                                   batches[0]["rgb"].shape[0])
        del t_state, batches
        torch.cuda.empty_cache()

    # 30. The guards: the two-call step (each kind) vs the eager step on
    # the same draws; at the hardmask flagship, which both kernel steps
    # accept, the two-call v2 step vs the one-pass step.
    g_cfg = configs.Config(**{**TWOCALL, "N_rand": GUARD_N_RAND})
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
    g_draws = step_lib.make_draws(
        g_cfg, g_batch["rgb"].shape[0],
        step_lib.step_generator(g_cfg.seed, 0, dev), dev)
    eager = step_lib.build_vanilla_train_step(g_state.model, g_cfg)
    for kind in TWOCALL_LAUNCHES:
        guard_steps(f"two-call step guard {kind} vs eager (softLpmask, "
                    f"N_rand {GUARD_N_RAND}, bf16)",
                    fused_train.build_fused_vanilla_train_step(
                        g_cfg.replace(fused_kernel=kind)),
                    eager, g_state, g_batch, g_draws)
    h_cfg = configs.Config(**{**FLAGSHIP, "N_rand": GUARD_N_RAND})
    guard_steps(f"two-call v2 step vs the one-pass step (hardmask, N_rand "
                f"{GUARD_N_RAND}, bf16)",
                fused_train.build_fused_vanilla_train_step(h_cfg),
                op.build_onepass_vanilla_train_step(h_cfg), g_state,
                to_device(VanillaBatcher(scene, h_cfg).next_batch(), dev),
                step_lib.make_draws(h_cfg, g_batch["rgb"].shape[0],
                                    step_lib.step_generator(0, 0, dev), dev))
    del g_state
    torch.cuda.empty_cache()

    # 31. The v2row render of the 6-view scene: #10 for every chunk.
    cfg = configs.Config(N_samples=64, N_importance=128, white_bkgd=True,
                         compute_dtype="bfloat16", render_chunk_size=CHUNK,
                         use_fused_render=True, fused_kernel="v2row")
    model = make_model(cfg, dev).eval()
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    render = render_lib.build_render_fn(model, cfg)
    v2.launches = v2.row_launches = 0
    out = render(stacked)
    torch.cuda.synchronize()
    got = {v2.ROW_KERNEL: v2.row_launches, v2.KERNEL: v2.launches}
    expected = 2 * (-(-stacked.origins[..., 0].numel() // CHUNK))
    log(f"v2row render of {len(all_rays)} views: launches {got} (expected "
        f"{expected} of {v2.ROW_KERNEL}, 0 of {v2.KERNEL})")
    if got != {v2.ROW_KERNEL: expected, v2.KERNEL: 0}:
        fail(f"the v2row render launched {got}")
    launches[v2.ROW_KERNEL] += expected
    plain_out = render_lib.build_render_fn(
        model, cfg.replace(use_fused_render=False))(all_rays[0])
    rgb_diff = (out["rgb"][0] - plain_out["rgb"]).abs().mean().item()
    log(f"view 0, v2row vs plain render (bf16): mean|rgb diff| "
        f"{rgb_diff:.3e} (tol {RENDER_RGB_TOL:g})")
    gate(rgb_diff < RENDER_RGB_TOL, f"the v2row render disagrees with the "
         f"plain render ({rgb_diff})")
    ms = time_ms(lambda: render(stacked), 2)
    # #10 per launch at the render chunk's shapes (seeded points).
    skips = op.model_skips(cfg.netdepth)
    mlp_kw = dict(net_depth=cfg.netdepth, skips=skips,
                  multires=cfg.multires, multires_views=cfg.multires_views)
    fwd_pp = mlp_flops_per_point(cfg.netdepth, cfg.netwidth, skips,
                                 cfg.multires, cfg.multires_views)
    w10 = v2.pack(fm.flatten_params(model.fine, True, cfg.netdepth),
                  compute_dtype="bfloat16", **mlp_kw)
    gen = torch.Generator().manual_seed(0)
    for level, s_ in (("fine", cfg.N_samples + cfg.N_importance),
                      ("coarse", cfg.N_samples)):
        n10 = CHUNK * s_
        p10 = (torch.rand(n10, 3, generator=gen) * 4 - 2).to(dev)
        v10 = torch.randn(n10, 3, generator=gen)
        v10 = (v10 / v10.norm(dim=1, keepdim=True)).to(dev)
        with torch.no_grad():
            ms10 = time_ms(lambda: v2.fwd(w10, p10, v10,
                                          compute_dtype="bfloat16",
                                          **mlp_kw), 5)
        b10, by10 = bound_ms(n10, fwd_pp, w10.w.numel() * 2
                             + w10.b.numel() * 4, PEAK_BF16_FLOPS)
        log(f"{tag} {v2.ROW_KERNEL} bf16 {level} render chunk (N={n10}): "
            f"{ms10:.3f} ms/launch, bound {b10:.3f} ms ({by10}, "
            f"{100 * b10 / ms10:.1f}% of it); {got[v2.ROW_KERNEL] // 2} "
            f"launches a level in the v2row render; plan: "
            f"{fwd_plan_text(v2.fwd_plan(w10, n10, row=True))}")
        del p10, v10
    log(f"{tag} v2row render {len(all_rays)} views: {ms:.2f} ms, "
        f"{stacked.origins[..., 0].numel() / ms * 1e3:.1f} rays/s; default "
        f"(v2) render in this run {render_ms:.2f} ms "
        f"({100 * (ms / render_ms - 1):+.1f}%)")
    del model, out, plain_out
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms}


# The v1 slice: the launches of #12, #13, #14 per two-call step of each v1
# kind; the small shapes of #12 beyond the production MLP (depth, skips,
# multires, multires_views, use_viewdirs): a skip into the heads, the
# use_viewdirs=False output head, and multires 21 (past the TPU v2
# kernel's 20-frequency register).
V1_LAUNCHES = {"v1": (0, 2, 2), "hybrid": (0, 0, 2)}
V1_SHAPES = {"skip into the heads": (5, (4,), 10, 4, True),
             "output head": (5, (4,), 10, 4, False),
             "multires 21": (8, (4,), 21, 4, True)}
V1_SMALL_N = 100_003
# #12 in bf16 against its plain version: both round at the same points,
# and a flipped rounding from the order of the fp32 sums moves an output
# by ~2e-3 wherever it lands (2.221e-3 on the fine render chunk, 1.997e-3
# on the coarse one, 2.509e-3 at multires 21; H100 80GB HBM3, 700 W). The
# fine chunk's outputs average 0.180, so max|diff| / mean|plain| reads
# 1.23e-2 there; the coarse chunk's average 0.099 and the multires-21
# heads' 0.118, where the same flips read 2.013e-2 and 2.122e-2. These two
# take the gates of MIP_BF16_ROW_TOL (each row's max|diff| / max|plain|,
# and mean|diff| / mean|plain|, which a wrong rounding point moves to the
# bf16-vs-fp32 level); every other reading keeps max|diff| / mean|plain|
# < BF16_TOL.
V1_SMALL_MEAN = ("coarse", "multires 21")


def v1_fwd_gate(label, got, want, dtype, small_mean=False):
    """Log and gate #12's [N, C] output against its plain version (see
    V1_SMALL_MEAN); returns max|diff|."""
    if small_mean and dtype == "bfloat16":
        return mip_fwd_gate(label, got.T, want.T, dtype)
    rel, mx = rel_err(got, want)
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    log(f"{label}: max|diff| {mx:.3e}, max|diff|/mean|plain| {rel:.3e} "
        f"(tol {tol:g})")
    gate(rel < tol, f"{label} disagrees with its plain version ({rel:.3e})")
    return mx

# The hard masks on the card against the same function on CPU tensors:
# the share of train pixels that may differ, all of them on the boundary
# rule (reproject.boundary_pixels).
MASK_DIFF_SHARE = 1e-4


def v1_phases(dev, card, configs, fm, v2, op, render_ms, twocall_ms):
    """35-40. The v1 kernels: #12 against its plain version at the
    render's chunk shapes and at small sizes with v1's extra shapes; #13
    and #14 at the two-call step's levels (#12 / #13 in bf16 bit-identical
    to #10 and to a repeat, #14 across repeats); the v1 and hybrid
    renders; the v1 and hybrid two-call steps through the train CLI
    (fused_kernel=v1 / hybrid), timed and guarded against the eager step;
    compute_hard_masks on the card against the CPU."""
    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.core import rendering, sampling
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.models.mlp import NeRFMLP
    from consistentnerf_tpu_torch.ops import fused_mlp_train as fmt
    from consistentnerf_tpu_torch.ops import fused_train, pdf_merge
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    skips = (4,)
    kw = dict(net_depth=8, skips=skips, multires=10, multires_views=4)
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    rcfg = configs.Config(N_samples=64, N_importance=128, white_bkgd=True,
                          compute_dtype="bfloat16", render_chunk_size=CHUNK,
                          use_fused_render=True, fused_kernel="v1")
    model = make_model(rcfg, dev).eval()
    flat = {lvl: [w.detach() for w in fm.flatten_params(getattr(model, lvl))]
            for lvl in ("coarse", "fine")}
    all_rays = [evaluation.camera_rays_for_view(scene, p, device=dev)
                for p in scene.poses]
    stacked = render_lib.stack_rays(all_rays)
    n_rays = stacked.origins[..., 0].numel()

    def row_streams(rays, z):
        n, s = z.shape
        pts = rays.origins[:, None] + rays.directions[:, None] * z[..., None]
        views = rays.viewdirs[:, None].expand(n, s, 3)
        return (pts.reshape(n * s, 3).contiguous(),
                views.reshape(n * s, 3).contiguous())

    # 35. #12 at the render's shapes: the first 8192-ray chunk of view 0,
    # coarse (64 samples) and fine (64 + 128) levels, bf16 and fp32, with
    # the gates of V1_SMALL_MEAN.
    chunk = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:CHUNK])
    with torch.no_grad():
        z_c = sampling.vanilla_z_vals(chunk.near, chunk.far, 64, False, None)
        pc, vc = row_streams(chunk, z_c)
        raw_c = fm._mlp_body(pc, vc, flat["coarse"],
                             compute_dtype="bfloat16", **kw)
        w_c = rendering.raw2outputs(raw_c.reshape(CHUNK, -1, 4), z_c,
                                    chunk.directions, None, True)[3]
        z_f = pdf_merge.fine_z_vals(z_c, w_c, 128)
        rlevels = {"fine": row_streams(chunk, z_f), "coarse": (pc, vc)}
    if rlevels["fine"][0].shape[0] != CHUNK * 192:
        fail(f"#12 fine chunk has {rlevels['fine'][0].shape[0]} points")
    errs = {}
    for dtype in ("bfloat16", "float32"):
        for lvl in ("fine", "coarse"):
            w = fm.pack_v1(flat[lvl], compute_dtype=dtype, **kw)
            pts, views = rlevels[lvl]
            with torch.no_grad():
                got = fm.fused_mlp(w, pts, views, compute_dtype=dtype, **kw)
                torch.cuda.synchronize()
                want = fm._mlp_body(pts, views, flat[lvl],
                                    compute_dtype=dtype, **kw)
            if not torch.isfinite(got).all():
                fail(f"{fm.KERNEL} (#12) {lvl} {dtype}: non-finite output")
            errs[("#12", lvl, dtype)] = v1_fwd_gate(
                f"{fm.KERNEL} (#12) vs plain, render {lvl} chunk {dtype}, "
                f"N={pts.shape[0]}", got, want, dtype,
                small_mean=lvl == "coarse")
            if dtype == "bfloat16":
                w10 = v2.pack(flat[lvl], compute_dtype=dtype, **kw)
                with torch.no_grad():
                    r10 = v2.fwd(w10, pts, views, compute_dtype=dtype, **kw)
                v1_bit_gates(f"render {lvl} chunk", fm, fmt, v2, w10, w, pts,
                             views, r10, kw)
                del r10
            del got, want
    # The shapes v1 takes beyond the v2 kernels, at a small size.
    gen = torch.Generator(device=dev).manual_seed(11)
    pts_s = torch.rand(V1_SMALL_N, 3, generator=gen, device=dev) * 4 - 2
    views_s = torch.nn.functional.normalize(
        torch.randn(V1_SMALL_N, 3, generator=gen, device=dev), dim=-1)
    gen_s = torch.Generator(device=dev).manual_seed(13)  # #14's cotangents
    for label, (depth, sk, mr, mv, uv) in V1_SHAPES.items():
        mlp = NeRFMLP(net_depth=depth, net_width=256,
                      input_ch=3 * (1 + 2 * mr),
                      input_ch_views=3 * (1 + 2 * mv), skips=sk,
                      use_viewdirs=uv, output_ch=5)
        mlp.reset_parameters(torch.Generator().manual_seed(2))
        ws = [x.detach().to(dev) for x in fm.flatten_params(mlp, uv, depth)]
        skw = dict(net_depth=depth, skips=sk, multires=mr,
                   multires_views=mv, use_viewdirs=uv)
        skw_t = {k: v for k, v in skw.items() if k != "use_viewdirs"}
        for dtype in ("bfloat16", "float32"):
            with torch.no_grad():
                got = fm.fused_mlp(ws, pts_s, views_s, compute_dtype=dtype,
                                   **skw)
                torch.cuda.synchronize()
                want = fm._mlp_body(pts_s, views_s, ws, compute_dtype=dtype,
                                    **skw)
            if not torch.isfinite(got).all():
                fail(f"#12 {label} {dtype}: non-finite output")
            v1_fwd_gate(f"{fm.KERNEL} (#12) vs plain, {label} (depth "
                        f"{depth}, multires {mr}, out {tuple(got.shape)}) "
                        f"{dtype}", got, want, dtype,
                        small_mean=label in V1_SMALL_MEAN)
            if not uv:  # #14's op always has the view branch
                continue
            # #14 at the same shape against its plain version, with the
            # plan it picks (the level walk in bf16 where it fits).
            out = (ctypes.c_longlong * 9)()
            err = v2._entry(fmt.BWD_KERNEL, fmt.BWD_KERNEL + "_plan", 0, 7)(
                V1_SMALL_N, depth, 256, sum(1 << s_ for s_ in sk), mr, mv,
                int(dtype == "bfloat16"), out)
            if err:
                fail(f"{fmt.BWD_KERNEL}_plan failed at {label}")
            g_s = 1e-3 * torch.randn((V1_SMALL_N, 4), generator=gen_s,
                                     device=dev)
            got = fmt.backward(ws, pts_s, views_s, g_s, compute_dtype=dtype,
                               **skw_t)
            torch.cuda.synchronize()
            rel, mx = grads_err(got, fmt.plain_backward(
                ws, pts_s, views_s, g_s, compute_dtype=dtype, **skw_t))
            log(f"{fmt.BWD_KERNEL} (#14) vs plain, {label} (depth {depth}, "
                f"multires {mr}) {dtype}: dW max|diff| {mx:.3e}, max rel L2 "
                f"{rel:.3e} (tol {TRAIN_DW_TOL[dtype]:g}); plan: "
                f"{level_plan_text(out)}")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"#14 {label} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype], f"#14 {label} {dtype} disagrees "
                 f"with its plain version ({rel:.3e})")
            del got, g_s
    del pts_s, views_s

    # 36. #13 and #14 at the two-call step's levels (softLpmask flagship,
    # 5120 rays: coarse 327,680 and fine 983,040 points), bf16 and fp32.
    cfg = configs.Config(**TWOCALL)
    state = loop.init_state(cfg, dev)
    batch = to_device(VanillaBatcher(scene, cfg).next_batch(), dev)
    n = batch["rgb"].shape[0]
    draws = step_lib.make_draws(
        cfg, n, step_lib.step_generator(cfg.seed, 0, dev), dev)
    rays = step_lib.rays_from_batch(batch, cfg.near, cfg.far)
    tflat = {lvl: [w.detach() for w in fm.flatten_params(
        getattr(state.model, lvl), True, cfg.netdepth)]
        for lvl in ("coarse", "fine")}
    with torch.no_grad():
        z_c = sampling.vanilla_z_vals(rays.near, rays.far, cfg.N_samples,
                                      False, draws["t_rand"])
        pc, vc = row_streams(rays, z_c)
        raw = fmt.plain_forward(tflat["coarse"], pc, vc,
                                compute_dtype="bfloat16", **kw)
        w_c = rendering.raw2outputs(raw.reshape(n, -1, 4), z_c,
                                    rays.directions, None, True)[3]
        z_f = pdf_merge.fine_z_vals(z_c, w_c, cfg.N_importance,
                                    u=draws["u"], det=False)
        levels = {"fine": row_streams(rays, z_f), "coarse": (pc, vc)}
    g = {lvl: 1e-3 * torch.randn((x[0].shape[0], 4), generator=gen,
                                 device=dev) for lvl, x in levels.items()}
    log(f"v1 train kernels at the two-call step's shapes: {n} rays, coarse "
        f"{levels['coarse'][0].shape[0]} and fine "
        f"{levels['fine'][0].shape[0]} points")
    for dtype in ("bfloat16", "float32"):
        for lvl in ("fine", "coarse"):
            w = fm.pack_v1(tflat[lvl], compute_dtype=dtype, **kw)
            pts, views = levels[lvl]
            with torch.no_grad():
                got = fmt.forward(w, pts, views, compute_dtype=dtype, **kw)
                torch.cuda.synchronize()
                want = fmt.plain_forward(w, pts, views, compute_dtype=dtype,
                                         **kw)
            rel, mx = rel_err(got, want)
            tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
            errs[("#13", lvl, dtype)] = mx
            log(f"{fm.KERNEL} (#13) vs plain, {lvl} {dtype}, "
                f"N={pts.shape[0]}: max|diff| {mx:.3e}, max|diff|/mean|plain|"
                f" {rel:.3e} (tol {tol:g})")
            if not torch.isfinite(got).all():
                fail(f"#13 {lvl} {dtype}: non-finite output")
            gate(rel < tol, f"#13 {lvl} {dtype} disagrees with its plain "
                 f"version ({rel:.3e})")
            if dtype == "bfloat16":
                w10 = v2.pack(tflat[lvl], compute_dtype=dtype, **kw)
                with torch.no_grad():
                    r10 = v2.fwd(w10, pts, views, compute_dtype=dtype, **kw)
                v1_bit_gates(f"two-call {lvl} level", fm, fmt, v2, w10, w,
                             pts, views, r10, kw)
                del r10
            del got, want
            got = fmt.backward(w, pts, views, g[lvl], compute_dtype=dtype,
                               **kw)
            again = fmt.backward(w, pts, views, g[lvl], compute_dtype=dtype,
                                 **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            # At 8x256 (skip after layer 4) v1's heads read h alone: #14
            # is #11's walk on #11's offsets, so it gives #11's bits.
            again = v2.bwd(v2.pack(tflat[lvl], compute_dtype=dtype, **kw),
                           pts, views, g[lvl], compute_dtype=dtype, **kw)
            same11 = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"{fmt.BWD_KERNEL} (#14) {lvl} {dtype}: bit-identical to "
                f"{v2.ROW_BWD_KERNEL} (#11) on the same points {same11}")
            if dtype == "bfloat16":
                gate(same11, f"#14 {lvl} bf16 is not bit-identical to #11")
            del again
            want = fmt.plain_backward(w, pts, views, g[lvl],
                                      compute_dtype=dtype, **kw)
            rel, mx = grads_err(got, want)
            errs[("#14", lvl, dtype)] = mx
            log(f"{fmt.BWD_KERNEL} (#14) vs plain, {lvl} {dtype}: dW "
                f"max|diff| {mx:.3e}, max rel L2 {rel:.3e} (tol "
                f"{TRAIN_DW_TOL[dtype]:g}); two runs bit-identical {same}")
            if not all(torch.isfinite(x).all() for x in got):
                fail(f"#14 {lvl} {dtype}: non-finite dW")
            gate(rel < TRAIN_DW_TOL[dtype], f"#14 {lvl} {dtype} disagrees "
                 f"with its plain version ({rel:.3e})")
            gate(same, f"#14 {lvl} {dtype}: two runs differ")
            del got, want
            torch.cuda.empty_cache()

    # #14 at the ragged sizes (the fine level's weights, seeded points).
    ragged_bwd_gates(
        fmt.BWD_KERNEL,
        lambda dtype: fm.pack_v1(tflat["fine"], compute_dtype=dtype, **kw),
        row_nerf_streams,
        lambda w, pts, views, g_, dtype: fmt.backward(
            w, pts, views, g_, compute_dtype=dtype, **kw),
        lambda w, pts, views, g_, dtype: fmt.plain_backward(
            w, pts, views, g_, compute_dtype=dtype, **kw), dev, row=True)

    # Timings, bf16: #12 at the render chunk, #13 / #14 at the step's
    # levels, the plain versions on the same inputs.
    fwd_pp = mlp_flops_per_point(8, 256, skips, 10, 4)
    train_pp = mlp_train_flops_per_point(8, 256, skips, 10, 4)
    rows, times = [], {}
    for key, kern, fn, plain, lv, wsrc, flops, extra, replaces in (
            ("#12", fm.KERNEL, fm.fused_mlp,
             lambda w, p, v, **k: fm._mlp_body(p, v, w, **k), rlevels, flat,
             fwd_pp, False, "consistentnerf_tpu/ops/fused_mlp.py:187"),
            ("#13", fm.KERNEL, fmt.forward, fmt.plain_forward, levels,
             tflat, fwd_pp, False,
             "consistentnerf_tpu/ops/fused_mlp_train.py:204"),
            ("#14", fmt.BWD_KERNEL, fmt.backward, fmt.plain_backward,
             levels, tflat, train_pp, True,
             "consistentnerf_tpu/ops/fused_mlp_train.py:258")):
        for lvl in ("fine", "coarse"):
            w = fm.pack_v1(wsrc[lvl], compute_dtype="bfloat16", **kw)
            pts, views = lv[lvl]
            args = (w, pts, views) + ((g[lvl],) if extra else ())
            iters = (2 if extra else 5) if lvl == "fine" else (
                4 if extra else 10)
            with torch.no_grad():
                ms = time_ms(lambda: fn(*args, compute_dtype="bfloat16",
                                       **kw), iters)
            wbytes = (6 * (w.w.numel() + w.b.numel()) if extra else
                      w.w.numel() * 2 + w.b.numel() * 4)
            bound, by = bound_ms(pts.shape[0], flops, wbytes,
                                 PEAK_BF16_FLOPS)
            times[(key, lvl)] = (ms, bound, by)
            plan = ("" if extra else
                    f"; plan: {fwd_plan_text(fm.fwd_plan(w, pts.shape[0]))}")
            log(f"{tag} {kern} ({key}) bf16 {lvl} (N={pts.shape[0]}): "
                f"{ms:.3f} ms/launch ({1e6 * ms / pts.shape[0]:.2f} ns/point)"
                f"; bound {bound:.3f} ms ({by}, {100 * bound / ms:.1f}% of "
                f"it){plan}")
        w = fm.pack_v1(wsrc["fine"], compute_dtype="bfloat16", **kw)
        pts, views = lv["fine"]
        args = (w.flat, pts, views) + ((g["fine"],) if extra else ())
        with torch.no_grad():
            plain_ms = time_ms(lambda: plain(*args, compute_dtype="bfloat16",
                                             **kw), 1)
        log(f"{tag} plain version of {key}, bf16 fine: {plain_ms:.3f} ms")
        ms, bound, by = times[(key, "fine")]
        rows.append(dict(
            name=f"{kern} ({key})", route="cuda",
            source=("consistentnerf_tpu_torch/csrc/fused_mlp_v1_bwd.cu"
                    if extra else
                    "consistentnerf_tpu_torch/csrc/fused_mlp_v1_fwd.cu"),
            replaces=replaces, max_abs_err=errs[(key, "fine", "bfloat16")],
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None))
        torch.cuda.empty_cache()
    del levels, rlevels, g, state
    torch.cuda.empty_cache()

    # 37. The v1 and hybrid renders of the 6-view scene: #12 for every
    # chunk and level, no #1 or #10.
    launches = {"#12": 0, "#13": 0, "#14": 0}
    render_ms_v1 = {}
    for kind in fm.V1_KINDS:
        cfg_r = rcfg.replace(fused_kernel=kind)
        render = render_lib.build_render_fn(model, cfg_r)
        fm.launches = v2.launches = v2.row_launches = 0
        out = render(stacked)
        torch.cuda.synchronize()
        got = {"#12": fm.launches, v2.KERNEL: v2.launches,
               v2.ROW_KERNEL: v2.row_launches}
        expected = 2 * (-(-n_rays // CHUNK))
        log(f"{kind} render of {len(all_rays)} views: launches {got} "
            f"(expected {expected} of #12, none of the others)")
        if got != {"#12": expected, v2.KERNEL: 0, v2.ROW_KERNEL: 0}:
            fail(f"the {kind} render launched {got}")
        launches["#12"] += expected
        for k, shape in (("rgb", (6, 128, 128, 3)), ("depth", (6, 128, 128))):
            if tuple(out[k].shape) != shape or not torch.isfinite(
                    out[k]).all():
                fail(f"{kind} render output {k}: shape "
                     f"{tuple(out[k].shape)} or non-finite values")
        plain_out = render_lib.build_render_fn(
            model, cfg_r.replace(use_fused_render=False))(all_rays[0])
        rgb_diff = (out["rgb"][0] - plain_out["rgb"]).abs().mean().item()
        log(f"view 0, {kind} vs plain render (bf16): mean|rgb diff| "
            f"{rgb_diff:.3e} (tol {RENDER_RGB_TOL:g})")
        gate(rgb_diff < RENDER_RGB_TOL, f"the {kind} render disagrees with "
             f"the plain render ({rgb_diff})")
        ms = time_ms(lambda: render(stacked), 2)
        render_ms_v1[kind] = ms
        log(f"{tag} {kind} render {len(all_rays)} views: {ms:.2f} ms, "
            f"{n_rays / ms * 1e3:.1f} rays/s; default (v2) render in this "
            f"run {render_ms:.2f} ms ({100 * (ms / render_ms - 1):+.1f}%)")
        del out, plain_out, render
        torch.cuda.empty_cache()
    del model

    # 38-39. The v1 and hybrid two-call steps through the train CLI
    # (--set fused_kernel=v1 / hybrid: 3 steps, a checkpoint, a resume),
    # bench.py's timing, and the guards against the eager step.
    counted = ((fm, "launches", "#12"), (fmt, "fwd_launches", "#13"),
               (fmt, "bwd_launches", "#14"), (v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (v2, "row_launches", v2.ROW_KERNEL),
               (v2, "row_bwd_launches", v2.ROW_BWD_KERNEL),
               (op, "launches", op.KERNEL))
    base_sets = ["dataset_type=synthetic",
                 f"synthetic_views={SCENE['n_views']}",
                 f"synthetic_hw={SCENE['H']}",
                 "synthetic_interleave_test=false", "i_print=1",
                 f"checkpoint_every={TRAIN_STEPS}"]
    step_ms = {}
    for kind, per_step in V1_LAUNCHES.items():
        expected = {k: 0 for _, _, k in counted}
        expected.update(zip(("#12", "#13", "#14"), per_step))
        got, _ = cli_train_twice(
            f"two-call step {kind}",
            base_sets + [f"{k}={v}" for k, v in TWOCALL.items()]
            + [f"fused_kernel={kind}"], dev, counted, expected)
        for k in ("#13", "#14"):
            launches[k] += got[k]
        cfg = configs.Config(**{**TWOCALL, "fused_kernel": kind})
        t_state = loop.init_state(cfg, dev)
        step_fn = loop.select_train_step(cfg, t_state.model)
        batcher = VanillaBatcher(scene, cfg)
        batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
        step_ms[kind] = bench_steps(
            f"two-call train step {kind} (softLpmask, "
            f"{batches[0]['rgb'].shape[0]} rays)", tag, step_fn, t_state,
            batches, batches[0]["rgb"].shape[0])
        log(f"{tag} two-call step {kind} vs v2row in this run: "
            f"{step_ms[kind]:.2f} / {twocall_ms['v2row']:.2f} ms; vs v2h "
            f"{twocall_ms['v2h']:.2f} ms")
        del t_state, batches
        torch.cuda.empty_cache()
    g_cfg = configs.Config(**{**TWOCALL, "N_rand": GUARD_N_RAND})
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
    g_draws = step_lib.make_draws(
        g_cfg, g_batch["rgb"].shape[0],
        step_lib.step_generator(g_cfg.seed, 0, dev), dev)
    eager = step_lib.build_vanilla_train_step(g_state.model, g_cfg)
    for kind in fm.V1_KINDS:
        guard_steps(f"two-call step guard {kind} vs eager (softLpmask, "
                    f"N_rand {GUARD_N_RAND}, bf16)",
                    fused_train.build_fused_vanilla_train_step(
                        g_cfg.replace(fused_kernel=kind)),
                    eager, g_state, g_batch, g_draws)
    del g_state
    torch.cuda.empty_cache()

    # 40. compute_hard_masks on the card for the train views of the CLI's
    # scene split, against the same function on CPU tensors.
    ms_scene = synthetic.make_scene(**SCENE).to_scene_data(
        n_test=2, interleave_test=False)
    margs = (ms_scene.poses, ms_scene.depths, ms_scene.K, ms_scene.i_train,
             ms_scene.H, ms_scene.W)
    got = reproject.compute_hard_masks(*margs, device=dev)
    want = reproject.compute_hard_masks(*margs, device="cpu")
    near = reproject.boundary_pixels(*margs, device="cpu")
    diff = got != want
    n_px = len(ms_scene.i_train) * ms_scene.H * ms_scene.W
    log(f"compute_hard_masks on the card vs CPU tensors ({len(margs[3])} "
        f"train views of {ms_scene.H}x{ms_scene.W}): {int(diff.sum())} "
        f"pixels differ, {int((diff & ~near).sum())} of them off the "
        f"boundary rule ({int(near.sum())} boundary pixels; tol "
        f"{MASK_DIFF_SHARE:g} of {n_px}); on-share "
        f"{got[ms_scene.i_train].mean():.4f}")
    gate(not (diff & ~near).any() and diff.sum() <= MASK_DIFF_SHARE * n_px,
         "the hard masks on the card disagree with the CPU")
    t0 = time.perf_counter()
    for _ in range(3):
        reproject.compute_hard_masks(*margs, device=dev)
    mask_ms = 1e3 * (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    reproject.compute_hard_masks(*margs, device="cpu")
    mask_cpu_ms = 1e3 * (time.perf_counter() - t0)
    log(f"{tag} compute_hard_masks on the card: {mask_ms:.2f} ms per call "
        f"(host clock, result in host memory); on CPU tensors "
        f"{mask_cpu_ms:.2f} ms")
    for r in rows:
        r["launches"] = launches[r["name"].split("(")[1][:3]]
    return {"json": rows, "step_ms": step_ms, "render_ms": render_ms_v1}


def mip_tv_phases(dev, card, configs, fm, fmip, op):
    """33-34. The mip two-call step (disp metrics) and the one-pass mip
    step, both with the RegNeRF TV norm on random-pose rays, through the
    train CLI, timed and guarded against the eager mip step."""
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
    from consistentnerf_tpu_torch.data.random_poses import \
        generate_random_poses
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    counted = ((fmip, "launches", fmip.KERNEL),
               (fmip, "bwd_launches", fmip.BWD_KERNEL),
               (op, "mip_launches", op.MIP_KERNEL))
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    poses = generate_random_poses(scene.poses[scene.i_train])
    base_sets = ["dataset_type=synthetic",
                 f"synthetic_views={SCENE['n_views']}",
                 f"synthetic_hw={SCENE['H']}",
                 "synthetic_interleave_test=false", "i_print=1",
                 f"checkpoint_every={TRAIN_STEPS}"]

    def tv_engaged(stats):
        tv = np.asarray(stats["patch_tv_losses"])
        if not (tv.shape == (2,) and np.all(np.isfinite(tv)) and tv[-1] > 0):
            fail(f"the TV norm did not engage: patch_tv_losses {tv}")

    step_ms = {}
    for label, kw, expected in (
            ("mip two-call step (disp metrics, TV)", MIP_TV,
             {fmip.KERNEL: 4, fmip.BWD_KERNEL: 4, op.MIP_KERNEL: 0}),
            ("one-pass mip step (TV)", dict(MIP, **REGNERF_TV),
             {fmip.KERNEL: 4, fmip.BWD_KERNEL: 4, op.MIP_KERNEL: 2})):
        cli_train_twice(label, base_sets + [
            f"{k}={v}" for k, v in kw.items() if k != "dataset_type"],
            dev, counted, expected, check=tv_engaged)
        cfg = configs.Config(**kw)
        t_state = loop.init_state(cfg, dev)
        step_fn = loop.select_train_step(cfg, t_state.model)
        batcher = MipBatcher(scene, cfg, random_poses=poses)
        batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
        n = batches[0]["rays"].origins.shape[0]
        nr = batches[0]["rays_random"].origins.shape[0]
        step_ms[label] = bench_steps(f"{label} ({n} + {nr} random-pose rays)",
                                    tag, step_fn, t_state, batches, n + nr)
        del t_state, batches
        torch.cuda.empty_cache()
        # The guard against the eager mip step, randomized=False (a
        # stochastic level 1 magnifies ~1e-7 differences).
        g_cfg = cfg.replace(N_rand=GUARD_N_RAND, randomized=False)
        g_state = loop.init_state(g_cfg, dev)
        g_batch = to_device(MipBatcher(scene, g_cfg, random_poses=poses)
                            .next_batch(), dev)
        guard_steps(f"{label} guard vs eager (N_rand {GUARD_N_RAND}, "
                    f"{g_batch['rays_random'].origins.shape[0]} random-pose "
                    "rays, bf16)",
                    loop.select_train_step(g_cfg, g_state.model),
                    step_lib.build_mip_train_step(g_state.model, g_cfg),
                    g_state, g_batch)
        del g_state
        torch.cuda.empty_cache()
    return {"step_ms": step_ms}


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("unexpected error")
