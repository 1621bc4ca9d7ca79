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
  reduction, and #2 in fp32 too, on the walk's fp32 path: the backward
  and the dW as six bf16 products a fp32 product; their plans are
  printed after the build, and the bf16
  and fp32 plans of #2 and #3 at the vanilla presets' step shapes must
  pick the walk), both at ragged sizes (1, 63, 65, 769, 3000 and 196,607
  points) against their plain versions in bf16 and fp32 and bit for bit
  against a second bf16 launch (#2 and #11 also in fp32), beside the
  main-path gates of the train phases: #2 and #3 at the flagship's
  shapes in bf16 and fp32, each with a repeat bit for bit, #3 in fp32 at
  1, 3 and 395 rays of both levels, and the fp32 times a launch of both
  beside their two bounds (the CUDA cores, six bf16 products on the
  tensor cores);
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
* the switched paths: #8 and #9 at the render chunk (on the render
  path's views and contiguous rows, bit for bit, and a repeat), at 1, 7
  and 8193 rays against their plain versions, and their device time a
  launch (torch.profiler, the L2 flushed) and a call's time; the vanilla
  render with `use_onepass_render` and `use_pdf_kernel` (kernels #4 and
  #8; #4 also at 1, 3 and 395 rays of 64 and 192 samples, a repeat bit
  for bit, and its rows 3-5 against the plain compositing of #1's
  heads), the mip render with `use_pdf_kernel`
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
  computes the hard masks on the card in every hardmask phase;
* the paper's scenes and their evaluation: LLFF fern, Blender lego and
  DTU scan114 written in their datasets' layouts and sizes (content from
  a seed), loaded (timed) and held to what the files imply (decoded
  pixels, K, near / far, splits); fern trained on the one-pass vanilla
  step (NDC, hard masks on the card) through `cli/train.py --eval-after`
  and scored again by `cli/eval.py`, scan114 trained on the one-pass mip
  step and scored with the IDR-masked metrics, lego scored from the
  seeded init; #1 (#6 for scan114) launched 2 a render chunk of each
  group of views; every metric `evaluate()` computed on the card held
  against the same port function on the CPU on the same renders, one
  view's PNG against `render_image`, the artifacts present, and each
  scene's `eval_rays_per_sec` printed; then lego again with its frames in
  the PNG kinds imageio reads for the JAX package (16-bit RGBA, Adam7
  RGBA, 16-bit grey + alpha; a palette + tRNS file beside them, from
  `tools/png_kinds.py`), each file decoded to the digest of imageio's
  decode (`tests/png_kinds.json`, seconds a megapixel), loaded at
  400x400, trained 2 flagship one-pass steps and scored on 2 views with
  LPIPS from an `.npz` that the port's `cli/export_lpips_weights.py`
  wrote from a seeded stand-in `lpips` package
  (`tools/lpips_standin.py`), #1 / #2 / #3 counted, the metrics held
  against the CPU;
* the experiment grid and the consistency variants, on the same fern and
  scan114 fixtures: `cli/export_configs` (147 files, fern_3view loaded
  back equal); the train CLI from the `--scene fern_3view` preset (fp32,
  the one-pass step), from a reference `.gin` like RegNeRF's
  `regnerf3/dtu/scan114_3.gin` (the one-pass mip step with the TV norm)
  and from a reference fern `.txt`; the fern_3view preset's fp32 step as
  the CLI builds it, timed, and guarded against the eager step at 1024
  random rays; the regnerf3_dtu_scan114 preset's fp32 step (#5 / #7 on
  the fp32 level walk) likewise, on the scan114 fixture, its launches
  counted; `ss_loss` on fern through the train
  CLI on the one-pass step (#3 four a step: the main and the reference
  rays, both levels) and the v2 two-call step, with `use_pdf_kernel` off
  and on; the ss_loss steps guarded against the eager step at both
  values of the gate, #3's dW of a repeat bit for bit, both steps timed
  with and without ss_loss; the softmask PNGs, canny and sobel masks of
  fern (set on the train views only), each trained through the CLI;
* the depth-prior producers, on the same fixtures: cli/train_mvs.py
  --with-masks on scan114 (GT-supervised, fp32 and bf16; a 32 x 128 x
  160 cost volume at the JAX defaults) and lego (photometric), its PFMs
  against predict_depth_priors, its JPGs' headers, one step's loss on
  the card against the CPU, step and predict times and peak memory;
  cli/train.py --bootstrap-priors on lego from the lego_3view preset
  (8x256, 64 + 128 samples, bf16, the one-pass step), #3 / #2 / #1
  counted by stage (2 a warmup and a retrain step; #1 2 a render chunk
  of the warmup's depths), the exported priors and masks against the
  retrain's scene, compute_hard_masks and the warmup's acc; the same
  with bootstrap_mode=mvs; cli/export_depth_priors.py from the
  retrain's checkpoint bit for bit against render(); cli/make_masks.py
  on the exported priors against attach_masks; the NDC refusal on fern;
* the whole trainer and its checkpoints: cli/train.py on the flagship
  (one-pass step) with the train-time LPIPS term (an `.npz` the smoke
  writes), prefetch, held-out renders every 6 steps, a profiler trace of
  2 steps (it must name #3) and gc_every 4, then a resume; #1 / #2 / #3
  counted; the one-pass step with the term guarded against the eager
  step; the term on the card against the CPU; the prefetched stream
  against the batcher's bit for bit; the step's time with and without
  the term and the loop's with and without prefetch; the noisy eager
  step (raw_noise_std) and the mip eager step with normals against the
  CPU on the same draws; the checkpoint exported to a reference .tar,
  imported back and rendered through #1 bit for bit as the original; a
  mip checkpoint imported from a msgpack checkpoint file the smoke writes,
  rendered through #6 against the plain render;
* data parallelism over torch.distributed (`parallel/`): the flagship
  one-pass step (hard masks uneven over the ranks), the same with
  ss_loss and the mip one-pass step, 3 steps each, and a sharded render
  of a 128x128 view, first in one process on the whole batches, then in
  two gloo ranks on this card (this script re-run as `--rank R ...`):
  the ranks' parameters bit-identical, the step-1 loss and grads against
  the one process's, each rank's launches of #1 / #2 / #3 / #5 / #6 /
  #7, the sharded render against the whole one, each rank's step time
  and the gloo all-reduce of one step's grads; then a 1-rank NCCL group
  in this process, which must give the unsharded step's bits; two NCCL
  ranks on two cards where the machine has two;
* the method canaries of the JAX tests (the interleaved split, the
  sparse split's two arms, the mip recipe) through the port's `train()`
  with the CLI's dispatch on a card, from the JAX package's inits
  (`tests/canary_inits.npz`, written by `tools/canary_inits.py`) held to
  the JAX tests' bounds, and from the port's init, printed; eight
  processes (`--canary NAME --init jax|port`) at once;
* the image codecs: the committed JPEG fixtures (`tests/jpeg_fixtures/`)
  decoded by the port against the SHA-256 of imageio's decode beside
  them, seconds a megapixel; an LLFF fern whose images/ are the fixture
  JPEGs (20 views of 504x378) loaded through `_minify` at factor 2 and
  at factor 1 (decoded pixels, K, splits), 3 flagship one-pass steps
  through cli/train.py (#1 / #2 / #3 counted), the 4 test poses through
  cli/render.py (#1 counted), stitched by cli/video.py into an `mp4v`
  MP4 held by a box reader (samples, tkhd, mdhd, sync samples, VOP start
  codes); the encoder's time a frame;
* the mip backbone without view directions at the mip width: cli/train.py
  with the card's defaults (the dispatch warns and trains on the eager
  step; #5 / #6 / #7 launch 0 times), 3 steps; a 128x128 render with
  use_fused_render (it warns and renders through the module); the eager
  step's time; an fp32 step on 256 rays on the card against the CPU.

Each kernel is held against its plain PyTorch version at the shapes its
path gives it, in bf16 and fp32 (the one-pass levels #3 and #5 and the
weight grads #2, #7, #11, #14 and #16, whose dW sums take a fixed order,
and #1 also against a second bf16 launch, bit for bit; #2, #3 and #11
against a second fp32 launch too); the plans of the
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
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense tensor-core bf16
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# fp32 products as six bf16 products on the tensor cores (the fp32 level
# walk of #2, #3 and #11): 989 / 6 TFLOP/s of fp32 work.
PEAK_SIX_FLOPS = PEAK_BF16_FLOPS / 6
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


def tools_module(name: str):
    """A module of the checkout's tools/ (the fixture writers the tests
    share with this script)."""
    import importlib

    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


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


# The L2 flush before each timed launch of #8 / #9: a buffer larger than
# the H100's 50 MB L2, read (its sum), so each launch reads its rows from
# device memory, as the bound assumes, and finds clean lines to evict.
L2_FLUSH_BYTES = 256 * 2 ** 20


def launch_device_ms(fn, kernel, iters=50, sessions=3):
    """Device time of one launch of the kernel whose name holds `kernel`:
    fn() `iters` times under torch.profiler, each after an L2 flush (the
    sum of an L2_FLUSH_BYTES buffer), the kernel's own device time over
    the launches the profiler recorded (the flush kernel left out by
    name). The profiler's schedule runs the same `iters` launches once as
    its warm-up cycle (traced, then dropped) before the cycle it records,
    so no launch is counted while its tracing starts. A session that
    records fewer than half of the launches is logged and made again, up
    to `sessions` in all. A gate fails, and None comes back, where no
    session saw device time for at least half of the launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        rows = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: rows.extend(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    buf.sum()
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us, count = 0.0, 0
        for e in rows:
            if kernel in e.key:
                us += getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                count += e.count
        if count != iters:
            log(f"{kernel}: the profiler recorded {count} launches of "
                f"{iters} in session {session} of {sessions}")
        ok = us > 0 and 2 * count >= iters
        if ok:
            break
    gate(ok, f"{kernel}: no device time (the profiler recorded {count} "
         f"launches of {iters}, {us:.1f} us, in the last of {sessions} "
         "sessions)")
    return us / 1e3 / count if ok else None


def us_text(ms):
    return "not measured" if ms is None else f"{1e3 * ms:.2f}"


def equal_gate(label, got, want):
    """`got` bit for bit `want` (tensors, or sequences of them)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"{label}: bit-identical {same}")
    gate(same, f"{label}: other bits")


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
                     twin=None, fp32_walk=False):
    """#2, #7, #11, #14 or #16 at RAGGED_BWD_N against its plain version,
    in bf16 and fp32 (dW rel L2 under TRAIN_DW_TOL), and a second bf16
    launch bit for bit (`fp32_walk`, for #2, #7, #11 and #16: in fp32 too,
    and the twin's fp32 bits). `packed(dtype)` packs the weights; `streams(n,
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
            short = "bf16" if dtype == "bfloat16" else "fp32"
            if dtype == "bfloat16" or fp32_walk:
                repeat_gate(f"{name} N={n}", got, kfn(w, *xs, g, dtype),
                            short)
            if (dtype == "bfloat16" or fp32_walk) and twin:
                same = all(torch.equal(a, b) for a, b in zip(
                    got, twin[1](w, *xs, g, dtype)))
                log(f"{name} N={n} {short}: bit-identical to {twin[0]} on "
                    f"the same points {same}")
                gate(same, f"{name} N={n} {short}: other bits than "
                     f"{twin[0]}")
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


def level_plan_text(out, fp32=False):
    """The nine slots of a level plan (#2, #3, #5, #7), in words; `fp32`:
    a plan of the fp32 instance (the fp32 walk's dW GEMM takes 32-point
    slabs of three bf16 planes)."""
    ws_bytes = out[1] * (2 if out[5] else 4)
    text = (f"{out[3]} bytes of shared memory, {out[0]} blocks, chunks of "
            f"{out[4]} points, workspace {ws_bytes / 2 ** 30:.2f} GiB")
    if out[8]:
        text += (f", the {'fp32 ' if fp32 else ''}level walk and a dW GEMM "
                 f"of {out[5]} splits of {out[7]} {32 if fp32 else 64}-point "
                 "slabs")
    return text


def fwd_plan_text(plan):
    """A forward plan (#1, #6; fused_mlp_v2.PLAN_SLOTS), in words."""
    if not plan["hopper"]:
        return (f"mlp_fwd.cuh's walk: {plan['tiles']} blocks of "
                f"{plan['tile']} points, {plan['smem_bytes']} bytes of "
                "shared memory")
    walk = "the Hopper walk" if plan["hopper"] == 1 else "the fp32 walk"
    return (f"{walk}: {plan['blocks']} persistent blocks over "
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
            if "fwd_f32_kernel" in mangled:
                args = re.findall(r"Li(\d+)E", mangled.split("Enc")[1])
                entry = f"fp32 walk {args[0]}x32 / {args[1]}x32"
            elif "encode_check_kernel" in mangled:
                entry = "fp32 encoder check"
            if "fwd_hopper_kernel" in mangled:
                args = re.findall(r"Li(\d+)E", mangled.split("Enc")[1])
                entry = (f"bf16 Hopper walk {args[0]}x64 / {args[1]}x64"
                         + ("", " normals tail", " render tail")[
                             int(args[2])])
            if "RowMajor" in mangled:
                entry += " row-major"
            if "dw_gemm" in mangled:
                entry = "dW GEMM"
            elif "level_kernel" in mangled or "bwd_kernel" in mangled:
                entry += " level walk" if "Lb1E" in mangled else " legacy"
        elif "Used" in line or "spill" in line:
            log(f"  {name} [{entry}]: {line.strip()}")


def repeat_gate(label, first, again, dtype="bf16"):
    """A second launch of a kernel whose sums take a fixed order (#3, #5:
    rows and dW; #2, #7: dW) gives the first one's bits: every tensor of
    `first` against `again` (tensors, or nested sequences of them)."""
    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [
            t for y in x for t in flat(y)]
    same = all(torch.equal(a, b) for a, b in zip(flat(first), flat(again)))
    log(f"{label} {dtype} repeat: bit-identical {same}")
    gate(same, f"{label} {dtype}: a second launch gave other bits")


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

    t_start = time.perf_counter()

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
    # staging; in fp32 #2 and #11 the fp32 level walk, #14 train_block.
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
                    f"{level_plan_text(out, not bf)}")
                if not out[8] and (bf or fn is not plan1):
                    fail(f"the {'bf16' if bf else 'fp32'} plan of {label} "
                         f"at {n_b} points is not the level walk")
    # #16 beside #7 at the mip level (MIP_LEVEL_N points, 8x256, 16 IPE
    # frequencies): in bf16 and in fp32 both run the level walk, #16 with
    # the row-major staging (9 x 64 floats more shared memory, the
    # wrappers' figure); in fp32 the fp32 walk, its pe tile in the weight
    # ring.
    mflat0 = fmip.flatten_mip_params(MipMLP())
    mpks = {1: fmip.pack(mflat0, 8, 16, "bfloat16"),
            0: fmip.pack(mflat0, 8, 16, "float32")}
    mcfg_args = fmip._cfg_args(mpks[1])[:-1]
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
                f"points, mip 8x256, 16 frequencies) "
                f"{level_plan_text(out, not bf)}; slot 8 (the level walk) "
                f"{out[8]}")
        p16, p7 = outs[fmip.ROW_BWD_KERNEL], outs[fmip.BWD_KERNEL]
        gate(p16[8] == 1, f"the {'bf16' if bf else 'fp32'} plan of #16 "
             f"has slot 8 = {p16[8]}")
        want = fm.walk_smem_bytes(mpks[bf], -(-p16[4] // 64) * 64)
        log(f"  #16 {'bf16' if bf else 'fp32'} shared memory {p16[3]} bytes"
            f" = #7's {p7[3]} + {p16[3] - p7[3]} (the wrappers' plan: "
            f"{want})")
        gate(p16[3] == want == p7[3] + 9 * 64 * 4 and
             p16[:3] + p16[4:] == p7[:3] + p7[4:],
             f"#16's {'bf16' if bf else 'fp32'} plan is not #7's with the "
             "row-major staging")
    plan_o = _build.load(op.KERNEL).onepass_level_plan
    plan_o.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    # #2 and #3 at the vanilla presets' step shapes (the patch rays and the
    # random rays of both levels): in bf16 and in fp32 (the compute type
    # of 145 of the 147 presets) the plans must pick the level walk.
    for bf in (1, 0):
        for n_b in (196608, 65536):
            out = (ctypes.c_longlong * 9)()
            if plan_b(n_b, 8, 256, 16, 10, 4, bf, out):
                fail(f"the plan of {v2.BWD_KERNEL} failed")
            log(f"  {'bf16' if bf else 'fp32'}: {v2.BWD_KERNEL} ({n_b} "
                f"points) {level_plan_text(out, not bf)}")
            gate(out[8] == 1, f"the {'bf16' if bf else 'fp32'} plan of #2 "
                 f"at {n_b} points is not the level walk")
        for seg in (192, 64):
            outo = (ctypes.c_longlong * 9)()
            if plan_o(4096, seg, 8, 256, 16, 10, 4, bf, outo):
                fail(f"the plan of {op.KERNEL} failed")
            log(f"  {'bf16' if bf else 'fp32'}: {op.KERNEL} (4096 x {seg})"
                f" {level_plan_text(outo, not bf)}")
            gate(outo[8] == 1, f"the {'bf16' if bf else 'fp32'} plan of #3 "
                 f"at 4096 x {seg} is not the level walk")
    # #5, #7 and #16 at the mip presets' step shapes (regnerf3 / mipnerf3:
    # 1024 data rays x 96 for #5, the 1024 MiDaS patch rays and the TV
    # norm's 2048 random-pose rays x 96 for #7, the patch rays for #16;
    # the bf16 mip benchmark's 3072 data rays): in bf16 and in fp32 (the
    # mip presets' compute type) the plans must pick the level walk, with
    # the wrappers' shared-memory figure (in fp32 the pe tile in the ring).
    plan_mo = _build.load(op.MIP_KERNEL).onepass_mip_level_plan
    plan_mo.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    mip_plans = [("#5 " + op.MIP_KERNEL, plan_mo, (n_r, 96), False)
                 for n_r in (1024, 3072)]
    for sym, shapes, row in ((fmip.BWD_KERNEL, (98304, 196608), False),
                             (fmip.ROW_BWD_KERNEL, (98304,), True)):
        fn = _build.load(fmip.BWD_KERNEL)[sym + "_plan"]
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        mip_plans += [(("#16 " if row else "#7 ") + sym, fn, (n_p,), row)
                      for n_p in shapes]
    for bf in (1, 0):
        for label, fn, lead, row in mip_plans:
            out = (ctypes.c_longlong * 9)()
            if fn(*lead, *mcfg_args, bf, out):
                fail(f"the plan of {label} failed")
            want = fm.walk_smem_bytes(mpks[bf], -(-out[4] // 64) * 64, row)
            shape = " x ".join(map(str, lead))
            log(f"  {'bf16' if bf else 'fp32'}: {label} ({shape}) "
                f"{level_plan_text(out, not bf)} (the wrappers' shared "
                f"memory: {want})")
            gate(out[8] == 1 and out[3] == want,
                 f"the {'bf16' if bf else 'fp32'} plan of {label} at "
                 f"{shape} is not the level walk of the wrappers' figure")

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
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as fx_tmp:
        fx = write_scene_fixtures(fx_tmp)
        evals = eval_phases(dev, card, configs, fm, v2, fmip, op, fx_tmp, fx)
        log(f"eval phases: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        consist = consistency_phases(dev, card, configs, v2, fmip, op,
                                     pdf_merge, fx_tmp, fx)
        log(f"consistency phases: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        producers = producer_phases(dev, card, configs, v2, op, fx_tmp, fx)
        log(f"producer phase: {time.perf_counter() - t_phase:.1f} s")
    trainer = trainer_phases(dev, card, configs, fm, v2, op, fmip)
    t_phase = time.perf_counter()
    distributed = distributed_phases(dev, card)
    log(f"distributed phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    canaries = canary_phases(card)
    log(f"canary phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    codec = codec_phases(dev, card, configs, v2, op)
    log(f"codec phase: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    mip_noviewdirs_phases(dev, card, configs, fmip, op)
    log(f"mip use_viewdirs=false phase: "
        f"{time.perf_counter() - t_phase:.1f} s")
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
    for r in kernels["kernels"]:
        r["launches"] += (evals["launches"].get(r["name"], 0)
                          + consist["launches"].get(r["name"], 0)
                          + producers["launches"].get(r["name"], 0)
                          + trainer["launches"].get(r["name"], 0)
                          + distributed.get(r["name"], 0)
                          + canaries.get(r["name"], 0)
                          + codec.get(r["name"], 0))
    if GATE_FAILURES:
        fail(f"{len(GATE_FAILURES)} gate(s) failed: {GATE_FAILURES}")
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
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
    """The walks of #1, #6, #10, #12 / #13 and #15: the shape-decided
    plans (at 8x256 in bf16 the Hopper walk of csrc/fwd_hopper.cuh, in
    fp32 the fp32 walk of csrc/fwd_f32.cuh, at the render chunks and at
    the fp32 presets' step shapes, with the wrappers' shared-memory
    figure; v1's shapes past #1's keep mlp_fwd.cuh's walk), the fp32
    walk's encoders against mlp_fwd.cuh's bit for bit, and the kernels at
    the ragged sizes in both dtypes against their plain versions (the
    render chunk's gates) and bit for bit: #10 against #1 and #15 against
    #6 (two layouts of one walk), #12 and #13 against #10 (one instance of
    it), and a repeat of each against its first launch."""
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
                row=True)),
            ("#13 fp32 (v1), two-call fine level", fm.fwd_plan(
                fm.pack_v1(flat, compute_dtype="float32", **nerf_kw),
                TWOCALL_FINE)),
            # The fp32 presets' one-pass steps: the vanilla patch levels
            # (4x16x16 rays x 192 / 64), the mip patch rays and the TV
            # norm's 2048 random-pose rays (x 96).
            ("#1 fp32, the vanilla presets' fine patch level", v2.fwd_plan(
                v2.pack(flat, compute_dtype="float32", **nerf_kw),
                1024 * 192)),
            ("#1 fp32, the vanilla presets' coarse patch level", v2.fwd_plan(
                v2.pack(flat, compute_dtype="float32", **nerf_kw),
                1024 * 64)),
            ("#6 fp32, the mip presets' patch rays", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "float32"), 1024 * 96)),
            ("#6 fp32, the TV norm's random-pose rays", fmip.fwd_plan(
                fmip.pack(mflat, 8, 16, "float32"), 2048 * 96))):
        log(f"plan of {label}: {fwd_plan_text(plan)}")
        want = v2.WALK_BF16 if "bf16" in label else v2.WALK_F32
        gate(plan["hopper"] == want, f"the plan of {label} picked "
             f"{v2.WALK_NAMES.get(plan['hopper'], plan['hopper'])}, not "
             f"{v2.WALK_NAMES[want]}")
        if want == v2.WALK_F32:
            smem = fm.fwd_walk_smem_bytes(
                fmip.pack(mflat, 8, 16, "float32") if "#6" in label or
                "#15" in label else v2.pack(flat, compute_dtype="float32",
                                            **nerf_kw))
            gate((plan["smem_bytes"], plan["stages"], plan["pe_buffers"])
                 == smem, f"the plan of {label} is not the wrappers' "
                 f"figure {smem}")
    fp32_encode_gates(dev, v2)
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
    packed32 = v2.pack(flat, compute_dtype="float32", **nerf_kw)
    packed1_32 = fm.pack_v1(flat, compute_dtype="float32", **nerf_kw)
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
        with torch.no_grad():
            got = v2.fwd_T(packed32, pts, views, compute_dtype="float32",
                           **nerf_kw)
            torch.cuda.synchronize()
            want = v2.plain_fwd_T(packed32, pts, views,
                                  compute_dtype="float32", **nerf_kw)
            twin = v2.fwd(packed32, pts_r, views_r, compute_dtype="float32",
                          **nerf_kw)
            again = v2.fwd_T(packed32, pts, views, compute_dtype="float32",
                             **nerf_kw)
        repeat_gate(f"{v2.KERNEL} N={n}", [got], [again], "fp32")
        rel, mx = rel_err(got, want)
        same = torch.equal(got, twin.T)
        log(f"{v2.KERNEL} fp32 vs plain, N={n}: max|diff| {mx:.3e}, "
            f"max|diff|/mean|plain| {rel:.3e} (tol {FP32_TOL}); "
            f"bit-identical to {v2.ROW_KERNEL} {same}")
        gate(bool(torch.isfinite(got).all()) and rel < FP32_TOL,
             f"{v2.KERNEL} fp32 N={n} disagrees with its plain version "
             f"({rel})")
        gate(same, f"{v2.KERNEL} fp32 N={n}: other bits than "
             f"{v2.ROW_KERNEL}")
        v1_bit_gates(f"N={n}", fm, fmt, v2, packed32, packed1_32, pts_r,
                     views_r, twin, nerf_kw, "float32")
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
        with torch.no_grad():
            got = fmip.fwd_T(mpacked32, means, covs, mviews,
                             compute_dtype="float32", **mip_kw)
            torch.cuda.synchronize()
            want = fmip.plain_fwd_T(mpacked32, means, covs, mviews,
                                    compute_dtype="float32", **mip_kw)
            twin = fmip.fwd(mpacked32, means.T.contiguous(),
                            covs.T.contiguous(), mviews.T.contiguous(),
                            compute_dtype="float32", **mip_kw).T
            again = fmip.fwd(mpacked32, means.T.contiguous(),
                             covs.T.contiguous(), mviews.T.contiguous(),
                             compute_dtype="float32", **mip_kw).T
            again6 = fmip.fwd_T(mpacked32, means, covs, mviews,
                                compute_dtype="float32", **mip_kw)
        repeat_gate(f"{fmip.KERNEL} N={n}", [got], [again6], "fp32")
        if not torch.isfinite(got).all():
            fail(f"{fmip.KERNEL} fp32 N={n}: non-finite output")
        mip_fwd_gate(f"{fmip.KERNEL} fp32 vs plain, N={n}", got, want,
                     "float32")
        same = torch.equal(got, twin)
        log(f"{fmip.KERNEL} fp32 N={n}: bit-identical to {fmip.ROW_KERNEL} "
            f"{same}")
        gate(same, f"{fmip.KERNEL} fp32 N={n}: other bits than "
             f"{fmip.ROW_KERNEL}")
        repeat_gate(f"{fmip.ROW_KERNEL} N={n}", [twin], [again], "fp32")
        # 6n (#6's walk with the normals tail) on the same points.
        normals_gates(f"{fmip.NORMALS_KERNEL} N={n}", fmip, mpacked,
                      mpacked32, means, covs, mviews, mip_kw)


def fp32_encode_gates(dev, v2):
    """The fp32 walk's encoders (fwd_hopper.cuh's FhEnc with an fp32
    store) against mlp_fwd.cuh's (mlp_common.cuh's encode / encode_ipe /
    encode_mip_views), bit for bit, through `fwd_f32_encode_check`: the
    NeRF PE at multires 10 / 4 and the IPE at 16 frequencies with the mip
    view encoding, on points up to 100 in magnitude (the sines' arguments
    past 100 pi, sinf's slow path), exact multiples of 100 pi, signed
    zeros, a denormal, variances up to 1e3, 2551 points (40 tiles, the
    last ragged)."""
    g = torch.Generator().manual_seed(5)
    n = 64 * 40 - 9
    pts = (torch.rand(3, n, generator=g) - 0.5) * 200
    pts[0, :6] = torch.tensor([0.0, -0.0, 1.0, -1.0, 1e-30, -3e-39])
    t = torch.tensor(314.15926535897932, dtype=torch.float32)
    pts[1, :32] = t * torch.arange(-16, 16, dtype=torch.float32) / 2.0 ** (
        torch.arange(32) % 16).float()
    covs = torch.rand(3, n, generator=g) ** 4 * torch.tensor(
        [1e-4, 1.0, 1e3])[:, None]
    views = torch.randn(3, n, generator=g) * 40
    streams = [x.contiguous().to(dev) for x in (pts, covs, views)]
    for mr, mv, ipe, name in ((10, 4, 0, "NeRF PE"),
                              (16, 4, 1, "IPE and mip view encoding")):
        p = 6 * mr if ipe else 3 * (1 + 2 * mr)
        cols = v2._pad16(p) + v2._pad16(3 * (1 + 2 * mv))
        out = torch.full((2, -(-n // 64), cols, 64), float("nan"),
                         device=dev)
        err = v2._entry(v2.KERNEL, "fwd_f32_encode_check", 4, 4)(
            *(x.data_ptr() for x in streams), out.data_ptr(), n, mr, mv,
            ipe, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            fail(f"fwd_f32_encode_check failed: cudaError_t {err}")
        torch.cuda.synchronize()
        old, new = out[0].view(torch.int32), out[1].view(torch.int32)
        diff = int((old != new).sum())
        log(f"the fp32 walk's {name} (multires {mr} / {mv}) against "
            f"mlp_fwd.cuh's encoders: {diff} of {old.numel()} values differ "
            f"in their bits")
        gate(diff == 0 and bool(torch.isfinite(out[0]).all()),
             f"the fp32 walk's {name} differs from mlp_fwd.cuh's in {diff} "
             "values")


def v1_bit_gates(label, fm, fmt, v2, packed, packed1, pts, views, first,
                 kw, dtype="bfloat16"):
    """At 8x256, #10, #12 and #13 run one instance of a walk under the
    row-major layout (bf16: the Hopper walk, fp32: the fp32 walk): #12
    and #13 on the v1 packing give #10's bits (`first`, #10 on pts / views
    [N, 3]), and a second launch of each gives its first one's."""
    with torch.no_grad():
        r12 = fm.fused_mlp(packed1, pts, views, compute_dtype=dtype, **kw)
        r13 = fmt.forward(packed1, pts, views, compute_dtype=dtype, **kw)
        again = [v2.fwd(packed, pts, views, compute_dtype=dtype, **kw),
                 fm.fused_mlp(packed1, pts, views, compute_dtype=dtype,
                              **kw),
                 fmt.forward(packed1, pts, views, compute_dtype=dtype, **kw)]
        torch.cuda.synchronize()
    same = (torch.equal(r12, first), torch.equal(r13, first))
    rep_ = [torch.equal(a, b) for a, b in zip((first, r12, r13), again)]
    dt = "bf16" if dtype == "bfloat16" else "fp32"
    log(f"#12 / #13 ({fm.KERNEL}) {dt}, {label}: bit-identical to #10 "
        f"{same[0]} / {same[1]}; a second launch of #10 / #12 / #13 "
        f"bit-identical {rep_[0]} / {rep_[1]} / {rep_[2]}")
    gate(all(same), f"#12 / #13 {dt} {label}: other bits than #10 "
         f"({same})")
    gate(all(rep_), f"#10 / #12 / #13 {dt} {label}: a second launch gave "
         f"other bits ({rep_})")


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
            repeat_gate(f"{v2.BWD_KERNEL} {lvl}", got, v2.bwd_T(
                w, pts, views, g2[lvl], compute_dtype=dtype, **mlp_kw),
                "bf16" if dtype == "bfloat16" else "fp32")
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
            again = op.onepass_level(w, pts, views, z, *ray_rows,
                                     white_bkgd=True, compute_dtype=dtype,
                                     **mlp_kw)
            repeat_gate(f"{op.KERNEL} {lvl}", (got_rows, got), again,
                        "bf16" if dtype == "bfloat16" else "fp32")
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
            w, pts, views, g, compute_dtype=dtype, **mlp_kw), dev,
        fp32_walk=True)

    # 6c. #3 in fp32 (the fp32 level walk) at RAGGED_RAYS of the fine and
    # coarse levels' samples, on the flagship's random rays: against its
    # plain version and a repeat bit for bit.
    w32 = packed("fine", "float32")
    for seg, z_all in ((s_f, z_fr), (s_c, z_c[p:].contiguous())):
        for n_r in RAGGED_RAYS:
            z = z_all[:n_r].contiguous()
            pts, views = streams(slice(p, p + n_r), z)
            rows_r = tuple(x[:n_r] for x in ray_rows)
            got_rows, got = op.onepass_level(
                w32, pts, views, z, *rows_r, white_bkgd=True,
                compute_dtype="float32", **mlp_kw)
            torch.cuda.synchronize()
            want_rows, want = op.plain_onepass_level(
                w32, pts, views, z, *rows_r, white_bkgd=True,
                compute_dtype=torch.float32, **mlp_kw)
            rel, mx = grads_err(got, want)
            row_err = ((got_rows - want_rows).abs().amax(1) / want_rows.abs(
            ).amax(1).clamp_min(1e-30)).max().item()
            log(f"{op.KERNEL} fp32 vs plain, {n_r} rays x {seg}: rows max "
                f"|diff|/max|plain| {row_err:.3e} (tol "
                f"{ROWS_TOL['float32']:g}); dW max|diff| {mx:.3e}, max rel L2 "
                f"{rel:.3e} (tol {TRAIN_DW_TOL['float32']:g})")
            if not (torch.isfinite(got_rows).all()
                    and all(torch.isfinite(x).all() for x in got)):
                fail(f"{op.KERNEL} fp32 {n_r} x {seg}: non-finite output")
            gate(rel < TRAIN_DW_TOL["float32"]
                 and row_err < ROWS_TOL["float32"],
                 f"{op.KERNEL} fp32 {n_r} rays x {seg} disagrees with its "
                 f"plain version (rows {row_err:.3e}, dW {rel:.3e})")
            repeat_gate(f"{op.KERNEL} {n_r} rays x {seg}", (got_rows, got),
                        op.onepass_level(w32, pts, views, z, *rows_r,
                                         white_bkgd=True,
                                         compute_dtype="float32", **mlp_kw),
                        "fp32")
    del w32

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

    def runner(kern, lvl, fn, dtype="bfloat16"):
        """A call of `fn` (the kernel wrapper or its plain version) on
        the level's inputs in `dtype`."""
        w = packed(lvl, dtype)
        if kern == v2.BWD_KERNEL:
            pts, views = levels2[lvl]
            return lambda: fn(w, pts, views, g2[lvl], compute_dtype=dtype,
                              **mlp_kw)
        pts, views, z = levels3[lvl]
        return lambda: fn(w, pts, views, z, *ray_rows, white_bkgd=True,
                          compute_dtype=fm.as_dtype(dtype), **mlp_kw)

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
        # fp32 (the presets' compute type): the fp32 level walk, against
        # the CUDA cores' fp32 rate and six bf16 products on the tensor
        # cores.
        for lvl in ("fine", "coarse"):
            npts = (levels2 if kern == v2.BWD_KERNEL else levels3)[lvl][
                0].shape[1]
            ms32 = time_ms(runner(kern, lvl, kfn, "float32"),
                           5 if lvl == "fine" else 10)
            b_cc = bound_ms(npts, train_pp, 8 * n_w, PEAK_FP32_FLOPS, bpp)[0]
            b_six = bound_ms(npts, train_pp, 8 * n_w, PEAK_SIX_FLOPS,
                             bpp)[0]
            log(f"{tag} {kern} fp32 {lvl} (N={npts}): {ms32:.3f} ms/launch, "
                f"bounds {b_cc:.3f} ms (CUDA cores, {100 * b_cc / ms32:.1f}% "
                f"of it) / {b_six:.3f} ms (six bf16 products, "
                f"{100 * b_six / ms32:.1f}% of it)")
        plain32 = time_ms(runner(kern, "fine", plain, "float32"), 2)
        log(f"{tag} plain version of {kern}, fp32 fine: {plain32:.3f} ms")
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
            # Both types (fp32: the fp32 level walk).
            repeat_gate(f"{fmip.BWD_KERNEL} level {lvl}", got,
                        fmip.bwd_T(w, *levels_p[lvl], g7[lvl],
                                   compute_dtype=dtype, **kw),
                        "bf16" if dtype == "bfloat16" else "fp32")
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
            again = op.onepass_mip_level(
                w, *levels_r[lvl], compute_dtype=dtype, white_bkgd=True,
                **kw)
            repeat_gate(f"{op.MIP_KERNEL} level {lvl}", (got_rows, got),
                        again, "bf16" if dtype == "bfloat16" else "fp32")
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
            w, means, covs, views, g, compute_dtype=dtype, **kw), dev,
        fp32_walk=True)

    # 13c. #5 in fp32 (the fp32 level walk) at RAGGED_RAYS of the random
    # rays' level-1 samples: against its plain version and a repeat bit
    # for bit.
    w32 = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, "float32")
    for n_r in RAGGED_RAYS:
        lv = levels_r[1]
        sub = tuple(x[:, :n_r * s].contiguous() for x in lv[:3]) + tuple(
            None if x is None else x[:n_r].contiguous() for x in lv[3:])
        got_rows, got = op.onepass_mip_level(
            w32, *sub, compute_dtype="float32", white_bkgd=True, **kw)
        torch.cuda.synchronize()
        want_rows, want = op.plain_onepass_mip_level(
            w32, *sub, compute_dtype=torch.float32, white_bkgd=True, **kw)
        rel, mx = grads_err(got, want)
        row_err = ((got_rows - want_rows).abs().amax(1) / want_rows.abs(
        ).amax(1).clamp_min(1e-30)).max().item()
        log(f"{op.MIP_KERNEL} fp32 vs plain, {n_r} rays x {s}: rows max "
            f"|diff|/max|plain| {row_err:.3e} (tol {ROWS_TOL['float32']:g})"
            f"; dW max|diff| {mx:.3e}, max rel L2 {rel:.3e} (tol "
            f"{TRAIN_DW_TOL['float32']:g})")
        if not (torch.isfinite(got_rows).all()
                and all(torch.isfinite(x).all() for x in got)):
            fail(f"{op.MIP_KERNEL} fp32 {n_r} x {s}: non-finite output")
        gate(rel < TRAIN_DW_TOL["float32"] and row_err < ROWS_TOL["float32"],
             f"{op.MIP_KERNEL} fp32 {n_r} rays x {s} disagrees with its "
             f"plain version (rows {row_err:.3e}, dW {rel:.3e})")
        repeat_gate(f"{op.MIP_KERNEL} {n_r} rays x {s}", (got_rows, got),
                    op.onepass_mip_level(w32, *sub, compute_dtype="float32",
                                         white_bkgd=True, **kw), "fp32")
    del w32

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
        # fp32 (the mip presets' compute type): the fp32 level walk.
        w32 = fmip.pack(flat, cfg.netdepth, cfg.max_deg_point, "float32")
        if kern == fmip.BWD_KERNEL:
            run32 = (lambda: kfn(w32, *levels[1], g7[1],
                                 compute_dtype="float32", **kw),
                     lambda: plain(w32, *levels[1], g7[1],
                                   compute_dtype="float32", **kw))
        else:
            run32 = tuple(
                (lambda f=f: f(w32, *levels[1], white_bkgd=True,
                               compute_dtype=torch.float32, **kw))
                for f in (kfn, plain))
        ms32, plain32 = time_ms(run32[0], 3), time_ms(run32[1], 1)
        n1 = levels[1][0].shape[1]
        b_cc, b_six = (1e3 * n1 * train_pp / peak for peak in (
            PEAK_FP32_FLOPS, PEAK_SIX_FLOPS))
        log(f"{tag} {kern} fp32 level 1 (N={n1}): {ms32:.3f} ms/launch, "
            f"bounds {b_cc:.3f} ms (CUDA cores) / {b_six:.3f} ms (six bf16 "
            f"products); plain version {plain32:.3f} ms")
        del w32
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
# #8's and #9's ragged ray counts at the render's rows: one ray, 7 (at 16
# lanes a ray the last warp's second ray is past the end), and a render
# chunk and one (the last block one ray).
RESAMPLE_RAGGED = (1, 7, CHUNK + 1)
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
    the render chunk's and the train step's shapes, at RESAMPLE_RAGGED
    rays, on the render path's views and again, #4 on a fine and a coarse
    chunk, the switched render, the one-pass step with the pdf kernel
    through the train CLI, its step guard and timings."""
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
        # 17b. #8 again, on the render path's views (the interior weights
        # w_c[:, 1:-1], the expanded linspace: row strides s_c and 0) bit
        # for bit against the contiguous rows, and at the ragged ray
        # counts against the plain version.
        first = pdf_merge.sample_pdf_merged(*render_in)
        equal_gate(f"{pdf_merge.KERNEL} render chunk, a second launch",
                   pdf_merge.sample_pdf_merged(*render_in), first)
        equal_gate(f"{pdf_merge.KERNEL} render chunk on the render path's "
                   "views vs contiguous rows", pdf_merge.sample_pdf_merged(
                       z_c, w_c[:, 1:-1], pdf_merge.fine_z_draws(
                           None, n, s_i, True, dev)), first)
        for k in RESAMPLE_RAGGED:
            rays = stacked.map(lambda x: x.reshape(-1, x.shape[-1])[:k])
            z_k = sampling.vanilla_z_vals(rays.near, rays.far, s_c, False,
                                          None)
            args = (z_k, coarse_weights(rays, z_k)[:, 1:-1],
                    pdf_merge.fine_z_draws(None, k, s_i, True, dev))
            got, _ = pdf_merge.sample_pdf_merged(*args)
            torch.cuda.synchronize()
            resample_gate(f"{pdf_merge.KERNEL} vs plain, {k} ray(s) x "
                          f"{s_c}+{s_i}", got,
                          pdf_merge.plain_sample_pdf_merged(*args)[0], span,
                          bin_width, z_k)
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
        call8 = time_ms(lambda: pdf_merge.sample_pdf_merged(*render_in),
                        50)
        ms8 = launch_device_ms(
            lambda: pdf_merge.sample_pdf_merged(*render_in),
            f"{pdf_merge.KERNEL}_kernel")
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
        f"device time a launch (L2 flushed) {us_text(ms8)} us"
        + f", bound {1e3 * b8:.2f} us ({by8}"
        + ("" if ms8 is None else f", {100 * b8 / ms8:.1f}% of the device "
           "time") + f"); a call, host included (events around 50 calls): "
        f"{1e3 * call8:.1f} us; plain version {1e3 * plain8:.1f} us")
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
            launches=pdf_launches, max_abs_err=pdf_err,
            ms=ms8, call_ms=call8,
            plain_ms=plain8, bound_ms=b8, bound_by=by8, library_ms=None)}}


def switched_mip_phases(dev, card, configs, fm, fmip, op, pdf_merge,
                        default_render_ms):
    """The mip paths with use_pdf_kernel and disable_normals=false: #9 at
    the render chunk's and the train step's shapes, at RESAMPLE_RAGGED
    rays, on views and again, 6n on a render chunk,
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
        # 22b. #9 again, on views (the render path's expanded draws, row
        # stride 0; weights with row stride 2 S) bit for bit against the
        # contiguous rows, and at the ragged ray counts against the plain
        # version.
        pad = cfg.resample_padding_final
        first = pdf_merge.mip_resample_t_vals(*render_in)
        equal_gate(f"{pdf_merge.MIP_KERNEL} render chunk, a second launch",
                   pdf_merge.mip_resample_t_vals(*render_in), first)
        equal_gate(f"{pdf_merge.MIP_KERNEL} render chunk on views vs "
                   "contiguous rows", pdf_merge.mip_resample_t_vals(
                       t0, torch.cat([w0, w0], 1)[:, :s],
                       sampling.piecewise_pdf_draws(None, (n,), s + 1, dev),
                       pad), first)
        for k in RESAMPLE_RAGGED:
            t_k, w_k = level0(stacked.map(
                lambda x: x.reshape(-1, x.shape[-1])[:k]), None)
            args = (t_k, w_k, sampling.piecewise_pdf_draws(
                None, (k,), s + 1, dev), pad)
            got = pdf_merge.mip_resample_t_vals(*args)
            torch.cuda.synchronize()
            resample_gate(f"{pdf_merge.MIP_KERNEL} vs plain, {k} ray(s) x "
                          f"{s + 1}", got,
                          pdf_merge.plain_mip_resample_t_vals(*args), span,
                          span / s)
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
        call9 = time_ms(lambda: pdf_merge.mip_resample_t_vals(*render_in),
                        50)
        ms9 = launch_device_ms(
            lambda: pdf_merge.mip_resample_t_vals(*render_in),
            f"{pdf_merge.MIP_KERNEL}_kernel")
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
        f"fenceposts): device time a launch (L2 flushed) {us_text(ms9)} us"
        + f", bound {1e3 * b9:.2f} us ({by9}"
        + ("" if ms9 is None else f", {100 * b9 / ms9:.1f}% of the device "
           "time") + f"); a call, host included (events around 50 calls): "
        f"{1e3 * call9:.1f} us; plain version {1e3 * plain9:.1f} us")
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
            launches=mip_launches, max_abs_err=mip_err,
            ms=ms9, call_ms=call9,
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
            w, pts, views, g, compute_dtype=dtype, **mlp_kw), dev, row=True,
        fp32_walk=True)

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
        # Both types (fp32: the fp32 walk): the level walk under the two
        # layouts, whose row-major staging changes no value or order.
        short = "bf16" if dtype == "bfloat16" else "fp32"
        gate(same, f"{fmip.ROW_BWD_KERNEL} {short} is not bit-identical "
             f"to {fmip.BWD_KERNEL} on the same points")
        repeat_gate(f"{fmip.ROW_BWD_KERNEL} mip level", got, fmip.bwd(
            w, means, covs, mviews, gm, compute_dtype=dtype, **kw), short)
        del got
        torch.cuda.empty_cache()

    # #16 at the ragged sizes (the mip level's weights, seeded Gaussians),
    # and bit for bit #7's on the same points, in bf16 and in fp32.
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
            g_.T.contiguous(), compute_dtype=dtype, **kw)), fp32_walk=True)

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


# The paper's scenes, written in their datasets' on-disk layouts and sizes
# (content from a seed): LLFF fern (20 views, images_8/ at 378x504, the
# raw 3024x4032 hwf), Blender lego (71 frames of 800x800 RGBA, read at
# half_res) and DTU scan114 (49 views of 1200x1600, MVSNet cam files, GT
# depths, IDR masks).
FERN = dict(n=20, hw=(378, 504), raw_hwf=(3024.0, 4032.0, 3260.5), factor=8)
LEGO = dict(n=71, hw=(800, 800), camera_angle_x=0.6911112070083618)
DTU = dict(n=49, hw=(1200, 1600), k_quarter=(723.08, 205.8, 154.8),
           depth_min=425.0, depth_interval=2.5)
# Splits the bundled registry gives (pairs.npz: fern_train / fern_val,
# lego_train / lego_val) and DTU's fixed pixelnerf split.
FERN_SPLITS = ([17, 2, 7], [12, 13, 5, 19])
LEGO_SPLITS = ([6, 43, 33], [63, 70, 18, 28])
DTU_TRAIN = [25, 22, 28]
DTU_TEST = [1, 2, 9, 10, 11, 12, 14, 15, 23, 24, 26, 27, 29, 30, 31, 32,
            33, 34, 35, 41, 42, 43, 45, 46, 47]
DTU_EVAL_INTERVAL = 5  # every 5th of the 25 test views
# The eval gates: a metric computed by evaluate() on the card against the
# same port function on the CPU on the same rendered images (relative);
# LPIPS and avg_err (which holds it) under fm.strict_fp32 (no TF32).
EVAL_METRIC_TOL = 1e-4
EVAL_LPIPS_TOL = 1e-3
# The colour PNG of a view written by evaluate() against render_image of
# that view quantised the same way: the share of pixels one level apart
# (two float renders of one view on one card; exact if bit-equal).
EVAL_PNG_SHARE = 1e-4


def smooth_u8(rng, h, w, c):
    """A smooth seeded image (sines over the frame, a little noise)."""
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    f = rng.uniform(1, 6, (3, c)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (2, c)).astype(np.float32)
    v = (0.5 + 0.3 * np.sin(2 * np.pi * f[0] * x + ph[0])
         * np.cos(2 * np.pi * f[1] * y + ph[1])
         + 0.15 * np.sin(2 * np.pi * f[2] * (x + y))
         + 0.03 * rng.rand(h, w, c).astype(np.float32))
    return (np.clip(v, 0, 1) * 255).astype(np.uint8)


def fern_image(i):
    """A smooth frame with a dark seeded rectangle: the sharp edges the
    Canny masks keep (the smooth part alone has no gradient over the
    strong threshold)."""
    rng = np.random.RandomState(100 + i)
    img = smooth_u8(rng, *FERN["hw"], 3)
    h, w = FERN["hw"]
    r0, c0 = rng.randint(h // 4, h // 2), rng.randint(w // 4, w // 2)
    img[r0:r0 + h // 4, c0:c0 + w // 4] //= 6
    return img


def lego_image(i):
    img = smooth_u8(np.random.RandomState(200 + i), *LEGO["hw"], 4)
    h, w = LEGO["hw"]
    yy, xx = np.mgrid[:h, :w]
    inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.35 * h) ** 2
    img[..., 3] = np.where(inside, 255, 0)
    return img


def dtu_image(vid):
    return smooth_u8(np.random.RandomState(300 + vid), *DTU["hw"], 3)


def png_filters(rng, h):
    """One of the five row filters per row, as an adaptive encoder
    picks them: undone along anti-diagonals (Average / Paeth rows)."""
    return rng.randint(0, 5, h)


def look_at_w2c(pos, target=(0.0, 0.0, 0.0)):
    """OpenCV world-to-camera (x right, y down, z forward) at `pos`."""
    z = np.asarray(target) - pos
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0.0, -1.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([x, y, z], 1)
    c2w[:3, 3] = pos
    return np.linalg.inv(c2w)


def write_scene_fixtures(root):
    """Write the three scenes under `root`; return their directories and
    what they imply (sizes, intrinsics, near / far)."""
    from consistentnerf_tpu_torch.data import images, pfm, poses

    t0 = time.perf_counter()
    # LLFF fern: images_8/ PNGs, poses_bounds.npy ([down, right, back]
    # columns, the raw hwf), MVS depth PFMs at half size (INTER_LINEAR up)
    # and MiDaS PFMs beside the scene.
    llff_root = os.path.join(root, "nerf_llff_data")
    fern = os.path.join(llff_root, "fern")
    os.makedirs(os.path.join(fern, f"images_{FERN['factor']}"))
    mvs = os.path.join(llff_root, "nerf_llff_data_depth", "fern")
    midas = os.path.join(llff_root, "midas_llff_depth", "output_llff_fern")
    os.makedirs(mvs)
    os.makedirs(midas)
    rng = np.random.RandomState(1)
    h, w = FERN["hw"]
    rows = []
    for i in range(FERN["n"]):
        images.write_png(os.path.join(fern, f"images_{FERN['factor']}",
                                      f"image{i:03d}.png"),
                         fern_image(i), png_filters(rng, h))
        a = rng.randn(3) * 0.03
        rot = np.linalg.qr(np.eye(3) + np.array(
            [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]))[0]
        rot = rot * np.sign(np.diag(rot))[None]
        llff_r = np.stack([-rot[:, 1], rot[:, 0], rot[:, 2]], 1)
        t = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.05, 0.05)])
        pose = np.concatenate([llff_r, t[:, None],
                               np.array(FERN["raw_hwf"])[:, None]], 1)
        rows.append(np.concatenate([pose.reshape(-1),
                                    [1.2 + 0.1 * rng.rand(),
                                     20.0 + rng.rand()]]))
        depth = (3.0 + np.linspace(0, 1, w // 2)[None, :]
                 + 0.5 * np.linspace(0, 1, h // 2)[:, None]).astype(
                     np.float32)
        pfm.write_pfm(os.path.join(mvs, f"depth_{i:03d}.pfm"), depth)
        pfm.write_pfm(os.path.join(midas, f"image{i:03d}"
                                   "-dpt_beit_large_512.pfm"),
                      rng.randn(h, w).astype(np.float32))
    np.save(os.path.join(fern, "poses_bounds.npy"), np.stack(rows))
    f8 = FERN["raw_hwf"][2] / FERN["factor"]
    out = {"fern": dict(dir=fern, H=h, W=w, K=np.array(
        [[f8, 0, 0.5 * w], [0, f8, 0.5 * h], [0, 0, 1]]), near=0.0, far=1.0,
        train=FERN_SPLITS[0], test=FERN_SPLITS[1])}
    t_fern = time.perf_counter() - t0

    # Blender lego: train/r_{i}.png RGBA and the transforms files.
    t0 = time.perf_counter()
    lego = os.path.join(root, "nerf_synthetic", "lego")
    os.makedirs(os.path.join(lego, "train"))
    frames = []
    for i in range(LEGO["n"]):
        images.write_png(os.path.join(lego, "train", f"r_{i}.png"),
                         lego_image(i), png_filters(rng, LEGO["hw"][0]))
        c2w = poses.pose_spherical(-180.0 + 360.0 * i / LEGO["n"], -30.0, 4.0)
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    for split in ("train", "val", "test"):
        with open(os.path.join(lego, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO["camera_angle_x"],
                       "frames": frames}, f)
    half = LEGO["hw"][0] // 2
    focal = 0.5 * LEGO["hw"][1] / np.tan(0.5 * LEGO["camera_angle_x"]) / 2
    n_tr, n_val = len(LEGO_SPLITS[0]), len(LEGO_SPLITS[1])
    out["lego"] = dict(dir=lego, H=half, W=half, K=np.array(
        [[focal, 0, 0.5 * half], [0, focal, 0.5 * half], [0, 0, 1]]),
        near=2.0, far=6.0, train=list(range(n_tr)),
        test=list(range(n_tr + n_val, n_tr + 2 * n_val)))
    t_lego = time.perf_counter() - t0

    # Blender lego again, its frames in the PNG kinds imageio reads for
    # the JAX package (tools/png_kinds.py, integer content from seeds):
    # 16-bit RGBA, Adam7 RGBA and 16-bit grey + alpha in turn, and a
    # palette + tRNS file beside them. Only the frames the loader reads
    # (lego_train, lego_val) are written.
    t0 = time.perf_counter()
    png_kinds = tools_module("png_kinds")
    kinds = os.path.join(root, "png_kinds", "nerf_synthetic", "lego")
    os.makedirs(os.path.join(kinds, "train"))
    files = []
    for name, kind, data in png_kinds.scene_files():
        files.append((name, kind, os.path.join(kinds, "train", name)))
        with open(files[-1][2], "wb") as f:
            f.write(data)
    for split in ("train", "val", "test"):
        with open(os.path.join(kinds, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO["camera_angle_x"],
                       "frames": frames}, f)
    out["kinds"] = dict(out["lego"], dir=kinds, files=files,
                        write_s=time.perf_counter() - t0)

    # DTU scan114: Rectified/ PNGs, cam files (quarter-res K, w2c in mm),
    # GT depth PFMs (1200x1600, zero off the object) for the train and
    # evaluated views, MiDaS PFMs for the train views, IDR masks of every
    # pixelnerf test view at full resolution.
    t0 = time.perf_counter()
    dtu_root = os.path.join(root, "dtu")
    scan = os.path.join(dtu_root, "scan114")
    rect = os.path.join(dtu_root, "Rectified", "scan114_train")
    cams = os.path.join(dtu_root, "Depths", "Cameras", "train")
    gt = os.path.join(dtu_root, "Depths", "scan114")
    dmidas = os.path.join(dtu_root, "midas_dtu_depth", "output_dtu_scan114")
    masks = os.path.join(root, "idr_masks", "scan114", "mask")
    for d in (scan, rect, cams, gt, dmidas, masks):
        os.makedirs(d, exist_ok=True)
    h, w = DTU["hw"]
    fq, cxq, cyq = DTU["k_quarter"]
    yy, xx = np.mgrid[:h, :w]
    obj = ((yy - h / 2) / (0.4 * h)) ** 2 + ((xx - w / 2) / (0.35 * w)) ** 2
    obj = obj < 1
    eval_views = DTU_TEST[::DTU_EVAL_INTERVAL]
    for vid in range(DTU["n"]):
        images.write_png(os.path.join(rect, f"rect_{vid + 1:03d}_3_r5000.png"),
                         dtu_image(vid), png_filters(rng, h))
        a = 2 * np.pi * vid / DTU["n"] * 0.5 - 0.8
        pos = 600.0 * np.array([np.sin(a), -0.3 + 0.004 * vid,
                                -np.cos(a)])
        w2c = look_at_w2c(pos)
        lines = (["extrinsic"] + [" ".join(f"{x:.9f}" for x in r)
                                  for r in w2c]
                 + ["", "intrinsic", f"{fq} 0 {cxq}", f"0 {fq} {cyq}",
                    "0 0 1", "", f"{DTU['depth_min']} "
                    f"{DTU['depth_interval']}"])
        with open(os.path.join(cams, f"{vid:08d}_cam.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if vid in DTU_TRAIN or vid in eval_views:
            depth = np.where(obj, 600.0 + 20 * np.sin(xx / 97.0), 0.0)
            pfm.write_pfm(os.path.join(gt, f"depth_map_{vid:04d}.pfm"),
                          depth.astype(np.float32))
        if vid in DTU_TRAIN:
            pfm.write_pfm(os.path.join(dmidas, f"rect_{vid + 1:03d}_3_r5000"
                                       "-dpt_beit_large_512.pfm"),
                          rng.rand(512, 640).astype(np.float32))
    mask_img = np.repeat((obj * 255).astype(np.uint8)[..., None], 3, -1)
    for idx in DTU_TEST:
        images.write_png(os.path.join(masks, f"{idx:03d}.png"), mask_img)
    k = np.array([[fq, 0, cxq], [0, fq, cyq], [0, 0, 1]], np.float32)
    k[:2] *= 4
    k[:2] *= 0.5
    k[0, 2] -= 80
    k[1, 2] -= 44
    dmax = DTU["depth_min"] + DTU["depth_interval"] * 192 * 1.06
    out["scan114"] = dict(dir=scan, H=512, W=640, K=k,
                          near=DTU["depth_min"] / 200, far=dmax / 200,
                          train=DTU_TRAIN, test=DTU_TEST,
                          mask_path=os.path.join(root, "idr_masks"))
    t_dtu = time.perf_counter() - t0
    log(f"fixtures written (host): fern {FERN['n']} x {FERN['hw']} in "
        f"{t_fern:.1f} s, lego {LEGO['n']} x {LEGO['hw']} RGBA in "
        f"{t_lego:.1f} s, lego in the PNG kinds ({len(files)} files) in "
        f"{out['kinds']['write_s']:.1f} s, scan114 {DTU['n']} x "
        f"{DTU['hw']} + GT depths + {len(DTU_TEST)} IDR masks in "
        f"{t_dtu:.1f} s")
    return out


def scene_gates(label, scene, want, decoded):
    """The loaded scene against what its fixture implies: sizes, K,
    near / far and the splits; `decoded` [(view, got, expected)] the
    images' pixels."""
    ok_k = np.allclose(scene.K, want["K"], rtol=1e-6, atol=1e-4)
    log(f"{label}: {scene.images.shape[0]} views {scene.H}x{scene.W}, K "
        f"{np.round(scene.K, 3).tolist()}, near {scene.near:.6f} far "
        f"{scene.far:.6f}, train {list(scene.i_train)}, test "
        f"{list(scene.i_test)}, use_ndc {scene.use_ndc}")
    gate((scene.H, scene.W) == (want["H"], want["W"]) and ok_k
         and abs(scene.near - want["near"]) <= 1e-6 * max(1, want["near"])
         and abs(scene.far - want["far"]) <= 1e-6 * max(1, want["far"])
         and list(scene.i_train) == list(want["train"])
         and list(scene.i_test) == list(want["test"]),
         f"{label}: the loaded scene is not what its fixture implies")
    for view, got, expected in decoded:
        gate(got.shape == expected.shape and np.array_equal(got, expected),
             f"{label}: view {view} did not decode to the written pixels")
    log(f"{label}: {len(decoded)} decoded images equal the written pixels "
        f"exactly: {all(np.array_equal(g, e) for _, g, e in decoded)}")


def eval_launches(cfg, scene, n_views, per_chunk):
    """Launches of the render kernel that evaluate() makes: per_chunk a
    render chunk of each group of stacked views."""
    from consistentnerf_tpu_torch.train import evaluation

    g = evaluation.views_per_call(cfg, "cuda", n_views)
    chunks = -(-(g * scene.H * scene.W) // cfg.render_chunk_size)
    return per_chunk * chunks * (-(-n_views // g))


def eval_metric_gates(label, card, cli_args, scene, views, got, mask_fn):
    """evaluate()'s values from the card against the same port function
    on the CPU on the same rendered images (the views rendered in
    evaluate()'s groups, by its own `render_groups`), and one view's
    colour PNG against render_image of that view."""
    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.data import images
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import evaluation
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.lpips import LPIPS

    args = common.make_parser("eval gates").parse_args(cli_args)
    cfg = common.auto_fused_defaults(common.resolve_config(args), args)
    dev = torch.device(args.device)
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    model = make_model(cfg, dev)
    CheckpointManager(os.path.join(exp_dir, "checkpoints")).restore_for_eval(
        model)
    model.eval()
    render = render_lib.build_render_fn(model, cfg)
    selected = evaluation.selected_views(cfg, scene.i_test)
    gate([int(v) for _, v in selected] == [int(v) for v in views],
         f"{label}: evaluate() renders views {selected}, expected {views}")
    g = evaluation.views_per_call(cfg, dev, len(selected))
    lp_cpu = None if cfg.eval_disable_lpips else LPIPS(
        cfg.lpips_weights_path, device="cpu")
    lp_dev = None if cfg.eval_disable_lpips else LPIPS(
        cfg.lpips_weights_path, device=dev)
    cpu_views, dev_views = [], []
    first = None
    with torch.no_grad():
        for group, outs in evaluation.render_groups(render, scene, selected,
                                                    g, dev):
            for (_, v), view in zip(group, outs):
                rgb = torch.clamp(view["rgb"], 0, 1)
                if first is None:
                    first = rgb.cpu().numpy()
                mk = mask_fn(v)
                dev_views.append(evaluation.compute_image_metrics(
                    rgb, torch.as_tensor(scene.images[v], device=dev),
                    lp_dev, None if mk is None else torch.as_tensor(
                        mk, device=dev)))
                cpu_views.append(evaluation.compute_image_metrics(
                    rgb.cpu().numpy(), scene.images[v], lp_cpu, mk))
    for k, v in got.items():
        if k == "eval_rays_per_sec":
            continue
        cpu = float(np.mean([m[k] for m in cpu_views if k in m]))
        card_ = float(np.mean([m[k] for m in dev_views if k in m]))
        rel = abs(v - cpu) / max(abs(cpu), 1e-12)
        tol = EVAL_LPIPS_TOL if "lpips" in k or k == "avg_err" \
            else EVAL_METRIC_TOL
        log(f"{label} {k}: evaluate() on the card {v:.7f}, the same views "
            f"re-rendered on the card {card_:.7f}, on the CPU {cpu:.7f} "
            f"(|rel| {rel:.2e}, tol {tol:g})")
        gate(rel <= tol, f"{label} {k}: the card's {v} against the CPU's "
             f"{cpu} ({rel:.2e} > {tol:g})")
    one = render_lib.render_image(model, cfg, evaluation.camera_rays_for_view(
        scene, scene.poses[views[0]], device=dev))["rgb"]
    want = (np.clip(np.nan_to_num(one), 0, 1) * 255).astype(np.uint8)
    png = images.read_png(os.path.join(exp_dir, "test_preds", "color_000.png"))
    diff = np.abs(png.astype(int) - want)
    share = float(np.mean(diff > 0))
    log(f"{label}: color_000.png from evaluate() vs render_image of view "
        f"{views[0]}: max|diff| {int(diff.max())} levels, share of pixels "
        f"apart {share:.2e} (tol: 1 level on {EVAL_PNG_SHARE:g}); float "
        f"max|diff| against the group render "
        f"{float(np.abs(np.clip(one, 0, 1) - first).max()):.3e}")
    gate(diff.max() <= 1 and share <= EVAL_PNG_SHARE,
         f"{label}: the view evaluate() wrote is not render_image's")
    # evaluate() without the images: the same values, its throughput, and
    # the device's share of one such call.
    tag = f"[{card}]"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet = evaluation.evaluate(model, cfg, scene, save_images=False)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    for k, v in got.items():
        if k != "eval_rays_per_sec":
            gate(abs(quiet[k] - v) <= 1e-6 * max(abs(v), 1e-6),
                 f"{label} {k}: evaluate() without images gave {quiet[k]}, "
                 f"with them {v}")
    dev_ms, top = device_time(lambda: evaluation.evaluate(
        model, cfg, scene, save_images=False))
    log(f"{tag} {label} evaluate() without images: eval_rays_per_sec "
        f"{quiet['eval_rays_per_sec']:.1f} (with them "
        f"{got['eval_rays_per_sec']:.1f}), the call {wall:.1f} ms; "
        + ("device time not measured" if dev_ms is None else
           f"profiled device time {dev_ms:.1f} ms, idle share "
           f"{max(0.0, 1 - dev_ms / wall):.3f}; by kernel: " + "; ".join(
               f"{k} {t:.2f} ms x{c}" for k, t, c in top)))
    if cfg.eval_render_interval <= 1:
        return
    # The gated calls take every eval_render_interval-th test view; the
    # scene's own eval rate is that of all of them.
    full_cfg = cfg.replace(eval_render_interval=1)
    n_full = len(evaluation.selected_views(full_cfg, scene.i_test))
    g_full = evaluation.views_per_call(full_cfg, dev, n_full)
    rates = []
    for images_ in (False, True):
        with tempfile.TemporaryDirectory() as out_dir:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = evaluation.evaluate(model, full_cfg, scene,
                                       out_dir=out_dir, save_images=images_)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            pngs = sum(f.startswith("color_") for f in os.listdir(out_dir))
        gate(set(full) == set(got) and all(np.isfinite(v) for v in
                                           full.values())
             and pngs == (n_full if images_ else 0),
             f"{label}: evaluate() of all {n_full} test views gave {full} "
             f"and {pngs} colour PNGs")
        rates.append(f"{'with' if images_ else 'without'} images "
                     f"{full['eval_rays_per_sec']:.1f} (the call "
                     f"{wall:.1f} ms)")
    log(f"{tag} {label} evaluate() of all {n_full} test views ({g_full} a "
        f"call, {-(-n_full // g_full) - 1} groups timed): "
        f"eval_rays_per_sec {'; '.join(rates)}")


def eval_phases(dev, card, configs, fm, v2, fmip, op, tmp, fx):
    """35. The paper's scenes and their evaluation: the three fixtures
    (`fx`, written under `tmp` by write_scene_fixtures) loaded (timed)
    and held to what they imply, fern trained (one-pass
    vanilla step, hard masks on the card, NDC) through cli/train.py
    --eval-after and scored again by cli/eval.py, scan114 trained on the
    one-pass mip step and scored with the IDR-masked metrics, lego scored
    from the seeded init, lego in the PNG kinds (`kinds_phase`); each
    eval's launches counted, its metrics held against the CPU, its
    eval_rays_per_sec printed."""
    from consistentnerf_tpu_torch.cli import eval as eval_cli
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.data import images
    from consistentnerf_tpu_torch.data.loaders import load_scene

    tag = f"[{card}]"
    # PNG decode time a frame, host (the chip machine's CPU).
    rng = np.random.RandomState(0)
    for name, img in (("800x800 RGBA", lego_image(0)),
                      ("1200x1600 RGB", dtu_image(0))):
        for kinds, what in ((0, "None"), (4, "Paeth"),
                            (png_filters(rng, img.shape[0]), "mixed")):
            data = images.encode_png(img, kinds)
            t0 = time.perf_counter()
            back = images.decode_png(data)
            dt = time.perf_counter() - t0
            if not np.array_equal(back, img):
                fail(f"PNG decode of a {name} frame ({what} rows) lost "
                     "pixels")
            log(f"{tag} PNG decode (host), {name}, {what} rows: "
                f"{1e3 * dt:.1f} ms a frame ({len(data)} bytes)")

    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    rays_per_sec = {}

    # --- fern: vanilla, hard masks on the card, NDC ---------------
    fern = fx["fern"]
    sets = [f"{k}={v}" for k, v in FLAGSHIP.items()] + [
        "dataset_type=llff", f"datadir={fern['dir']}",
        f"factor={FERN['factor']}", "white_bkgd=false", "near=0.0",
        "far=1.0", "train_view_num=3", "i_print=1",
        f"checkpoint_every={TRAIN_STEPS}", f"basedir={tmp}",
        "expname=fern"]
    args = ["--device", str(dev)] + [x for s_ in sets
                                     for x in ("--set", s_)]
    cfg = configs.Config(**{**FLAGSHIP, "dataset_type": "llff",
                            "datadir": fern["dir"], "white_bkgd": False,
                            "basedir": tmp, "expname": "load"})
    t0 = time.perf_counter()
    scene = load_scene(cfg, device=dev, attach=False)
    t_load = time.perf_counter() - t0
    log(f"{tag} load_scene fern (llff, factor {FERN['factor']}): "
        f"{t_load:.2f} s (host: PNG decode, PFMs, poses)")
    scene_gates("fern", scene, fern, [
        (i, scene.images[i], (fern_image(i) / 255.0).astype(np.float32))
        for i in range(FERN["n"])])
    counted = ((v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (op, "launches", op.KERNEL))
    for mod, attr, _ in counted:
        setattr(mod, attr, 0)
    res = train_cli.main(args + ["--num-steps", str(TRAIN_STEPS),
                                 "--eval-after"])
    torch.cuda.synchronize()
    got = {k: getattr(mod, attr) for mod, attr, k in counted}
    ecfg = configs.Config(render_chunk_size=CHUNK)
    n_eval = eval_launches(ecfg, scene, len(fern["test"]), 2)
    want = {v2.KERNEL: 2 * TRAIN_STEPS + n_eval,
            v2.BWD_KERNEL: 2 * TRAIN_STEPS, op.KERNEL: 2 * TRAIN_STEPS}
    log(f"fern cli.train --eval-after: {TRAIN_STEPS} one-pass steps, "
        f"loss {float(res.stats_history[-1]['loss']):.5f}, launches "
        f"{got} (expected {want}: #1 2 a render chunk of each view "
        "group); metrics " + ", ".join(
            f"{k} {v:.5f}" for k, v in sorted(res.metrics.items())))
    gate(got == want, f"fern: the train and eval path launched {got}, "
         f"expected {want}")
    if not all(np.isfinite(float(h["loss"])) for h in res.stats_history):
        fail("fern: a non-finite loss")
    add(got)
    masks = os.listdir(os.path.join(tmp, "fern", "mask_cache"))
    log(f"fern hard masks (made on the card): {masks}")
    gate(len(masks) == 1, "fern: no hard masks were cached")
    v2.launches = 0
    metrics = eval_cli.main(args)
    torch.cuda.synchronize()
    log(f"fern cli.eval: {v2.KERNEL} launches {v2.launches} (expected "
        f"{n_eval})")
    gate(v2.launches == n_eval, f"fern cli.eval launched {v2.launches}")
    add({v2.KERNEL: v2.launches})
    for k, v in res.metrics.items():
        if k != "eval_rays_per_sec":
            gate(abs(metrics[k] - v) <= 1e-5 * max(abs(v), 1e-6),
                 f"fern: cli.eval's {k} {metrics[k]} is not "
                 f"--eval-after's {v}")
    files = sorted(os.listdir(os.path.join(tmp, "fern", "test_preds")))
    need = {f"metric_{k}_{TRAIN_STEPS}.txt" for k in metrics} | {
        "metrics.txt", "LPIPS_UNCALIBRATED.txt", "color_000.png",
        "depth_003.png", "acc_003.png"}
    log(f"fern test_preds: {len(files)} files")
    gate(need <= set(files), f"fern: artifacts missing: "
         f"{sorted(need - set(files))}")
    eval_metric_gates("fern", card, args, scene, list(fern["test"]),
                      metrics, lambda v: None)
    rays_per_sec["fern"] = metrics["eval_rays_per_sec"]
    del scene

    # --- scan114: mip, IDR-masked metrics -------------------------
    dtu = fx["scan114"]
    sets = [f"{k}={v}" for k, v in MIP.items()
            if k not in ("dataset_type", "white_bkgd")] + [
        "dataset_type=dtu", f"datadir={dtu['dir']}", "white_bkgd=false",
        "dtu_split_type=pixelnerf", "train_view_num=3", "i_print=1",
        f"checkpoint_every={TRAIN_STEPS}", f"basedir={tmp}",
        "expname=scan114", f"dtu_mask_path={dtu['mask_path']}",
        "factor=0", f"eval_render_interval={DTU_EVAL_INTERVAL}"]
    args = ["--device", str(dev)] + [x for s_ in sets
                                     for x in ("--set", s_)]
    cfg = configs.Config(dataset_type="dtu", datadir=dtu["dir"],
                         dtu_split_type="pixelnerf")
    t0 = time.perf_counter()
    scene = load_scene(cfg, device=dev)
    t_load = time.perf_counter() - t0
    log(f"{tag} load_scene scan114 (dtu, half-res + crop): "
        f"{t_load:.2f} s (host)")
    decoded = [(v, images.read_png(os.path.join(
        os.path.dirname(dtu["dir"]), "Rectified", "scan114_train",
        f"rect_{v + 1:03d}_3_r5000.png")), dtu_image(v))
        for v in (0, 25, 48)]
    scene_gates("scan114", scene, dtu, decoded)
    gate(scene.masks[DTU_TRAIN].mean() > 0.2
         and not scene.masks[0].any(),
         "scan114: the masks are not the GT depths' coverage")
    counted = ((fmip, "launches", fmip.KERNEL),
               (fmip, "bwd_launches", fmip.BWD_KERNEL),
               (op, "mip_launches", op.MIP_KERNEL))
    for mod, attr, _ in counted:
        setattr(mod, attr, 0)
    res = train_cli.main(args + ["--num-steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    got = {k: getattr(mod, attr) for mod, attr, k in counted}
    log(f"scan114 cli.train (mip): {TRAIN_STEPS} one-pass steps, loss "
        f"{float(res.stats_history[-1]['loss']):.5f}, launches {got} "
        "(expected 2 of each per step)")
    gate(all(v == 2 * TRAIN_STEPS for v in got.values()),
         f"scan114: the mip train path launched {got}")
    if not all(np.isfinite(float(h["loss"])) for h in res.stats_history):
        fail("scan114: a non-finite loss")
    add(got)
    fmip.launches = 0
    metrics = eval_cli.main(args)
    torch.cuda.synchronize()
    views = DTU_TEST[::DTU_EVAL_INTERVAL]
    n_eval = eval_launches(ecfg, scene, len(views), 2)
    log(f"scan114 cli.eval: {fmip.KERNEL} launches {fmip.launches} "
        f"(expected {n_eval}: 2 levels a render chunk); metrics "
        + ", ".join(f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    gate(fmip.launches == n_eval,
         f"scan114 cli.eval launched {fmip.launches}")
    add({fmip.KERNEL: fmip.launches})
    gate({"masked_psnr", "masked_ssim", "masked_lpips",
          "ms_ssim"} <= set(metrics), "scan114: the masked metrics are "
         "missing")
    from consistentnerf_tpu_torch.data import dtu as dtu_lib

    idr = dtu_lib.load_idr_masks(dtu["mask_path"], "scan114")[..., 0]
    r0, r1, c0, c1 = dtu_lib.CROP
    crop = {v: images.resize(idr[i], None, fx=0.5, fy=0.5,
                             interpolation=images.INTER_NEAREST)[
                                 r0:r1, c0:c1]
            for i, v in enumerate(DTU_TEST)}
    eval_metric_gates("scan114", card, args, scene, views, metrics,
                      crop.get)
    rays_per_sec["scan114"] = metrics["eval_rays_per_sec"]
    del scene

    # --- lego: scored from the seeded init ------------------------
    lego = fx["lego"]
    sets = ["dataset_type=blender", f"datadir={lego['dir']}",
            "half_res=true", "white_bkgd=true", "compute_dtype=bfloat16",
            "train_view_num=3", f"basedir={tmp}", "expname=lego"]
    args = ["--device", str(dev)] + [x for s_ in sets
                                     for x in ("--set", s_)]
    cfg = configs.Config(dataset_type="blender", datadir=lego["dir"],
                         half_res=True, white_bkgd=True, basedir=tmp,
                         expname="load")
    t0 = time.perf_counter()
    scene = load_scene(cfg, device=dev)
    t_load = time.perf_counter() - t0
    log(f"{tag} load_scene lego (blender, half_res): {t_load:.2f} s "
        "(host)")
    decoded = [(i, images.read_png(os.path.join(
        lego["dir"], "train", f"r_{i}.png")), lego_image(i))
        for i in LEGO_SPLITS[0] + LEGO_SPLITS[1]]
    scene_gates("lego", scene, lego, decoded)
    v2.launches = 0
    metrics = eval_cli.main(args)
    torch.cuda.synchronize()
    n_eval = eval_launches(ecfg, scene, len(lego["test"]), 2)
    log(f"lego cli.eval (seeded init): {v2.KERNEL} launches "
        f"{v2.launches} (expected {n_eval}); metrics " + ", ".join(
            f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    gate(v2.launches == n_eval, f"lego cli.eval launched {v2.launches}")
    add({v2.KERNEL: v2.launches})
    eval_metric_gates("lego", card, args, scene, list(lego["test"]),
                      metrics, lambda v: None)
    rays_per_sec["lego"] = metrics["eval_rays_per_sec"]
    del scene

    # --- lego in the PNG kinds: decode, load, train, eval with LPIPS ---
    t_kinds = time.perf_counter()
    rays_per_sec["lego_kinds"] = kinds_phase(dev, card, configs, v2, op,
                                             tmp, fx["kinds"], add)
    t_kinds = time.perf_counter() - t_kinds
    log(f"{tag} lego in the PNG kinds: the phase {t_kinds:.1f} s, with "
        f"its fixtures {t_kinds + fx['kinds']['write_s']:.1f} s")
    for k, v in rays_per_sec.items():
        log(f"{tag} eval_rays_per_sec {k}: {v:.1f}")
    torch.cuda.empty_cache()
    return {"launches": launches, "eval_rays_per_sec": rays_per_sec}



KINDS_STEPS = 2  # flagship one-pass steps on the PNG-kinds scene


def kinds_phase(dev, card, configs, v2, op, tmp, kinds, add):
    """Blender lego at 800x800 in the PNG kinds of tools/png_kinds.py:
    each file decoded (seconds a megapixel, host) to the digest of
    imageio's decode (tests/png_kinds.json); the scene loaded with
    half_res (400x400) and held to what it implies; KINDS_STEPS flagship
    one-pass steps through cli/train.py --eval-after, which scores 2 test
    views with LPIPS from an `.npz` that the port's
    cli/export_lpips_weights.py wrote from the seeded stand-in `lpips`
    package (tools/lpips_standin.py); #1 / #2 / #3 counted; the metrics
    held against the CPU. Returns the eval's eval_rays_per_sec."""
    from consistentnerf_tpu_torch.cli import export_lpips_weights
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.data import images
    from consistentnerf_tpu_torch.data.loaders import load_scene

    tag = f"[{card}]"
    png_kinds = tools_module("png_kinds")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "png_kinds.json")) as f:
        digests = json.load(f)
    for name, kind, path in kinds["files"]:
        t0 = time.perf_counter()
        img = images.imread(path)
        dt = time.perf_counter() - t0
        got = png_kinds.decoded_digest(img)
        want = digests[name]
        log(f"{tag} PNG decode (host), {name} ({kind}, "
            f"{os.path.getsize(path)} bytes): {1e3 * dt:.1f} ms, "
            f"{dt / (img.shape[0] * img.shape[1] / 1e6):.3f} s a megapixel;"
            f" {got['dtype']} {got['shape']}, imageio's digest "
            f"{'equal' if got['sha256'] == want['sha256'] else 'DIFFERS'}")
        gate(got == {k: want[k] for k in got},
             f"kinds: {name} ({kind}) decoded to {got}, imageio to {want}")
    npz = os.path.join(tmp, "kinds_lpips_vgg.npz")
    saved = sys.modules.get("lpips")
    sys.modules["lpips"] = tools_module("lpips_standin").module(seed=0)
    try:
        export_lpips_weights.main([npz])
    finally:
        if saved is None:
            del sys.modules["lpips"]
        else:
            sys.modules["lpips"] = saved
    sets = [f"{k}={v}" for k, v in FLAGSHIP.items()] + [
        "dataset_type=blender", f"datadir={kinds['dir']}", "half_res=true",
        "train_view_num=3", "i_print=1", f"checkpoint_every={KINDS_STEPS}",
        f"basedir={tmp}", "expname=kinds", f"lpips_weights_path={npz}",
        "eval_render_interval=2"]
    args = ["--device", str(dev)] + [x for s_ in sets
                                     for x in ("--set", s_)]
    cfg = configs.Config(**{**FLAGSHIP, "dataset_type": "blender",
                            "datadir": kinds["dir"], "half_res": True})
    t0 = time.perf_counter()
    scene = load_scene(cfg, device=dev, attach=False)
    log(f"{tag} load_scene lego in the PNG kinds (blender, half_res): "
        f"{time.perf_counter() - t0:.2f} s (host)")
    scene_gates("kinds", scene, kinds, [])
    counted = ((v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (op, "launches", op.KERNEL))
    for mod, attr, _ in counted:
        setattr(mod, attr, 0)
    res = train_cli.main(args + ["--num-steps", str(KINDS_STEPS),
                                 "--eval-after"])
    torch.cuda.synchronize()
    got = {k: getattr(mod, attr) for mod, attr, k in counted}
    views = list(kinds["test"])[::2]
    n_eval = eval_launches(configs.Config(render_chunk_size=CHUNK), scene,
                           len(views), 2)
    want = {v2.KERNEL: 2 * KINDS_STEPS + n_eval,
            v2.BWD_KERNEL: 2 * KINDS_STEPS, op.KERNEL: 2 * KINDS_STEPS}
    metrics = res.metrics
    log(f"kinds cli.train --eval-after: {KINDS_STEPS} one-pass steps, loss "
        f"{float(res.stats_history[-1]['loss']):.5f}, launches {got} "
        f"(expected {want}); metrics " + ", ".join(
            f"{k} {v:.5f}" for k, v in sorted(metrics.items())))
    gate(got == want, f"kinds: the train and eval path launched {got}, "
         f"expected {want}")
    if not all(np.isfinite(float(h["loss"])) for h in res.stats_history):
        fail("kinds: a non-finite loss")
    add(got)
    preds = os.listdir(os.path.join(tmp, "kinds", "test_preds"))
    gate("lpips" in metrics and "LPIPS_UNCALIBRATED.txt" not in preds
         and {"color_000.png", "depth_002.png"} <= set(preds),
         f"kinds: evaluate() did not score LPIPS from the export, or "
         f"wrote {sorted(preds)}")
    eval_metric_gates("kinds", card, args, scene, views, metrics,
                      lambda v: None)
    return metrics["eval_rays_per_sec"]


# The consistency phase: train CLI steps of each run (a fresh experiment
# each), and the reference files it writes, like the reference's own:
# RegNeRF's regnerf3/dtu/scan114_3.gin and a nerf-pytorch fern .txt,
# pointed at the fixtures.
SS_STEPS = 2
SCAN114_GIN = """# DTU settings (regnerf3/dtu/scan114_3.gin), pointed at the fixture
Config.data_dir = "{data_dir}"
Config.dtu_mask_path = '{mask_path}'
Config.checkpoint_dir = "{ckpt}"
Config.dtu_scan = "scan114"
Config.dataset_loader = 'dtu'
Config.white_background = False
Config.near = 0.5
Config.far = 3.5
Config.factor = 2
Config.render_factor = 2
# the grid's masknerf split holds views the fixture has no GT depths for
Config.dtu_split_type = 'pixelnerf'
MLP.density_noise = 1.

Config.n_input_views = 3
Config.max_steps = 43945

Config.lr_init = 0.002
Config.lr_final = 0.00002
Config.lr_delay_steps = 512
Config.lr_delay_mult = 0.01
Config.grad_max_norm = 0.1
Config.grad_max_val = 0.1

Config.anneal_nearfar = True
Config.anneal_nearfar_steps = 256
Config.anneal_nearfar_perc = 0.5

Config.depth_tvnorm_loss_mult = 0.1
Config.depth_tvnorm_decay = True
Config.depth_tvnorm_maxstep = 512
Config.depth_tvnorm_loss_mult_start = 400.0
Config.depth_tvnorm_loss_mult_end = 0.1

Config.flow_loss_mult = 0.0
Config.depth_tvnorm_mask_weight = 1.0
"""
FERN_TXT = """expname = {expname}
basedir = {basedir}
datadir = {datadir}
dataset_type = llff
factor = {factor}
llffhold = 8

N_rand = 1024
N_samples = 64
N_importance = 64
use_viewdirs = True
hardmask
with_depth_loss = True
near = 0.
far = 1.
i_print = 1
"""


def consistency_phases(dev, card, configs, v2, fmip, op, pdf_merge, tmp,
                       fx):
    """36. The experiment grid and the consistency variants on the fern
    and scan114 fixtures (`fx`, under `tmp`): cli/export_configs (147
    files, fern_3view loaded back equal); cli/train.py from the
    fern_3view preset (fp32, the one-pass vanilla step: #1, #2, #3), from
    a reference .gin like regnerf3/dtu/scan114_3.gin (fp32, the one-pass
    mip step with the TV norm: #5, #6, #7) and from a reference .txt for
    fern; the fern_3view and regnerf3_dtu_scan114 presets' fp32 steps
    (#5 and #7 on the fp32 level walk) timed and guarded against the
    eager steps; ss_loss on fern through the train CLI on the one-pass
    step (#3 four a step: main and reference rays, both levels) and the v2
    two-call step (#1 / #2 four a step), with use_pdf_kernel off and on
    (#8 three and two a step); the ss_loss steps guarded against the
    eager step at both gate values, the one-pass step's #3 dW repeated
    bit for bit, both steps timed with and without ss_loss; and the
    softmask PNGs, canny and sobel masks of fern (non-empty on the train
    views, empty elsewhere), each trained through the CLI."""
    import copy
    import warnings

    from consistentnerf_tpu_torch.cli import export_configs
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.configs import scenes
    from consistentnerf_tpu_torch.data import images, synthetic
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import step as step_lib

    tag = f"[{card}]"
    launches = {}
    vanilla = ((v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (op, "launches", op.KERNEL),
               (pdf_merge, "launches", pdf_merge.KERNEL))
    mip = ((fmip, "launches", fmip.KERNEL),
           (fmip, "bwd_launches", fmip.BWD_KERNEL),
           (op, "mip_launches", op.MIP_KERNEL))

    def sets(items):
        return [x for s_ in items for x in ("--set", s_)]

    def cli_run(label, argv, per_step, counted=vanilla, check=None):
        """The train CLI for SS_STEPS steps, launch counts set to 0 before
        and read after: kernel k must launch per_step[k] a step."""
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        res = train_cli.main(["--device", str(dev), "--num-steps",
                              str(SS_STEPS)] + argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for mod, attr, k in counted}
        want = {k: per_step.get(k, 0) * SS_STEPS for _, _, k in counted}
        last = res.stats_history[-1]
        ss = (f", ss_loss {float(last['ss_loss']):.5f}" if "ss_loss" in last
              else "")
        log(f"{label}: {SS_STEPS} steps in {dt:.1f} s (load included), "
            f"loss {float(last['loss']):.5f}{ss}, launches {got} (expected "
            f"{want})")
        gate(got == want, f"{label}: launched {got}, expected {want}")
        gate(res.state.step == SS_STEPS and all(
            np.isfinite(float(h["loss"])) for h in res.stats_history),
            f"{label}: ended at step {res.state.step} or with a non-finite "
            "loss")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        if check is not None:
            check(last)
        return res

    # 36a. The preset grid on disk.
    out_dir = os.path.join(tmp, "exported_configs")
    export_configs.main([out_dir])
    files = [f for _, _, fs in os.walk(out_dir) for f in fs]
    back = configs.load_config(os.path.join(out_dir, "configs_3view",
                                            "fern.json"))
    same = back.to_json() == scenes.get_scene_config("fern_3view").to_json()
    log(f"cli.export_configs: {len(files)} files; configs_3view/fern.json "
        f"loads back {'equal to' if same else 'unlike'} the fern_3view preset")
    gate(len(files) == len(scenes.list_scenes()) == 147,
         f"export_configs wrote {len(files)} files, not 147")
    gate(same, "configs_3view/fern.json does not load back as fern_3view")

    # 36b. A preset, a reference .gin and a reference .txt through the
    # train CLI, each in the precision its file gives (fp32).
    fern, dtu = fx["fern"], fx["scan114"]
    run = ["i_print=1", f"checkpoint_every={SS_STEPS}", f"basedir={tmp}"]
    cli_run("cli.train --scene fern_3view (fp32, one-pass step)",
            ["--scene", "fern_3view"] + sets(
                [f"datadir={fern['dir']}", f"factor={FERN['factor']}"]
                + run),
            {v2.KERNEL: 2, v2.BWD_KERNEL: 2, op.KERNEL: 2})
    gate(os.path.isdir(os.path.join(tmp, "llff_fern_3view", "checkpoints")),
         "the fern_3view run wrote no checkpoint under its preset expname")
    # The same preset's step as cli/train.py builds it on the card (its
    # config through resolve_config and auto_fused_defaults: fp32, the
    # one-pass step, #3 on the fp32 level walk), timed; and guarded
    # against the eager step from the same state, batch and draws at
    # GUARD_N_RAND random rays (the eager step keeps every activation).
    from consistentnerf_tpu_torch.cli import common

    p_args = common.make_parser("fern_3view").parse_args(
        ["--scene", "fern_3view", "--device", str(dev)] + sets(
            [f"datadir={fern['dir']}", f"factor={FERN['factor']}"] + run))
    p_cfg = common.auto_fused_defaults(common.resolve_config(p_args), p_args)
    gate(p_cfg.compute_dtype == "float32" and p_cfg.use_onepass_train,
         "the fern_3view preset on the card is not the fp32 one-pass step")
    p_scene = load_scene(p_cfg, device=str(dev))
    p_state = loop.init_state(p_cfg, dev)
    p_batcher = VanillaBatcher(p_scene, p_cfg)
    p_batches = [to_device(p_batcher.next_batch(), dev) for _ in range(4)]
    n_p = p_batches[0]["rgb"].shape[0]
    bench_steps(f"fern_3view preset step (fp32, one-pass, {n_p} rays)", tag,
                loop.select_train_step(p_cfg, p_state.model), p_state,
                p_batches, n_p)
    del p_state, p_batches
    g_cfg = p_cfg.replace(N_rand=GUARD_N_RAND)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(p_scene, g_cfg).next_batch(), dev)
    guard_steps(f"fern_3view preset step guard (N_rand {GUARD_N_RAND}, "
                "fp32)", loop.select_train_step(g_cfg, g_state.model),
                step_lib.build_vanilla_train_step(g_state.model, g_cfg),
                g_state, g_batch, step_lib.make_draws(
                    g_cfg, g_batch["rgb"].shape[0],
                    step_lib.step_generator(g_cfg.seed, 0, dev), dev))
    del g_state, g_batch, p_scene
    torch.cuda.empty_cache()
    gin = os.path.join(tmp, "scan114_3.gin")
    with open(gin, "w") as f:
        f.write(SCAN114_GIN.format(
            data_dir=os.path.join(os.path.dirname(dtu["dir"]), "Rectified")
            + "/", mask_path=dtu["mask_path"],
            ckpt=os.path.join(tmp, "dtu3_114")))
    gcfg = configs.load_config(gin)
    log(f"scan114_3.gin: backbone {gcfg.backbone}, datadir {gcfg.datadir}, "
        f"expname {gcfg.expname}, total_iters {gcfg.total_iters}, "
        f"N_rand {gcfg.N_rand} + {gcfg.n_patches}x{gcfg.patch_size}^2, "
        f"random-pose rays {gcfg.batch_size_random}")
    gate(gcfg.backbone == "mipnerf" and gcfg.expname == "dtu3_114"
         and gcfg.datadir == os.path.normpath(dtu["dir"]),
         "the gin file did not load onto the scan114 fixture")

    def tv_engaged(stats):
        tv = np.asarray(stats["patch_tv_losses"])
        gate(tv.shape == (2,) and np.all(np.isfinite(tv)) and tv[-1] > 0,
             f"the gin run's TV norm did not engage: {tv}")

    cli_run("cli.train --config scan114_3.gin (mip, fp32, one-pass step, "
            "TV norm)", ["--config", gin] + sets(["i_print=1"]),
            {fmip.KERNEL: 4, fmip.BWD_KERNEL: 4, op.MIP_KERNEL: 2},
            counted=mip, check=tv_engaged)
    # The regnerf3_dtu_scan114 preset's step as cli/train.py builds it on
    # the card (fp32, the one-pass mip step with the TV norm: #5 on the
    # data rays and #6 + #7 on the MiDaS patch rays and on the random-pose
    # rays, #5 and #7 on the fp32 level walk), on the scan114 fixture,
    # timed beside fern_3view's and guarded against the eager mip step
    # (randomized=False: a stochastic level 1 magnifies ~1e-7
    # differences through its inverse CDF).
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher
    from consistentnerf_tpu_torch.data.random_poses import \
        generate_random_poses

    d_args = common.make_parser("regnerf3_dtu_scan114").parse_args(
        ["--scene", "regnerf3_dtu_scan114", "--device", str(dev)] + sets(
            [f"datadir={dtu['dir']}", f"dtu_mask_path={dtu['mask_path']}",
             # the preset's masknerf split holds views the fixture has no
             # GT depths for (as in the gin file above)
             "dtu_split_type=pixelnerf"] + run))
    d_cfg = common.auto_fused_defaults(common.resolve_config(d_args), d_args)
    gate(d_cfg.compute_dtype == "float32" and d_cfg.use_onepass_train
         and d_cfg.backbone == "mipnerf" and d_cfg.load_random_rays,
         "the regnerf3_dtu_scan114 preset on the card is not the fp32 "
         "one-pass mip step with the TV norm")
    d_scene = load_scene(d_cfg, device=str(dev))
    d_poses = generate_random_poses(
        d_scene.poses[d_scene.i_train], n_poses=d_cfg.n_random_poses,
        pose_type=d_cfg.random_pose_type, radius=d_cfg.random_pose_radius,
        focusptjitter=d_cfg.random_pose_focusptjitter,
        add_test_poses=d_cfg.random_pose_add_test_poses,
        test_poses=d_scene.poses[d_scene.i_test])
    d_state = loop.init_state(d_cfg, dev)
    d_batcher = MipBatcher(d_scene, d_cfg, random_poses=d_poses)
    d_batches = [to_device(d_batcher.next_batch(), dev) for _ in range(4)]
    n_d = d_batches[0]["rays"].origins.shape[0]
    n_tv = d_batches[0]["rays_random"].origins.shape[0]
    for mod, attr, _ in mip:
        setattr(mod, attr, 0)
    d_step = loop.select_train_step(d_cfg, d_state.model)
    bench_steps(f"regnerf3_dtu_scan114 preset step (fp32, one-pass mip, TV "
                f"norm, {n_d} + {n_tv} random-pose rays)", tag, d_step,
                d_state, d_batches, n_d + n_tv)
    got = {k: getattr(mod, attr) for mod, attr, k in mip}
    per = {k: v / (TIMED_STEPS + 2) for k, v in got.items()}
    log(f"regnerf3_dtu_scan114 preset step launches a step: {per} "
        "(expected #6 4, #7 4, #5 2)")
    gate(per == {fmip.KERNEL: 4, fmip.BWD_KERNEL: 4, op.MIP_KERNEL: 2},
         f"the regnerf3_dtu_scan114 step launched {got}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    del d_state, d_batches, d_step
    g_cfg = d_cfg.replace(randomized=False)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(MipBatcher(d_scene, g_cfg, random_poses=d_poses)
                        .next_batch(), dev)
    guard_steps(f"regnerf3_dtu_scan114 preset step guard ({n_d} + {n_tv} "
                "random-pose rays, fp32)",
                loop.select_train_step(g_cfg, g_state.model),
                step_lib.build_mip_train_step(g_state.model, g_cfg),
                g_state, g_batch)
    del g_state, g_batch, d_scene
    torch.cuda.empty_cache()
    txt = os.path.join(tmp, "fern.txt")
    with open(txt, "w") as f:
        f.write(FERN_TXT.format(expname="fern_txt", basedir=tmp,
                                datadir=fern["dir"], factor=FERN["factor"]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cli_run("cli.train --config fern.txt (fp32, one-pass step)",
                ["--config", txt],
                {v2.KERNEL: 2, v2.BWD_KERNEL: 2, op.KERNEL: 2})
    named = [str(w.message) for w in caught if "llffhold" in str(w.message)]
    log(f"fern.txt: llffhold skipped with a warning: {named[:1]}")
    gate(bool(named), "fern.txt: llffhold was not skipped with a warning")

    # 36c. ss_loss on fern through the train CLI.
    fern_sets = [f"{k}={v}" for k, v in FLAGSHIP.items()] + [
        "dataset_type=llff", f"datadir={fern['dir']}",
        f"factor={FERN['factor']}", "white_bkgd=false", "near=0.0",
        "far=1.0", "train_view_num=3"] + run

    def has_ss(stats):
        gate("ss_loss" in stats and np.isfinite(float(stats["ss_loss"])),
             "an ss_loss run reported no finite ss_loss")

    for onepass in (True, False):
        for pdf in (False, True):
            step = "one-pass" if onepass else "two-call v2"
            per_step = ({v2.KERNEL: 2, v2.BWD_KERNEL: 2, op.KERNEL: 4,
                         pdf_merge.KERNEL: 3 * pdf} if onepass else
                        {v2.KERNEL: 4, v2.BWD_KERNEL: 4,
                         pdf_merge.KERNEL: 2 * pdf})
            cli_run(f"cli.train fern ss_loss, {step} step, use_pdf_kernel "
                    f"{pdf}", sets(fern_sets + [
                        "ss_loss=true", f"use_onepass_train={onepass}",
                        f"use_pdf_kernel={pdf}",
                        f"expname=ss_{int(onepass)}{int(pdf)}"]),
                    per_step, check=has_ss)

    # 36d. Guards against the eager step at both gate values, the #3 dW
    # repeat, and the step times with and without ss_loss.
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    for name, kw in (("one-pass", {}),
                     ("one-pass, use_pdf_kernel", {"use_pdf_kernel": True}),
                     ("two-call v2", {"use_onepass_train": False})):
        g_cfg = configs.Config(**{**FLAGSHIP, "N_rand": GUARD_N_RAND,
                                  "ss_loss": True, **kw})
        g_state = loop.init_state(g_cfg, dev)
        g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
        n = g_batch["rgb"].shape[0]
        draws = step_lib.make_draws(g_cfg, n, step_lib.step_generator(
            g_cfg.seed, 0, dev), dev)
        kernel = loop.select_train_step(g_cfg, g_state.model)
        eager = step_lib.build_vanilla_train_step(g_state.model, g_cfg)
        for value in (True, False):
            d = dict(draws, ss=dict(draws["ss"], gate=torch.tensor(
                value, device=dev)))
            (_, st_k), (_, st_e) = guard_steps(
                f"ss_loss {name} step guard vs eager (gate {value}, N_rand "
                f"{GUARD_N_RAND} + {n} reference rays, bf16)", kernel, eager,
                g_state, g_batch, d)
            ss_k, ss_e = float(st_k["ss_loss"]), float(st_e["ss_loss"])
            log(f"  ss_loss kernel {ss_k:.6f} eager {ss_e:.6f}")
            gate(abs(ss_k - ss_e) < STEP_LOSS_TOL * abs(ss_e),
                 f"ss_loss {name} (gate {value}): the ss term disagrees")
        if not kw:
            # #3's dW of its four launches, twice from the same inputs.
            dws, real = [], op.onepass_level

            def spy(*a, **k):
                out = real(*a, **k)
                dws[-1].append([t.clone() for t in out[1]])
                return out

            op.onepass_level = spy
            try:
                for _ in range(2):
                    dws.append([])
                    kernel(copy.deepcopy(g_state), g_batch, d)
            finally:
                op.onepass_level = real
            torch.cuda.synchronize()
            same = len(dws[0]) == len(dws[1]) == 4 and all(
                torch.equal(a, b) for x, y in zip(*dws) for a, b in zip(x, y))
            log(f"ss_loss one-pass step, a repeat: #3's dW of its "
                f"{len(dws[0])} launches {'bit-identical' if same else 'DIFFER'}")
            gate(same, "ss_loss one-pass step: a repeat gave other dW bits")
        del g_state
        torch.cuda.empty_cache()
    step_ms = {}
    for name, kw in (("one-pass", {}),
                     ("two-call v2", {"use_onepass_train": False})):
        for ss in (False, True):
            cfg = configs.Config(**{**FLAGSHIP, **kw, "ss_loss": ss})
            t_state = loop.init_state(cfg, dev)
            step_fn = loop.select_train_step(cfg, t_state.model)
            batcher = VanillaBatcher(scene, cfg)
            batches = [to_device(batcher.next_batch(), dev)
                       for _ in range(4)]
            n = batches[0]["rgb"].shape[0]
            step_ms[name, ss] = bench_steps(
                f"{name} step (flagship, {n} rays"
                + (f", ss_loss on {n} reference rays)" if ss else ")"),
                tag, step_fn, t_state, batches, n)
            del t_state, batches
            torch.cuda.empty_cache()
        off, on = step_ms[name, False], step_ms[name, True]
        log(f"{tag} {name} step with ss_loss: {off:.2f} -> {on:.2f} ms/step "
            f"(+{on - off:.2f} ms, x{on / off:.3f})")

    # 36e. The softmask PNGs (under a working directory of their own),
    # canny and sobel masks of fern, each trained through the CLI.
    soft_cwd = os.path.join(tmp, "softmask_cwd")
    sdir = os.path.join(soft_cwd, "Softmask", "llff",
                        os.path.basename(os.path.normpath(fern["dir"])),
                        "iter_500")
    os.makedirs(sdir)
    h, w = FERN["hw"]
    yy, xx = np.mgrid[:h, :w]
    rng = np.random.RandomState(5)
    for i in FERN_SPLITS[0]:
        blob = ((yy - rng.uniform(0.3, 0.7) * h) ** 2
                + (xx - rng.uniform(0.3, 0.7) * w) ** 2) < (0.3 * h) ** 2
        images.write_png(os.path.join(sdir, f"softmask_{i:04d}_30per.png"),
                         (blob * rng.randint(1, 256, (h, w))).astype(
                             np.uint8))
    cwd = os.getcwd()
    mask_sets = [s_ for s_ in fern_sets if not s_.startswith("basedir=")]
    for flag in ("softmask", "use_canny_edge_detection",
                 "use_sobel_edge_detection"):
        cfg = configs.load_config(None, mask_sets + [
            f"{flag}=true", f"basedir={tmp}", f"expname=load_{flag}"])
        if flag == "softmask":
            os.chdir(soft_cwd)
        try:
            t0 = time.perf_counter()
            sc = load_scene(cfg, device=dev)
            dt = time.perf_counter() - t0
            train = [int(i) for i in sc.i_train]
            rest = [i for i in range(len(sc.images)) if i not in train]
            share = float(sc.masks[train].mean())
            ok = (all(sc.masks[i].any() for i in train)
                  and not sc.masks[rest].any())
            log(f"fern {flag}: masks attached in {dt:.2f} s (host), "
                f"{share:.4f} of the train views' pixels {train} set, the "
                f"other {len(rest)} views {'empty' if ok else 'NOT empty'}")
            gate(ok, f"fern {flag}: the masks are empty on a train view or "
                 "set elsewhere")
            cli_run(f"cli.train fern {flag} (one-pass step)",
                    sets(mask_sets + [f"{flag}=true", f"basedir={tmp}",
                                      f"expname=mask_{flag}"]),
                    {v2.KERNEL: 2, v2.BWD_KERNEL: 2, op.KERNEL: 2})
        finally:
            os.chdir(cwd)
    return {"launches": launches, "step_ms": step_ms}


# The depth-prior producers on the same fixtures. The MVS net at
# the JAX package's defaults (32 planes, base width 8, 2 sources) on
# scan114 at the loader's 512x640 (a 32 x 128 x 160 cost volume) and on
# lego at 400x400; the warmup bootstrap at the flagship width (the
# lego_3view preset: 8x256, 64 + 128 samples, 4096 + 4x16x16 rays, bf16,
# the one-pass step).
MVS_STEPS = 24  # steps of each train_mvs run: 8 rounds of 3 train views
BOOT_WARMUP = 20  # warmup steps of the bootstrap
BOOT_STEPS = 3  # retrain steps after it
MVS_BOOT_STEPS = 6  # MVS steps of the bootstrap_mode=mvs run
MVS_CPU_LOSS_RTOL = 1e-4  # one MVS step's loss, card (strict fp32) vs CPU
MVS_PREDICT_TOL = 1e-5  # a second predict vs the first, of the depth range
# bootstrap.py's refusal of NDC scenes, as the JAX package words it
# (consistentnerf_tpu/train/bootstrap.py:90-95).
NDC_REFUSAL = ("bootstrap priors need metric depth; NDC (forward-facing "
               "LLFF) scenes are not supported — train with spherify or "
               "provide external priors")


def jfif_ok(path, h, w):
    """A baseline greyscale JFIF of h x w: SOI, APP0 'JFIF', an 8-bit
    one-component SOF0 of that size, EOI."""
    with open(path, "rb") as f:
        data = f.read()
    sof = data.find(b"\xff\xc0")
    return (data[:2] == b"\xff\xd8" and data[6:11] == b"JFIF\x00"
            and data[-2:] == b"\xff\xd9" and sof > 0 and data[sof + 4] == 8
            and int.from_bytes(data[sof + 5: sof + 7], "big") == h
            and int.from_bytes(data[sof + 7: sof + 9], "big") == w
            and data[sof + 9] == 1)


def producer_phases(dev, card, configs, v2, op, tmp, fx):
    """37. The depth-prior producers on the fixtures (`fx`, under `tmp`):
    cli/train_mvs.py --with-masks on scan114 (GT depths: the supervised
    branch) in fp32 and bf16, its PFMs against predict_depth_priors, its
    JPGs' headers, one step's loss on the card against the CPU, and its
    step / predict times and peak memory; on lego (no GT: photometric +
    smoothness), its loss falling; cli/train.py --bootstrap-priors on
    lego from the lego_3view preset (bf16, one-pass step: #3 and #2 2 a
    warmup and a retrain step, #1 2 a step and 2 a render chunk of
    render_warmup_depths), the exported priors and masks against the
    retrain's scene, compute_hard_masks and the warmup's acc; the same
    with bootstrap_mode=mvs; cli/export_depth_priors.py from the
    retrain's checkpoint against render(); cli/make_masks.py on the
    exported priors against attach_masks; and the NDC refusal on fern."""
    import dataclasses

    from consistentnerf_tpu_torch.data import loaders

    tag = f"[{card}]"
    counted = ((v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (op, "launches", op.KERNEL))
    launches = {}
    # Each fixture is decoded once in this phase (the eval phase times the
    # loads): read_scene returns a copy of the first read with the same
    # reader and arguments, and load_scene attaches the priors and masks
    # to it as it always does.
    real_read, reads = loaders.read_scene, {}

    def cached_read(cfg_):
        fn, kwargs = loaders.scene_reader(cfg_)
        key = (fn.__module__, fn.__name__, tuple(sorted(kwargs.items())))
        if key not in reads:
            t0 = time.perf_counter()
            reads[key] = real_read(cfg_)
            log(f"{tag} read_scene {os.path.basename(cfg_.datadir)} "
                f"{cfg_.dataset_type}: {time.perf_counter() - t0:.2f} s "
                "(host)")
        return dataclasses.replace(reads[key])

    loaders.read_scene = cached_read
    try:
        return _producer_runs(dev, card, configs, v2, op, tmp, fx, tag,
                              counted, launches)
    finally:
        loaders.read_scene = real_read


def _producer_runs(dev, card, configs, v2, op, tmp, fx, tag, counted,
                   launches):
    """The body of producer_phases, with the fixtures' reads cached."""
    from consistentnerf_tpu_torch.cli import export_depth_priors, make_masks
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.cli import train_mvs
    from consistentnerf_tpu_torch.configs import scenes
    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.data import loaders, pfm
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import bootstrap, loop
    from consistentnerf_tpu_torch.train import mvs as mvs_train
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    def zero():
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)

    def read():
        return {k: getattr(mod, attr) for mod, attr, k in counted}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def args(items):
        return ["--device", str(dev)] + [x for s_ in items
                                         for x in ("--set", s_)]

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    load_scene, attach_masks = loaders.load_scene, loaders.attach_masks
    dtu, lego, fern = fx["scan114"], fx["lego"], fx["fern"]

    # 37a. The MVS net through cli/train_mvs.py, every step timed.
    step_log = []
    real_build = mvs_train.build_mvs_train_step

    def timed_build(*a, **k):
        step, net, opt = real_build(*a, **k)

        def timed(ref, src):
            t0 = sync()
            loss, stats = step(ref, src)
            step_log.append((sync() - t0, float(loss), sorted(stats)))
            return loss, stats

        return timed, net, opt

    scan_sets = ["dataset_type=dtu", f"datadir={dtu['dir']}",
                 "dtu_split_type=pixelnerf", "train_view_num=3",
                 "white_bkgd=false", f"basedir={tmp}", "expname=mvs114"]
    lego_sets = ["dataset_type=blender", f"datadir={lego['dir']}",
                 "half_res=true", "white_bkgd=true", "train_view_num=3",
                 f"basedir={tmp}", "expname=mvslego"]
    mvs_train.build_mvs_train_step = timed_build
    try:
        for label, base, dtype in (("scan114", scan_sets, "float32"),
                                   ("scan114", scan_sets, "bfloat16"),
                                   ("lego", lego_sets, "float32")):
            sets_ = base + [f"compute_dtype={dtype}"]
            cfg = configs.load_config(None, sets_)
            out = os.path.join(tmp, f"mvs_{label}_{dtype}")
            step_log.clear()
            zero()
            torch.cuda.reset_peak_memory_stats()
            t0 = sync()
            result, priors = train_mvs.main(
                args(sets_) + ["--steps", str(MVS_STEPS), "--out", out,
                               "--with-masks"])
            wall = sync() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            gate(read() == {k: 0 for _, _, k in counted},
                 f"train_mvs {label} launched a kernel of the port: "
                 f"{read()} (its convolutions are PyTorch's)")
            scene = load_scene(cfg, device=dev, attach=False)
            tr = [int(v) for v in scene.i_train]
            again = mvs_train.predict_depth_priors(cfg, scene, result.params,
                                                   device=dev)
            # The per-view forward alone: the net built, loaded and warm
            # on a first view, the views' predictions timed after a sync.
            predict = mvs_train.view_predictor(cfg, scene, result.params,
                                               device=dev)
            predict(tr[0])
            t0 = sync()
            for v in tr:
                predict(v)
            predict_ms = 1e3 * (sync() - t0) / len(tr)
            times = sorted(t for t, _, _ in step_log[1:])
            step_ms = 1e3 * times[len(times) // 2]
            losses = [l_ for _, l_, _ in step_log]
            supervised = all("sup_l1" in k for _, _, k in step_log)
            hr, wr = -(-scene.H // 4), -(-scene.W // 4)
            log(f"{tag} cli.train_mvs {label} ({dtype}, "
                f"{cfg.mvs_num_depths} x {hr} x {wr} cost volume, "
                f"base {cfg.mvs_base_ch}, {'GT-supervised' if supervised else 'photometric'}): "
                f"{MVS_STEPS} steps, step {step_ms:.2f} ms (the median after "
                f"the first; the first {1e3 * step_log[0][0]:.1f} ms), "
                f"predict {predict_ms:.2f} ms a view (warm net, forwards "
                f"only), peak "
                f"torch.cuda.max_memory_allocated {peak:.2f} GiB, wall "
                f"{wall:.1f} s (load included); loss {losses[0]:.5f} -> "
                f"{losses[-1]:.5f}")
            gate(all(np.isfinite(losses)), f"train_mvs {label} {dtype}: a "
                 "non-finite loss")
            gate(supervised == (label == "scan114"),
                 f"train_mvs {label}: supervised {supervised}, expected "
                 f"{label == 'scan114'} (depth_is_gt {scene.depth_is_gt})")
            span = float(scene.far - scene.near)
            gate(float(np.abs(again - priors).max()) <= MVS_PREDICT_TOL * span,
                 f"train_mvs {label} {dtype}: a second predict differs by "
                 f"{float(np.abs(again - priors).max())}")
            same, jpg = True, True
            for v in tr:
                depth = np.asarray(pfm.read_pfm(os.path.join(
                    out, f"depth_{v:04d}.pfm"))[0], np.float32)
                same &= np.array_equal(depth, priors[v])
                jpg &= jfif_ok(os.path.join(out, f"{v}_mask_mvs.jpg"),
                               scene.H, scene.W)
            kept = float((priors[tr] > 0).mean())
            log(f"  {label} {dtype}: PFMs read back equal the predicted "
                f"priors: {same}; JPGs baseline JFIF {scene.H}x{scene.W}: "
                f"{jpg}; {kept:.4f} of the train pixels keep a prior")
            gate(same, f"train_mvs {label} {dtype}: the PFMs are not the "
                 "predicted priors")
            gate(jpg, f"train_mvs {label} {dtype}: a mask JPG is not a "
                 "baseline JFIF of the image's size")
            if label == "lego":
                first, last = np.mean(losses[:3]), np.mean(losses[-3:])
                log(f"  lego photometric loss, first round {first:.5f}, "
                    f"last round {last:.5f}")
                gate(last < first, f"train_mvs lego: the self-supervised "
                     f"loss did not fall ({first} -> {last})")
            if label == "scan114" and dtype == "float32":
                # One step, card (strict fp32) against the CPU, from the
                # same seeded init on the same triple.
                src = mvs_train.mvs_lib.select_source_views(
                    scene.poses, scene.i_train, tr[0], cfg.mvs_n_src)
                losses_d = []
                for d in (dev, torch.device("cpu")):
                    step, _, _ = real_build(cfg, scene, use_gt=supervised,
                                            device=d)
                    t0 = time.perf_counter()
                    losses_d.append(float(step(tr[0], src)[0]))
                    dt = time.perf_counter() - t0
                    log(f"  {label} one MVS step on {d}: loss "
                        f"{losses_d[-1]:.7f} ({dt:.2f} s, host clock)")
                rel = abs(losses_d[0] / losses_d[1] - 1)
                log(f"  {label} step loss, card vs CPU: rel {rel:.2e} "
                    f"(tol {MVS_CPU_LOSS_RTOL})")
                gate(rel < MVS_CPU_LOSS_RTOL, f"train_mvs {label}: the "
                     f"card's step loss is {rel:.2e} from the CPU's")
            del scene
            torch.cuda.empty_cache()
    finally:
        mvs_train.build_mvs_train_step = real_build

    # 37b. The warmup bootstrap through cli/train.py --bootstrap-priors,
    # each stage's launches counted by spies on loop.train and
    # render_warmup_depths.
    boot_sets = [f"datadir={lego['dir']}", "compute_dtype=bfloat16",
                 "i_print=1", f"checkpoint_every={BOOT_STEPS}",
                 f"basedir={tmp}"]
    stages = []
    real_train, real_render = loop.train, bootstrap.render_warmup_depths

    def spy_train(cfg_, scene_, *a, **k):
        before, t0 = read(), sync()
        res = real_train(cfg_, scene_, *a, **k)
        dt = sync() - t0
        stages.append(dict(kind="train", expname=cfg_.expname, scene=scene_,
                           cfg=cfg_, result=res, seconds=dt, launches={
                               k_: v - before[k_]
                               for k_, v in read().items()}))
        return res

    def spy_render(warm_cfg, scene_, model):
        before, t0 = read(), sync()
        out = real_render(warm_cfg, scene_, model)
        dt = sync() - t0
        stages.append(dict(kind="render", depths=out, seconds=dt,
                           launches={k_: v - before[k_]
                                     for k_, v in read().items()}))
        return out

    def boot_run(label, extra, warm, steps):
        stages.clear()
        loop.train, bootstrap.render_warmup_depths = spy_train, spy_render
        zero()
        try:
            t0 = sync()
            train_cli.main(["--scene", "lego_3view"] + args(extra)
                           + ["--num-steps", str(steps),
                              "--bootstrap-priors", str(warm)])
            wall = sync() - t0
        finally:
            loop.train, bootstrap.render_warmup_depths = (real_train,
                                                          real_render)
        add(read())
        log(f"{tag} cli.train --scene lego_3view --bootstrap-priors {warm} "
            f"({label}): wall {wall:.1f} s (load, producer, fusion, masks, "
            f"{steps} retrain steps); stages: " + "; ".join(
                f"{s_['kind']} {s_.get('expname', '')} {s_['seconds']:.2f} s "
                f"launches {s_['launches']}" for s_ in stages))
        return stages[-1], wall

    boot_cfg = configs.parse_overrides(scenes.get_scene_config("lego_3view"),
                                       boot_sets + ["expname=boot_lego"])
    retrain, boot_wall = boot_run("warmup", boot_sets + ["expname=boot_lego"],
                                  BOOT_WARMUP, BOOT_STEPS)
    warm_stage, render_stage = stages[0], stages[1]
    scene = retrain["scene"]
    tr = [int(v) for v in scene.i_train]
    chunks = -(-scene.H * scene.W // boot_cfg.render_chunk_size)
    per_step = {v2.KERNEL: 2, v2.BWD_KERNEL: 2, op.KERNEL: 2}
    for stage, n_steps in ((warm_stage, BOOT_WARMUP), (retrain, BOOT_STEPS)):
        want = {k: n * n_steps for k, n in per_step.items()}
        gate(stage["launches"] == want, f"bootstrap {stage['expname']}: "
             f"launched {stage['launches']}, expected {want}")
    want = {v2.KERNEL: 2 * chunks * len(tr), v2.BWD_KERNEL: 0, op.KERNEL: 0}
    gate(render_stage["launches"] == want, f"render_warmup_depths launched "
         f"{render_stage['launches']}, expected {want} (2 a render chunk)")
    gate([s_["kind"] for s_ in stages] == ["train", "render", "train"]
         and warm_stage["expname"] == "boot_lego_warmup"
         and retrain["expname"] == "boot_lego",
         f"the bootstrap's stages ran as {[s_['kind'] for s_ in stages]}")
    export = os.path.join(tmp, "boot_lego", "bootstrap_priors")
    names = sorted(os.listdir(export))
    gate(names == sorted([f"depth_{v:04d}.pfm" for v in tr]
                         + [f"{v}_mask_boot.jpg" for v in tr]),
         f"bootstrap_priors/ holds {names}")
    read_back = np.zeros(scene.depths.shape, np.float32)
    for v in tr:
        read_back[v] = pfm.read_pfm(os.path.join(export,
                                                 f"depth_{v:04d}.pfm"))[0]
    masks = reproject.compute_hard_masks(
        scene.poses, read_back, scene.K, tr, scene.H, scene.W,
        occlusion_threshold=boot_cfg.occlusion_threshold, device=dev)
    warm_model = warm_stage["result"].state.model.eval()
    render = render_lib.build_render_fn(warm_model, warm_stage["cfg"])
    acc = np.stack([render(camera_rays_for_view(scene, scene.poses[v],
                                                device=dev))["acc"].cpu()
                    .numpy() for v in tr])
    fused, raw = read_back[tr], render_stage["depths"][tr]
    checks = {
        "PFMs equal the retrain's priors": np.array_equal(
            read_back[tr], scene.depths[tr]),
        "retrain masks equal compute_hard_masks of the PFMs": np.array_equal(
            scene.masks, masks.astype(np.float32)),
        "fused priors zero where the warmup's acc <= 0.5": not fused[
            acc <= 0.5].any(),
        "raw priors zero where acc <= 0.5": not raw[acc <= 0.5].any(),
        "JPGs baseline JFIF": all(jfif_ok(os.path.join(
            export, f"{v}_mask_boot.jpg"), scene.H, scene.W) for v in tr),
        "depth_is_gt False": scene.depth_is_gt is False,
    }
    log(f"{tag} bootstrap (warmup) on lego, {BOOT_WARMUP} + {BOOT_STEPS} "
        f"steps: warmup {warm_stage['seconds']:.2f} s, render "
        f"{render_stage['seconds']:.2f} s ({len(tr)} views, {chunks} chunks "
        f"each), retrain {retrain['seconds']:.2f} s, wall {boot_wall:.1f} s; "
        f"priors kept {float((fused > 0).mean()):.4f} of the train pixels "
        f"(raw {float((raw > 0).mean()):.4f}, acc > 0.5 "
        f"{float((acc > 0.5).mean()):.4f}), masks "
        f"{float(scene.masks[tr].mean()):.4f}; " + ", ".join(
            f"{k}: {v}" for k, v in checks.items()))
    for k, v in checks.items():
        gate(bool(v), f"bootstrap on lego: {k} fails")
    del render, warm_model, stages[:]
    torch.cuda.empty_cache()

    # 37c. bootstrap_mode=mvs, the MVS net's priors into the retrain.
    mvs_retrain, mvs_wall = boot_run(
        "mvs", boot_sets + ["bootstrap_mode=mvs", "mvs_conf_thresh=0.0",
                            "expname=boot_lego_mvs"],
        MVS_BOOT_STEPS, 1)
    sc = mvs_retrain["scene"]
    mvs_export = os.path.join(tmp, "boot_lego_mvs", "bootstrap_priors")
    ok = ([s_["kind"] for s_ in stages] == ["train"]
          and mvs_retrain["launches"] == per_step
          and float(sc.depths[tr].max()) > 0
          and set(np.unique(sc.masks)) <= {0.0, 1.0}
          and len(os.listdir(mvs_export)) == 2 * len(tr))
    log(f"bootstrap (mvs, {MVS_BOOT_STEPS} MVS steps + 1 retrain step): "
        f"retrain launches {mvs_retrain['launches']}, priors kept "
        f"{float((sc.depths[tr] > 0).mean()):.4f}, masks "
        f"{float(sc.masks[tr].mean()):.4f}, {len(os.listdir(mvs_export))} "
        f"files exported: {'ok' if ok else 'FAILED'}")
    gate(ok, "bootstrap_mode=mvs on lego")
    del sc, mvs_retrain
    stages.clear()

    # 37d. export_depth_priors from the retrain's checkpoint, held
    # against render() of the restored model; make_masks on those priors,
    # laid out as the Blender loader reads them, against attach_masks.
    exp_sets = boot_sets + ["expname=boot_lego", "use_fused_render=true"]
    exp_cfg = configs.parse_overrides(scenes.get_scene_config("lego_3view"),
                                      exp_sets)
    exported = os.path.join(tmp, "exported_lego")
    zero()
    t0 = sync()
    step = export_depth_priors.main(["--scene", "lego_3view"]
                                    + args(exp_sets)
                                    + ["--out", exported, "--views", "all"])
    dt = sync() - t0
    got = read()
    n_views = len(scene.images)
    want = {v2.KERNEL: 2 * chunks * n_views, v2.BWD_KERNEL: 0, op.KERNEL: 0}
    add(got)
    model = make_model(exp_cfg, dev)
    CheckpointManager(os.path.join(tmp, "boot_lego", "checkpoints")
                      ).restore_for_eval(model, step)
    render = render_lib.build_render_fn(model.eval(), exp_cfg)
    depths = {}
    same = True
    for v in range(n_views):
        depths[v] = np.asarray(pfm.read_pfm(os.path.join(
            exported, f"depth_{v:04d}.pfm"))[0], np.float32)
        want_d = render(camera_rays_for_view(
            scene, scene.poses[v], device=dev))["depth"].float().cpu().numpy()
        same &= np.array_equal(depths[v], want_d)
    log(f"{tag} cli.export_depth_priors (step {step}, {n_views} views, "
        f"use_fused_render): {dt:.2f} s, launches {got} (expected {want}); "
        f"PFMs equal render()['depth'] of the restored model bit for bit: "
        f"{same}")
    gate(step == BOOT_STEPS and got == want, f"export_depth_priors: step "
         f"{step}, launches {got}")
    gate(same, "export_depth_priors: a PFM is not render()'s depth")
    del render, model

    frames = LEGO_SPLITS[0] + LEGO_SPLITS[1] + LEGO_SPLITS[1]
    layout = os.path.join(tmp, "nerf_synthesic_data_depth_boot", "lego")
    os.makedirs(layout)
    zeros = np.zeros((scene.H, scene.W), np.float32)
    for f in range(LEGO["n"]):
        pfm.write_pfm(os.path.join(layout, f"depth_{f:04d}.pfm"),
                      depths[frames.index(f)] if f in frames else zeros)
    mm_sets = exp_sets + [f"depthdir={layout}"]
    mm_cfg = configs.parse_overrides(scenes.get_scene_config("lego_3view"),
                                     mm_sets)
    masks_dir = os.path.join(tmp, "made_masks")
    t0 = sync()
    make_masks.main(["--scene", "lego_3view"] + args(mm_sets)
                    + ["--out", masks_dir])
    dt = sync() - t0
    made = np.load(os.path.join(masks_dir, "masks.npy"))
    loaded = load_scene(mm_cfg, device=dev, attach=False)
    same_depths = all(np.array_equal(loaded.depths[v], depths[v])
                      for v in range(n_views))
    want_masks = attach_masks(loaded, mm_cfg, None, device=dev).masks > 0
    jpgs = all(jfif_ok(os.path.join(masks_dir, f"{i}_mask_3view.jpg"),
                       scene.H, scene.W) for i in range(n_views))
    log(f"{tag} cli.make_masks on the exported priors: {dt:.2f} s (load "
        f"included); masks.npy {made.shape} {made.dtype}, train share "
        f"{float(made[tr].mean()):.4f}; equals attach_masks': "
        f"{np.array_equal(made, want_masks)}; the loader read the exported "
        f"depths: {same_depths}; JPGs baseline JFIF: {jpgs}")
    gate(np.array_equal(made, want_masks) and same_depths and jpgs,
         "make_masks on the exported priors")
    del loaded, scene

    # 37e. The NDC refusal (fern is forward-facing LLFF).
    fern_sets = [f"{k}={v}" for k, v in FLAGSHIP.items()] + [
        "dataset_type=llff", f"datadir={fern['dir']}",
        f"factor={FERN['factor']}", "white_bkgd=false", "near=0.0",
        "far=1.0", "train_view_num=3", f"basedir={tmp}",
        "expname=fern_boot"]
    zero()
    try:
        train_cli.main(args(fern_sets) + ["--num-steps", "1",
                                          "--bootstrap-priors", "2"])
        refused = None
    except ValueError as e:
        refused = str(e)
    log(f"cli.train fern --bootstrap-priors: refused with {refused!r}; "
        f"launches {read()}")
    gate(refused == NDC_REFUSAL and read() == {k: 0 for _, _, k in counted},
         "the NDC scene was not refused as the JAX package refuses it")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 38. The whole trainer and its checkpoints
# ---------------------------------------------------------------------------

TRAINER_STEPS = 12  # the train CLI's steps; the resume adds 2
TRAINER_RENDER_EVERY = 6  # held-out renders at steps 6 and 12
LPIPS_CPU_RTOL = 1e-4  # the term, card (strict fp32) vs CPU
LPIPS_GRAD_REL = 1e-3  # its gradient by the patch, rel L2
# One fp32 eager step on the card against the same step on the CPU, from
# the same state, batch and draws: the loss relative, each grad rel L2
# (the fine level's inverse CDF magnifies ~1e-7 differences at multires
# 10, ROADMAP Queue 3 note D).
CPU_STEP_LOSS_RTOL = 1e-4
CPU_STEP_GRAD_REL = 1e-2
PREFETCH_STEPS = 20  # loop steps timed with prefetch on and off


def _mp(obj) -> bytes:
    """A small msgpack encoder for the checkpoint file the mip import
    reads (the public mip-NeRF checkpoints' format): maps with string
    keys, strings, lists, ints, bytes, and the extensions for arrays
    (code 1) and numpy scalars (code 3), each an (shape, dtype name,
    bytes) triple packed the same way."""
    import struct

    if isinstance(obj, dict):
        out = b"\xde" + struct.pack(">H", len(obj))
        for k, v in obj.items():
            out += _mp(str(k)) + _mp(v)
        return out
    if isinstance(obj, str):
        raw = obj.encode()
        return b"\xda" + struct.pack(">H", len(raw)) + raw
    if isinstance(obj, (list, tuple)):
        return b"\xdc" + struct.pack(">H", len(obj)) + b"".join(
            _mp(x) for x in obj)
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.array(obj, order="C")  # a scalar stays 0-d
        payload = _mp([list(arr.shape), arr.dtype.name, arr.tobytes()])
        code = 1 if isinstance(obj, np.ndarray) else 3
        return (b"\xc9" + struct.pack(">Ib", len(payload), code) + payload)
    if isinstance(obj, bool) or not isinstance(obj, int):
        raise TypeError(f"not encoded: {type(obj)}")
    return b"\xd3" + struct.pack(">q", obj)


def grads_of(model):
    return [torch.zeros_like(p) if p.grad is None else p.grad.detach()
            .clone() for p in model.parameters()]


def cpu_step_gate(label, cfg, build, state, batch, draws, move, dev,
                  loss_rtol=None, grad_rel=None, whole_rel=None):
    """One eager step on the card and on the CPU from copies of `state`,
    with `batch` and `draws` (made on the CPU) moved to each device:
    the loss and every grad that the update reads, against the CPU's
    (within CPU_STEP_LOSS_RTOL / CPU_STEP_GRAD_REL a tensor unless given;
    `whole_rel`: also the relative L2 of all grads together). Returns the
    CPU's loss."""
    loss_rtol = CPU_STEP_LOSS_RTOL if loss_rtol is None else loss_rtol
    grad_rel = CPU_STEP_GRAD_REL if grad_rel is None else grad_rel
    import copy

    out = {}
    for dev_ in (str(dev), "cpu"):
        st = copy.deepcopy(state)
        st.model.to(dev_)  # in place: the optimizer keeps its parameters
        grads = []
        real = st.optimizer.step

        def keep(count, st=st, grads=grads, real=real):
            grads.extend(grads_of(st.model))
            real(count)

        st.optimizer.step = keep
        t0 = time.perf_counter()
        _, stats = build(cfg, st.model)(st, move(batch, dev_),
                                        move(draws, dev_))
        torch.cuda.synchronize()
        out[dev_] = (float(stats["loss"]), [g.cpu() for g in grads],
                     time.perf_counter() - t0)
    (l_k, g_k, t_k), (l_c, g_c, t_c) = out[str(dev)], out["cpu"]
    rel_l = abs(l_k - l_c) / abs(l_c)
    rel_g, _ = grads_err(g_k, g_c)
    rel_w, _ = grads_err([torch.cat([g.reshape(-1) for g in g_k])],
                         [torch.cat([g.reshape(-1) for g in g_c])])
    log(f"{label}: loss card {l_k:.7f} CPU {l_c:.7f} (rel {rel_l:.2e}, tol "
        f"{loss_rtol:g}); grads max rel L2 a tensor {rel_g:.2e} (tol "
        f"{grad_rel:g}), all together {rel_w:.2e}"
        + ("" if whole_rel is None else f" (tol {whole_rel:g})")
        + f"; {t_k:.2f} s card, {t_c:.2f} s CPU")
    gate(rel_l < loss_rtol and rel_g < grad_rel
         and (whole_rel is None or rel_w < whole_rel),
         f"{label}: the card's step disagrees with the CPU's")
    return l_c


def trainer_phases(dev, card, configs, fm, v2, op, fmip):
    """38. The whole trainer and its checkpoints: cli/train.py on the
    flagship (8x256, 64 + 128 samples, 4096 + 4x16x16 rays, bf16, the
    one-pass step) with the train-time LPIPS term (weights the smoke
    writes), prefetch, held-out renders every 6 steps, a profiler trace of
    2 steps and gc_every 4, then a resume; #1 / #2 / #3 counted; the
    one-pass step with the term against the eager step; the term card vs
    CPU; the prefetched stream against the batcher's, bit for bit; the
    step's time with and without the term and the loop's with and without
    prefetch; the noisy eager step and the mip eager step with normals
    against the CPU on the same draws; a checkpoint exported to a
    reference .tar, imported back and rendered through #1 bit for bit as
    the original; a mip checkpoint imported from a msgpack file the
    smoke writes, rendered through #6 against the plain render."""
    import contextlib
    import gc
    import io
    import json as json_

    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.cli import export_torch_ckpt
    from consistentnerf_tpu_torch.cli import import_mipnerf_ckpt
    from consistentnerf_tpu_torch.cli import import_torch_ckpt
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import (MipBatcher,
                                                        Prefetcher,
                                                        VanillaBatcher,
                                                        to_device)
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import loop, lpips
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    tag = f"[{card}]"
    counted = ((v2, "launches", v2.KERNEL),
               (v2, "bwd_launches", v2.BWD_KERNEL),
               (op, "launches", op.KERNEL),
               (fmip, "launches", fmip.KERNEL))
    launches = {}

    def zero():
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)

    def read():
        return {k: getattr(mod, attr) for mod, attr, k in counted}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    tmp = tempfile.mkdtemp(prefix="trainer_")
    npz = os.path.join(tmp, "lpips_vgg.npz")
    lpips.save_weights(npz, lpips.init_params(0))
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", f"checkpoint_every={TRAINER_STEPS}",
            f"lpips_weights_path={npz}",
            f"train_render_every={TRAINER_RENDER_EVERY}", "profile_steps=2",
            "gc_every=4", f"basedir={tmp}", "expname=trainer"] + [
        f"{k}={v}" for k, v in FLAGSHIP.items()]

    def args(items):
        return ["--device", str(dev)] + [x for s_ in items
                                         for x in ("--set", s_)]

    # 38a. The train CLI with every housekeeping field on, and a resume.
    t_phase = time.perf_counter()
    outs = {}
    for steps, run in ((TRAINER_STEPS, "train"),
                       (TRAINER_STEPS + 2, "resume")):
        zero()
        text = io.StringIO()
        t0 = sync()
        with contextlib.redirect_stdout(text):
            res = train_cli.main(args(sets) + ["--num-steps", str(steps)])
        wall = sync() - t0
        got = read()
        add(got)
        outs[run] = (res, text.getvalue(), got, wall)
        log(text.getvalue().rstrip())
        log(f"{tag} cli.train {run} (LPIPS, prefetch, renders every "
            f"{TRAINER_RENDER_EVERY}, profile_steps 2, gc_every 4): "
            f"{wall:.2f} s, launches {got}, gc enabled after: "
            f"{gc.isenabled()}")
    exp = os.path.join(tmp, "trainer")
    rcfg = configs.load_config(os.path.join(exp, "config.json"))
    chunks = -(-SCENE["H"] * SCENE["W"] // rcfg.render_chunk_size)
    per_render = 2 * chunks if rcfg.use_fused_render else 0
    n_renders = TRAINER_STEPS // TRAINER_RENDER_EVERY
    want = {"train": {v2.KERNEL: 2 * TRAINER_STEPS + n_renders * per_render,
                      v2.BWD_KERNEL: 2 * TRAINER_STEPS,
                      op.KERNEL: 2 * TRAINER_STEPS, fmip.KERNEL: 0},
            "resume": {v2.KERNEL: 4, v2.BWD_KERNEL: 4, op.KERNEL: 4,
                       fmip.KERNEL: 0}}
    for run, (res, text, got, _) in outs.items():
        gate(got == want[run], f"trainer cli.train {run}: launched {got}, "
             f"expected {want[run]}")
        hist = res.stats_history
        gate(all(np.isfinite(float(h["loss"])) and float(h["patch_lpips"])
                 > 0 for h in hist) and len(hist) == (
            TRAINER_STEPS if run == "train" else 2),
             f"trainer cli.train {run}: a non-finite loss or no LPIPS term")
    res, text, _, _ = outs["train"]
    renders = sorted(os.listdir(os.path.join(exp, "train_renders")))
    traces = sorted(f for f in os.listdir(os.path.join(exp, "profile"))
                    if f.endswith(".json"))
    names_3 = False
    if traces:
        with open(os.path.join(exp, "profile", traces[0])) as f:
            events = json_.load(f).get("traceEvents", [])
        names_3 = any(op.KERNEL in str(e.get("name", "")) for e in events)
    tb = os.path.isdir(os.path.join(exp, "runs")) or (
        "use_tensorboard: no SummaryWriter" in text)
    checks = {
        "held-out renders at 6 and 12 logged": all(
            f"test render @ {s}:" in text for s in (6, 12)),
        "train_renders/ holds color_000.png and both steps' metrics": {
            "color_000.png", "metric_psnr_6.txt",
            "metric_psnr_12.txt"} <= set(renders),
        "a Chrome trace of steps 1-2 names #3": names_3,
        "TensorBoard written, or its absence said": tb,
        "gc enabled after the loop": gc.isenabled(),
        "the resume started at step 12": "resumed from step 12" in outs[
            "resume"][1],
    }
    log(f"trainer housekeeping: traces {traces}, train_renders {renders}; "
        + ", ".join(f"{k}: {v}" for k, v in checks.items()))
    for k, v in checks.items():
        gate(bool(v), f"trainer: {k} fails")

    # 38b. The prefetched stream against the batcher's, bit for bit.
    cfg = configs.Config(**FLAGSHIP)
    scene = synthetic.make_scene(**SCENE).to_scene_data()
    pre = Prefetcher(VanillaBatcher(scene, cfg))
    try:
        fetched = [next(pre) for _ in range(4)]
    finally:
        pre.close()
    direct = VanillaBatcher(scene, cfg)
    same = all(np.array_equal(b[k], w[k]) for b in fetched
               for w in [direct.next_batch()] for k in w) and not \
        pre.thread.is_alive()
    log(f"prefetched stream (4 flagship batches) equals the batcher's bit "
        f"for bit: {same}")
    gate(same, "the prefetched stream is not the batcher's")

    # 38c. The one-pass step with the term against the eager step, and
    # the term on the card against the CPU.
    g_cfg = cfg.replace(N_rand=GUARD_N_RAND, lpips_weights_path=npz)
    lp = loop.train_lpips_params(g_cfg, dev)
    g_state = loop.init_state(g_cfg, dev)
    g_batch = to_device(VanillaBatcher(scene, g_cfg).next_batch(), dev)
    g_draws = step_lib.make_draws(g_cfg, g_batch["rgb"].shape[0],
                                  step_lib.step_generator(g_cfg.seed, 0,
                                                          dev), dev)
    (_, st_k), (_, st_e) = guard_steps(
        f"step guard with the LPIPS term (N_rand {GUARD_N_RAND}, bf16)",
        op.build_onepass_vanilla_train_step(g_cfg, lpips_params=lp),
        step_lib.build_vanilla_train_step(g_state.model, g_cfg,
                                          lpips_params=lp),
        g_state, g_batch, g_draws)
    d_lp = abs(float(st_k["patch_lpips"]) - float(st_e["patch_lpips"]))
    log(f"  patch_lpips kernel {float(st_k['patch_lpips']):.6e} eager "
        f"{float(st_e['patch_lpips']):.6e} (|diff| {d_lp:.2e})")
    gate(float(st_e["patch_lpips"]) > 0 and d_lp < STEP_LOSS_TOL * float(
        st_e["patch_lpips"]), "the one-pass step's patch_lpips disagrees")
    p = g_cfg.n_patches * g_cfg.patch_size ** 2
    gt = g_batch["rgb"][:p].reshape(-1, 16, 16, 3).float()
    gen = torch.Generator(device=dev).manual_seed(11)
    pred0 = (gt + 0.1 * torch.randn(gt.shape, generator=gen, device=dev)
             ).clamp(0, 1)
    terms = {}
    for dev_ in (str(dev), "cpu"):
        x = pred0.detach().to(dev_).requires_grad_()
        params = lpips.params_to(lp, dev_)
        val = torch.mean(lpips.lpips(params, x * 2 - 1,
                                     gt.to(dev_) * 2 - 1))
        val.backward()
        terms[dev_] = (val.item(), x.grad.cpu())
    card_t = terms[str(dev)]
    rel = abs(card_t[0] - terms["cpu"][0]) / terms["cpu"][0]
    g_rel = (torch.linalg.norm(card_t[1] - terms["cpu"][1])
             / torch.linalg.norm(terms["cpu"][1])).item()
    log(f"LPIPS term on 4 patches of 16x16, card (strict fp32) vs CPU: "
        f"{card_t[0]:.7e} vs {terms['cpu'][0]:.7e} (rel {rel:.2e}, "
        f"tol {LPIPS_CPU_RTOL:g}); d/dpatch rel L2 {g_rel:.2e} (tol "
        f"{LPIPS_GRAD_REL:g})")
    gate(rel < LPIPS_CPU_RTOL and g_rel < LPIPS_GRAD_REL,
         "the LPIPS term on the card disagrees with the CPU's")
    del g_state, st_k, st_e
    torch.cuda.empty_cache()

    # 38d. Times: the flagship one-pass step with and without the term
    # (pre-made batches), and the train loop with and without prefetch.
    batcher = VanillaBatcher(scene, cfg)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
    n = batches[0]["rgb"].shape[0]
    lp_cfg = cfg.replace(lpips_weights_path=npz)
    step_ms = {}
    for label, c, params in (("without the LPIPS term", cfg, None),
                             ("with the LPIPS term", lp_cfg, lp)):
        st = loop.init_state(c, dev)
        step_ms[label] = bench_steps(
            f"one-pass step (flagship, {n} rays) {label}", tag,
            loop.select_train_step(c, st.model, lpips_params=params), st,
            batches, n)
    added = (step_ms["with the LPIPS term"]
             - step_ms["without the LPIPS term"])
    log(f"{tag} the LPIPS term adds {added:.2f} ms to the flagship "
        "one-pass step")
    loop_ms = {}
    for turn, pre_on in enumerate((True, False, True, False)):
        c = cfg.replace(basedir=tmp, expname=f"loop_{turn}",
                        i_print=1000, checkpoint_every=10 ** 6,
                        use_tensorboard=False, gc_every=0)
        loop.train(c, scene, num_steps=2, device=dev, use_prefetch=pre_on,
                   log_fn=lambda m: None)  # warm-up and checkpoint
        t0 = sync()
        loop.train(c, scene, num_steps=2 + PREFETCH_STEPS, device=dev,
                   use_prefetch=pre_on, log_fn=lambda m: None)
        dt = sync() - t0
        loop_ms.setdefault(pre_on, []).append(1e3 * dt / PREFETCH_STEPS)
    log(f"{tag} train() on the flagship, {PREFETCH_STEPS} steps after a "
        f"resume (set-up included: batcher, state, restore), ms/step in "
        f"turns on, off, on, off: prefetch on {loop_ms[True]}, off "
        f"{loop_ms[False]}")
    torch.cuda.empty_cache()

    # 38e. The noisy eager step and the mip eager step with normals, card
    # against CPU on the same draws (fp32, a cut batch).
    def move(x, dev_):
        if isinstance(x, dict):
            return {k: move(v, dev_) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v, dev_) for v in x]
        if hasattr(x, "map"):
            return x.map(lambda t: t.to(dev_))
        return x.to(dev_) if torch.is_tensor(x) else x

    n_cfg = cfg.replace(N_rand=64, n_patches=1, compute_dtype="float32",
                        raw_noise_std=1.0, use_fused_train=False)
    n_state = loop.init_state(n_cfg, "cpu")
    n_batch = to_device(VanillaBatcher(scene, n_cfg).next_batch(), "cpu")
    n_draws = step_lib.make_draws(n_cfg, n_batch["rgb"].shape[0],
                                  torch.Generator().manual_seed(2), "cpu")
    gate({"noise_c", "noise_f"} <= set(n_draws), "make_draws drew no "
         "density noise at raw_noise_std 1, perturb 1")
    with_noise = cpu_step_gate(
        f"noisy eager step (raw_noise_std 1, perturb 1, fp32, "
        f"{n_batch['rgb'].shape[0]} rays)", n_cfg,
        lambda c, m: step_lib.build_vanilla_train_step(m, c), n_state,
        n_batch, n_draws, move, dev)
    quiet = {k: v for k, v in n_draws.items() if not k.startswith("noise")}
    st = loop.init_state(n_cfg, "cpu")
    st.model.load_state_dict(n_state.model.state_dict())
    _, q_stats = step_lib.build_vanilla_train_step(st.model, n_cfg)(
        st, n_batch, quiet)
    gate(float(q_stats["loss"]) != with_noise,
         "the density noise did not move the eager step's loss")
    m_cfg = configs.Config(**{**MIP, "compute_dtype": "float32",
                              "disable_normals": False,
                              "compute_normal_metrics": True,
                              "compute_mono_depth_metrics": False,
                              "use_fused_train": False})
    m_state = loop.init_state(m_cfg, "cpu")
    mb = MipBatcher(scene, m_cfg).next_batch()
    cut = 256

    def head(v):
        if hasattr(v, "map"):
            return v.map(lambda a: a[:cut])
        return v[:cut] if np.ndim(v) and len(v) > cut else v

    m_batch = to_device({k: head(v) for k, v in mb.items()}, "cpu")
    m_draws = step_lib.make_mip_step_draws(
        m_cfg, m_batch, torch.Generator().manual_seed(4), "cpu")
    cpu_step_gate(f"mip eager step with normals (disable_normals false, "
                  f"compute_normal_metrics, fp32, {cut} rays)", m_cfg,
                  lambda c, m: step_lib.build_mip_train_step(m, c),
                  m_state, m_batch, m_draws, move, dev)
    del n_state, m_state

    # 38f. Checkpoint round trip: export -> import -> render through #1.
    tar = os.path.join(tmp, "trainer.tar")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        step = export_torch_ckpt.main([tar] + args(sets))
        import_torch_ckpt.main([tar] + args(
            [s_ for s_ in sets if not s_.startswith("expname=")]
            + ["expname=round_trip"]))
    log(text.getvalue().rstrip())
    rt_cfg = rcfg.replace(expname="round_trip")
    models = {}
    for name, c in (("trainer", rcfg), ("round_trip", rt_cfg)):
        m = make_model(c, dev)
        models[name] = (m, CheckpointManager(os.path.join(
            tmp, name, "checkpoints")).restore_for_eval(m))
    rays = camera_rays_for_view(scene, scene.poses[scene.i_test[0]],
                                device=dev)
    outs_r = {}
    for name in ("round_trip", "trainer"):
        render = render_lib.build_render_fn(models[name][0].eval(), rcfg)
        zero()
        outs_r[name] = render(rays)
        torch.cuda.synchronize()
        got = read()
        if name == "round_trip":
            add(got)
            rt_launches = got
    same = all(torch.equal(outs_r["round_trip"][k], outs_r["trainer"][k])
               for k in ("rgb", "depth", "acc"))
    want_rt = {v2.KERNEL: per_render, v2.BWD_KERNEL: 0, op.KERNEL: 0,
               fmip.KERNEL: 0}
    log(f"checkpoint round trip (step {step} -> {os.path.basename(tar)} -> "
        f"step {models['round_trip'][1]}): render of test view "
        f"{scene.i_test[0]} launched {rt_launches} (expected {want_rt}); "
        f"bit-equal to the original's render: {same}")
    gate(step == TRAINER_STEPS + 2 and models["round_trip"][1] == step
         and rt_launches == want_rt and same,
         "the exported and imported checkpoint does not render as the "
         "original")

    # 38g. A pretrained mip-NeRF msgpack file -> a mip checkpoint -> #6.
    mip_sets = [f"{k}={v}" for k, v in MIP.items()] + [
        "dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
        f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
        "use_fused_render=true", f"basedir={tmp}", "expname=mip_import",
        f"render_chunk_size={CHUNK}"]
    mi_cfg = configs.parse_overrides(configs.Config(), mip_sets)
    src = make_model(mi_cfg, "cpu")
    tree = interop.mip_params_to_jax(src.state_dict())["params"]["MipMLP_0"]
    d = mi_cfg.netdepth
    mlp = {f"Dense_{i}": tree[f"Dense_{i}"] for i in range(d + 1)}
    for i in (9, 17):  # the dropped density duplicates
        mlp[f"Dense_{i}"] = {"kernel": np.ones((2, 2), np.float32),
                             "bias": np.zeros(2, np.float32)}
    for s_, d_ in ((18, d + 1), (19, d + 2), (20, d + 3)):
        mlp[f"Dense_{s_}"] = tree[f"Dense_{d_}"]
    ckpt_file = os.path.join(tmp, "pretrained", "checkpoint_1000")
    os.makedirs(os.path.dirname(ckpt_file))
    with open(ckpt_file, "wb") as f:
        f.write(_mp({"optimizer": {"target": {"params": {"MLP_0": mlp}},
                                   "state": {"step": np.int32(1000)}}}))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        import_mipnerf_ckpt.main([ckpt_file, os.path.join(
            tmp, "mip_import")] + args(mip_sets))
    log(text.getvalue().rstrip())
    model = make_model(mi_cfg, dev)
    mstep = CheckpointManager(os.path.join(
        tmp, "mip_import", "checkpoints")).restore_for_eval(model)
    equal_w = all(torch.equal(a.cpu(), b) for a, b in zip(
        model.state_dict().values(), src.state_dict().values()))
    mrays = camera_rays_for_view(scene, scene.poses[scene.i_test[0]],
                                 device=dev)
    zero()
    fused = render_lib.build_render_fn(model.eval(), mi_cfg)(mrays)
    torch.cuda.synchronize()
    got = read()
    add(got)
    plain = render_lib.build_render_fn(
        model, mi_cfg.replace(use_fused_render=False))(mrays)
    torch.cuda.synchronize()
    want_m = {v2.KERNEL: 0, v2.BWD_KERNEL: 0, op.KERNEL: 0,
              fmip.KERNEL: mi_cfg.mip_num_levels * (-(-SCENE["H"]
                                                      * SCENE["W"] // CHUNK))}
    diff = (fused["rgb"] - plain["rgb"]).abs().mean().item()
    finite = all(torch.isfinite(fused[k]).all() for k in ("rgb", "depth"))
    log(f"mip import (step {mstep}, 8x256, the pretrained 21-layer "
        f"layout): weights equal the source's: {equal_w}; render of test "
        f"view {scene.i_test[0]} through {fmip.KERNEL}: launches {got} "
        f"(expected {want_m}); mean|rgb - plain render's| {diff:.3e} (tol "
        f"{RENDER_RGB_TOL:g}), finite {finite}")
    gate(mstep == 1000 and equal_w and got == want_m and finite
         and diff < RENDER_RGB_TOL, "the imported mip checkpoint")
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Data parallelism over torch.distributed (parallel/), and the method
# canaries
# ---------------------------------------------------------------------------

# The cases of the distributed phase: the flagship one-pass step (hard
# masks split unevenly: rank 0's rows hold few mask-true rays), the same
# with ss_loss, the mip one-pass step, each DIST_STEPS steps, and one
# sharded render of a DIST_VIEW x DIST_VIEW view.
DIST_CASES = {"vanilla": FLAGSHIP, "vanilla_ss": dict(FLAGSHIP, ss_loss=True),
              "mip": MIP}
DIST_STEPS = 3
DIST_VIEW = 128
DIST_LOSS_TOL = 1e-5  # step-1 loss of R ranks vs one process, relative
DIST_GRAD_TOL = 1e-3  # step-1 grads, relative L2 (bf16 dW partials' order)
DIST_RENDER_TOL = 1e-5


def dist_counted(v2, op, fmip):
    """(module, counter, kernel) of the kernels on the distributed path."""
    return ((v2, "launches", v2.KERNEL), (v2, "bwd_launches", v2.BWD_KERNEL),
            (op, "launches", op.KERNEL), (op, "mip_launches", op.MIP_KERNEL),
            (fmip, "launches", fmip.KERNEL),
            (fmip, "bwd_launches", fmip.BWD_KERNEL))


def dist_expected(name, cfg, n, data_size, data_rank, v2, op, fmip):
    """The launches a rank's DIST_STEPS steps make: the patch rays at the
    head of the batch take #1 / #2 (#6 / #7 for mip) on the ranks that
    hold some, the other rays #3 (#5); ss_loss's reference rays #3."""
    per = n // data_size
    a = data_rank * per
    p = (cfg.n_patches * cfg.patch_size ** 2 if cfg.backbone == "vanilla"
         else 4 * 16 * 16)
    pl = min(max(p - a, 0), per)
    lv = 2 if cfg.backbone == "vanilla" else cfg.mip_num_levels
    fwd, bwd, lvl = ((v2.KERNEL, v2.BWD_KERNEL, op.KERNEL)
                     if cfg.backbone == "vanilla"
                     else (fmip.KERNEL, fmip.BWD_KERNEL, op.MIP_KERNEL))
    want = {k: 0 for _, _, k in dist_counted(v2, op, fmip)}
    want[fwd] += lv * (pl > 0)
    want[bwd] += lv * (pl > 0)
    want[lvl] += lv * (per - pl > 0) + lv * bool(cfg.ss_loss)
    return {k: DIST_STEPS * v for k, v in want.items()}


def dist_batches(cfg, scene):
    """DIST_STEPS global batches of the case; the vanilla ones with their
    first 2560 rays' masks cut to one row in eight (uneven over ranks)."""
    from consistentnerf_tpu_torch.data.pipeline import (MipBatcher,
                                                        VanillaBatcher)

    batcher = (VanillaBatcher(scene, cfg) if cfg.backbone == "vanilla"
               else MipBatcher(scene, cfg))
    out = []
    for _ in range(DIST_STEPS):
        b = batcher.next_batch()
        if "mask" in b:
            cut = np.arange(b["mask"].shape[0]) < 2560
            b["mask"] = np.where(cut & (np.arange(cut.size) % 8 != 0), 0.0,
                                 b["mask"]).astype(np.float32)
        out.append(b)
    return out


def dist_cases(dev, mesh, cases, scene_kw):
    """Each case's DIST_STEPS steps on `mesh` (None: one process, the
    whole batch) from the seeded init, and the render: losses, step-1
    grads, final params, step times, launches."""
    import torch

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import to_device
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op
    from consistentnerf_tpu_torch.parallel import distributed_render
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train.render import build_render_fn

    counted = dist_counted(v2, op, fmip)
    scene = synthetic.make_scene(**scene_kw).to_scene_data()
    out = {}
    for name, kw in cases.items():
        cfg = configs.Config(**kw)
        batches = dist_batches(cfg, scene)
        state = loop.init_state(cfg, dev)
        opt, grads = state.optimizer, []
        update = opt.step

        def record(count, opt=opt, grads=grads, update=update):
            if not grads:
                grads.append(torch.cat([
                    (torch.zeros_like(q) if q.grad is None else q.grad)
                    .reshape(-1).float() for q in opt.params]).cpu())
            update(count)

        opt.step = record
        step = loop.select_train_step(cfg, state.model, mesh=mesh)
        for m, a, _ in counted:
            setattr(m, a, 0)
        losses, times = [], []
        for b in batches:
            b = to_device(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = step(state, b)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(stats["loss"]))
        out[name] = dict(
            loss=losses, grads=grads[0], ms=times, n=batches[0][
                "rgb"].shape[0],
            counts={k: getattr(m, a) for m, a, k in counted},
            params=torch.cat([t.detach().reshape(-1).float().cpu()
                              for t in state.model.state_dict().values()]))
        del state, step, batches
        torch.cuda.empty_cache()
    # One view through the fused render (#1), sharded or whole.
    cfg = configs.Config(**dict(FLAGSHIP, use_fused_render=True))
    model = loop.init_state(cfg, dev).model
    rays = evaluation.camera_rays_for_view(scene, scene.poses[0], device=dev)
    for m, a, _ in counted:
        setattr(m, a, 0)
    if mesh is None:
        got = {k: v.cpu() for k, v in build_render_fn(model, cfg)(
            rays).items() if k in ("rgb", "depth", "acc")}
    else:
        got = {k: torch.from_numpy(v) for k, v in
               distributed_render.render_image_sharded(
                   model, cfg, rays, mesh).items()}
    out["render"] = dict(out=got, counts={k: getattr(m, a)
                                          for m, a, k in counted})
    return out


def gloo_allreduce_ms(dev, mesh, numel, iters=10):
    """The time of one all-reduce of `numel` floats over the mesh."""
    import torch

    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    x = torch.ones(numel, device=dev)
    mesh_lib.all_reduce_sum(x, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        mesh_lib.all_reduce_sum(x, mesh)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def rank_worker(argv):
    """One rank of the distributed phase (`--rank R --world W --coord
    HOST:PORT --backend B --device D --out DIR`): joins the group, runs
    the cases of DIR/cases.json and writes DIR/rank{R}.pt."""
    import torch

    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    args = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(args["--rank"]), int(args["--world"])
    mesh_lib.maybe_initialize_distributed(args["--coord"], world, rank,
                                          backend=args["--backend"])
    dev = mesh_lib.rank_device(args["--device"])
    torch.cuda.set_device(dev)
    fm.strict_fp32(dev)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    mesh = mesh_lib.create_mesh(device=dev)
    with open(os.path.join(args["--out"], "cases.json")) as f:
        spec = json.load(f)
    res = dist_cases(dev, mesh, spec["cases"], spec["scene"])
    # The all-reduce of one step's gradients (the flagship's two MLPs).
    numel = res["vanilla"]["grads"].numel() if "vanilla" in res else 1 << 20
    res["allreduce"] = dict(numel=numel, ms=gloo_allreduce_ms(dev, mesh,
                                                              numel))
    res["device"] = str(dev)
    torch.save(res, os.path.join(args["--out"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(tmp, world, backend, device, timeout=900):
    """Start `world` rank processes of this script, wait for them (all are
    killed on a failure or the timeout), and return their results."""
    import torch

    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(world), "--coord", coord, "--backend", backend,
         "--device", device, "--out", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                fail(f"rank {r} ({backend}) exited {p.returncode}:\n"
                     f"{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def dist_gates(label, ranks, ref, cases, v2, op, fmip):
    """Every case of the ranks against one process on the whole batch:
    ranks bit-identical, step-1 loss and grads, each rank's launches;
    and the sharded render against the whole render."""
    import torch

    from consistentnerf_tpu_torch import configs

    world = len(ranks)
    for name in cases:
        cfg = configs.Config(**cases[name])
        want = ref[name]
        same = all(torch.equal(r[name]["params"], ranks[0][name]["params"])
                   for r in ranks)
        d_loss = abs(ranks[0][name]["loss"][0] - want["loss"][0]) / abs(
            want["loss"][0])
        g, w = ranks[0][name]["grads"], want["grads"]
        g_rel = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
        p_rel = float(torch.linalg.norm(ranks[0][name]["params"]
                                        - want["params"])
                      / torch.linalg.norm(want["params"]))
        log(f"{label} {name} ({want['n']} rays, {world} ranks): params "
            f"bit-identical across ranks {same}; step-1 loss "
            f"{ranks[0][name]['loss'][0]:.7f} vs one process "
            f"{want['loss'][0]:.7f} (rel {d_loss:.2e}, tol "
            f"{DIST_LOSS_TOL:g}); step-1 grads rel L2 {g_rel:.2e} (tol "
            f"{DIST_GRAD_TOL:g}); params after {DIST_STEPS} steps rel L2 "
            f"{p_rel:.2e}")
        gate(same, f"{label} {name}: the ranks' parameters differ")
        gate(d_loss < DIST_LOSS_TOL, f"{label} {name}: step-1 loss {d_loss}")
        gate(g_rel < DIST_GRAD_TOL, f"{label} {name}: step-1 grads {g_rel}")
        for r, res in enumerate(ranks):
            exp = dist_expected(name, cfg, want["n"], world, r, v2, op,
                                fmip)
            got = res[name]["counts"]
            log(f"  rank {r}: launches {got} (expected {exp}); step ms "
                f"{[round(t, 3) for t in res[name]['ms']]}")
            gate(got == exp, f"{label} {name} rank {r} launches {got}")
        log(f"  one process: launches {want['counts']}; step ms "
            f"{[round(t, 3) for t in want['ms']]}")
    err = max(float((r["render"]["out"][k] - ref["render"]["out"][k])
                    .abs().max()) for r in ranks for k in ("rgb", "depth"))
    shape_ok = all(r["render"]["out"]["rgb"].shape
                   == ref["render"]["out"]["rgb"].shape for r in ranks)
    counts = [r["render"]["counts"][v2.KERNEL] for r in ranks]
    log(f"{label} sharded render {DIST_VIEW}x{DIST_VIEW}: max|sharded - "
        f"whole| {err:.2e} (tol {DIST_RENDER_TOL:g}); {v2.KERNEL} launches "
        f"a rank {counts}, one process "
        f"{ref['render']['counts'][v2.KERNEL]}")
    gate(shape_ok and err < DIST_RENDER_TOL, f"{label} sharded render {err}")
    gate(all(c > 0 for c in counts), f"{label} sharded render: no #1")


def distributed_phases(dev, card, cases=None, scene_kw=None, tmp=None):
    """The distributed phase: one process on the whole batches (the
    reference), two gloo ranks on this card, a 1-rank NCCL group in this
    process (bits of the unsharded step), and two NCCL ranks on two cards
    where there are two. Returns {kernel: launches}."""
    import torch
    import torch.distributed as dist

    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op
    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    cases = DIST_CASES if cases is None else cases
    scene_kw = dict(SCENE) if scene_kw is None else scene_kw
    tmp = tmp or tempfile.mkdtemp()
    launches = {}
    # Bits across runs need cuDNN's deterministic algorithms (the SSIM
    # patch term's convolutions); the ranks set them too.
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    ref = dist_cases(dev, None, cases, scene_kw)
    for name in list(cases) + ["render"]:
        add(ref[name]["counts"])
    torch.cuda.empty_cache()
    log(f"distributed: one process on the whole batches "
        f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump({"cases": cases, "scene": scene_kw}, f)
    t0 = time.perf_counter()
    ranks = run_ranks(tmp, 2, "gloo", "cuda:0")
    log(f"distributed: 2 gloo ranks on one card {time.perf_counter() - t0:.1f}"
        f" s [{card}]")
    dist_gates("2 gloo ranks on one card", ranks, ref, cases, v2, op, fmip)
    for r in ranks:
        for name in list(cases) + ["render"]:
            add(r[name]["counts"])
    for name in cases:
        one = np.mean(ref[name]["ms"][1:])
        per = [np.mean(r[name]["ms"][1:]) for r in ranks]
        log(f"  {name}: step ms one process {one:.3f}, a rank of 2 on one "
            f"card {[round(x, 3) for x in per]} [{card}]")
    ar = ranks[0]["allreduce"]
    log(f"  gloo all-reduce of {ar['numel']} floats (one step's grads) "
        f"between 2 ranks on ONE card: {ar['ms']:.3f} ms (not a multi-card "
        f"number) [{card}]")

    # A 1-rank NCCL group: every collective is a copy, so the step through
    # the mesh gives the unsharded step's bits.
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_lib.create_mesh(device=dev)
        one = dist_cases(dev, mesh, cases, scene_kw)
    finally:
        dist.destroy_process_group()
    for name in cases:
        add(one[name]["counts"])
        same = (torch.equal(one[name]["params"], ref[name]["params"])
                and one[name]["loss"] == ref[name]["loss"]
                and torch.equal(one[name]["grads"], ref[name]["grads"]))
        log(f"1-rank NCCL group {name}: loss, grads and params after "
            f"{DIST_STEPS} steps bit-identical to the unsharded step: "
            f"{same}")
        gate(same, f"1-rank NCCL group {name} is not the unsharded step")
    same = all(torch.equal(one["render"]["out"][k], ref["render"]["out"][k])
               for k in ("rgb", "depth"))
    add(one["render"]["counts"])
    log(f"1-rank NCCL group render bit-identical: {same} "
        f"({time.perf_counter() - t0:.1f} s)")
    gate(same, "1-rank NCCL group render")

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        nccl = run_ranks(tmp, 2, "nccl", "cuda")
        dist_gates("2 NCCL ranks on two cards", nccl, ref, cases, v2, op,
                   fmip)
        for r in nccl:
            for name in list(cases) + ["render"]:
                add(r[name]["counts"])
        log(f"distributed: 2 NCCL ranks on two cards "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        log("distributed: one card here, so 2 NCCL ranks on two cards were "
            "not run")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    return launches


# The method canaries (tests/test_generalization_canary.py:24-37,87-100,
# tests/test_mip_canary.py:36-58) through the port's train() on the card
# with the CLI's dispatch on a card (`cli/common.py::auto_fused_defaults`),
# from the JAX package's init (tests/canary_inits.npz, written by
# tools/canary_inits.py) and, not gated, from the port's own.
CANARY_VANILLA = dict(
    dataset_type="synthetic", backbone="vanilla", netdepth=2, netwidth=64,
    netdepth_fine=2, netwidth_fine=64, multires=6, multires_views=2,
    N_samples=16, N_importance=16, N_rand=256, white_bkgd=True, lrate=5e-3,
    use_tensorboard=False, checkpoint_every=10**9)
CANARIES = {
    "interleaved": dict(steps=800, cfg=dict(
        CANARY_VANILLA, n_patches=1, patch_size=8, hardmask=True,
        with_depth_loss=True), scene=dict(n_views=8, H=64, W=64),
        split=dict(n_test=2, interleave_test=True)),
    "sparse_a": dict(steps=800, cfg=dict(
        CANARY_VANILLA, total_iters=800, hardmask=False,
        with_depth_loss=False, n_patches=0),
        scene=dict(n_views=8, H=48, W=48, layout="cluster"),
        split=dict(n_test=4, interleave_test=False)),
    "sparse_d": dict(steps=800, cfg=dict(
        CANARY_VANILLA, total_iters=800, hardmask=True,
        with_depth_loss=True, n_patches=1, patch_size=8),
        scene=dict(n_views=8, H=48, W=48, layout="cluster"),
        split=dict(n_test=4, interleave_test=False)),
    "mip": dict(steps=500, cfg=dict(
        backbone="mipnerf", dataset_type="blender", netdepth=2, netwidth=48,
        mip_num_samples=12, mip_num_levels=2, max_deg_point=6,
        disable_normals=True, N_rand=192, batch_size_random=256,
        random_patch_size=8, load_random_rays=True,
        depth_tvnorm_loss_mult=0.1, depth_tvnorm_decay=True,
        depth_tvnorm_maxstep=64, depth_tvnorm_loss_mult_start=400.0,
        depth_tvnorm_loss_mult_end=0.1, use_hardmask=True, white_bkgd=True,
        near=2.0, far=6.0, anneal_nearfar=True, anneal_nearfar_steps=64,
        anneal_nearfar_perc=0.0001, anneal_mid_perc=1.0, lr_init=2e-3,
        lr_final=2e-5, lr_delay_steps=32, lr_delay_mult=0.01,
        grad_max_norm=0.1, grad_max_val=0.1, density_noise=1.0,
        total_iters=500, use_tensorboard=False, checkpoint_every=10**9),
        scene=dict(n_views=8, H=48, W=48),
        split=dict(n_test=2, interleave_test=True)),
}
CANARY_INITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "canary_inits.npz")


def jax_init_state_dict(backbone):
    """The JAX package's init of a canary as the port's state_dict (the
    vanilla coarse MLP as the copy of the fine one)."""
    import torch

    z = np.load(CANARY_INITS)
    prefix = "vanilla." if backbone == "vanilla" else "mip."
    sd = {k[len(prefix):]: torch.tensor(z[k]) for k in z.files
          if k.startswith(prefix)}
    if backbone == "vanilla":
        sd.update({"coarse." + k[5:]: v for k, v in list(sd.items())
                   if k.startswith("fine.")})
    return sd


def run_canary(name, init, dev, basedir):
    """One canary: train from `init` ("jax" or "port") and score the
    held-out views. Returns its PSNRs, seconds and train step."""
    import types

    import torch

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.loaders import attach_masks
    from consistentnerf_tpu_torch.data.random_poses import \
        generate_random_poses
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view
    from consistentnerf_tpu_torch.train.render import build_render_fn

    spec = CANARIES[name]
    cfg = configs.Config(**spec["cfg"], basedir=basedir,
                         expname=f"{name}_{init}")
    cfg = common.auto_fused_defaults(cfg, types.SimpleNamespace(
        device=str(dev), overrides=[], config=None))
    scene = synthetic.make_scene(**spec["scene"]).to_scene_data(
        **spec["split"])
    random_poses = None
    if cfg.backbone == "mipnerf":
        random_poses = generate_random_poses(scene.poses[scene.i_train],
                                             n_poses=100)
    elif cfg.hardmask:
        scene = attach_masks(scene, cfg, None, device=dev)
    if init == "jax":
        state = loop.init_state(cfg, dev)
        state.model.load_state_dict(jax_init_state_dict(cfg.backbone))
        CheckpointManager(os.path.join(basedir, cfg.expname,
                                       "checkpoints")).save(0, state)
    counted = dist_counted(v2, op, fmip)
    for m, a, _ in counted:
        setattr(m, a, 0)
    t0 = time.perf_counter()
    res = loop.train(cfg, scene, num_steps=spec["steps"], device=dev,
                     random_poses=random_poses, use_prefetch=False,
                     log_fn=lambda s: None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k: getattr(m, a) for m, a, k in counted}
    model = res.state.model.eval()
    render = build_render_fn(model, cfg)
    psnrs = []
    for vid in scene.i_test:
        rays = camera_rays_for_view(scene, scene.poses[vid], device=dev)
        pred = np.clip(render(rays)["rgb"].reshape(scene.H, scene.W, 3)
                       .cpu().numpy(), 0, 1)
        psnrs.append(float(-10 * np.log10(np.mean(
            (pred - scene.images[vid]) ** 2))))
    step = loop.select_train_step(cfg, model)
    return dict(psnrs=psnrs, seconds=seconds, counts=counts,
                step=f"{step.__module__}.{step.__qualname__}",
                dtype=cfg.compute_dtype)


def canary_worker(argv):
    """One canary (`--canary NAME --init jax|port --out FILE`)."""
    import torch

    from consistentnerf_tpu_torch.ops import fused_mlp as fm

    args = dict(zip(argv[::2], argv[1::2]))
    # Eight canaries share the host's cores: one intra-op thread each.
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    basedir = tempfile.mkdtemp()
    try:
        res = run_canary(args["--canary"], args["--init"], dev, basedir)
    finally:
        shutil.rmtree(basedir, ignore_errors=True)
    with open(args["--out"], "w") as f:
        json.dump(res, f)


def canary_bounds(psnr):
    """The JAX tests' own bounds on the held-out PSNRs of the JAX init:
    (gate, text) a canary."""
    i, a, d, m = (psnr["interleaved"], psnr["sparse_a"], psnr["sparse_d"],
                  psnr["mip"])
    ma, md = float(np.mean(a)), float(np.mean(d))
    return {
        "interleaved": (min(i) > 11.0 and np.mean(i) > 12.5,
                        "min > 11.0, mean > 12.5"),
        "sparse": (ma < 9.5 and md > ma + 1.5 and min(d) > 9.0,
                   "vanilla mean < 9.5, depth arm > vanilla + 1.5, "
                   "min > 9.0"),
        "mip": (min(m) > 11.0 and np.mean(m) > 11.5,
                "min > 11.0, mean > 11.5"),
    }


def canary_phases(card, names=None, inits=("jax", "port"), timeout=900):
    """The canaries, one process each, all at once (each is a small model
    whose steps the host paces). Gates the JAX init's against the JAX
    tests' bounds; prints the port init's. Returns {kernel: launches}."""
    names = list(CANARIES) if names is None else names
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    jobs = {(n, i): subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--canary", n,
         "--init", i, "--out", os.path.join(tmp, f"{n}_{i}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for n in names for i in inits}
    results, launches = {}, {}
    try:
        for key, p in jobs.items():
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                fail(f"canary {key} exited {p.returncode}:\n{out[-4000:]}")
            with open(os.path.join(tmp, f"{key[0]}_{key[1]}.json")) as f:
                results[key] = json.load(f)
    finally:
        for p in jobs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    for (n, i), r in results.items():
        for k, v in r["counts"].items():
            launches[k] = launches.get(k, 0) + v
        log(f"canary {n} from the {i} init: held-out PSNR "
            f"{[round(x, 3) for x in r['psnrs']]} (mean "
            f"{np.mean(r['psnrs']):.3f}), {CANARIES[n]['steps']} steps in "
            f"{r['seconds']:.1f} s on {r['step']} ({r['dtype']}); launches "
            f"{r['counts']} [{card}]")
    log(f"canary phase: {len(jobs)} runs in parallel, "
        f"{time.perf_counter() - t0:.1f} s")
    for i in inits:
        if not all((n, i) in results for n in CANARIES):
            continue
        for label, (ok, text) in canary_bounds(
                {n: results[(n, i)]["psnrs"] for n in CANARIES}).items():
            log(f"  {label} canary from the {i} init within the JAX test's "
                f"bounds ({text}): {ok}" + ("" if i == "jax" else
                                             " (not gated)"))
            if i == "jax":
                gate(ok, f"canary {label} from the JAX init: {text}")
    return launches


# ---------------------------------------------------------------------------
# The image codecs and the mip backbone without view directions.
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join("tests", "jpeg_fixtures")
CODEC_LLFF_VIEWS = 20  # the fern registry's splits reach view 19
CODEC_LLFF_HWF = (378.0, 504.0, 3260.5 / 8)  # the fixtures' size, fern's f
VIDEO_FPS = 30
# The viewdir-free mip step on the card against the CPU, fp32 (strict):
# the step-1 loss (relative) and the grads (relative L2 of all of them
# together, and of each tensor). The grads' bounds are 3x the step's own
# fp32 floor, which the phase measures and prints: on the CPU alone, a
# one-ulp nudge of the ray origins moves the grads by ~1.1e-4 together
# and ~1e-3 in the first layer's weights (the trunk's backward at 96 x 2
# samples a ray), with view directions or without; the loss by ~1e-7.
NOVIEW_LOSS_RTOL = 1e-5
NOVIEW_GRAD_REL = 3e-4
NOVIEW_TENSOR_REL = 3e-3
NOVIEW_CPU_RAYS = 256


def mp4_box_check(path, n_frames, width, height, fps):
    """A small ISO BMFF reader: the video's sample count, tkhd size,
    mdhd timescale and duration, and each sample a sync sample that
    starts with a VOP start code. Returns a one-line summary."""
    import struct

    data = open(path, "rb").read()

    def boxes(start, end):
        out, pos = {}, start
        while pos + 8 <= end:
            size, kind = struct.unpack(">I4s", data[pos:pos + 8])
            if size < 8 or pos + size > end:
                fail(f"{path}: a bad box {kind!r} at {pos}")
            out[kind.decode("latin-1")] = (pos + 8, pos + size)
            pos += size
        return out

    top = boxes(0, len(data))
    need = {"ftyp", "mdat", "moov"}
    gate(need <= set(top), f"{path}: top-level boxes {sorted(top)}")
    trak = boxes(*boxes(*top["moov"])["trak"])
    mdia = boxes(*trak["mdia"])
    stbl = boxes(*boxes(*mdia["minf"])["stbl"])
    tk_end = trak["tkhd"][1]
    tk_w, tk_h = (v >> 16 for v in struct.unpack(">II", data[tk_end - 8:
                                                             tk_end]))
    md = mdia["mdhd"][0]
    timescale, duration = struct.unpack(">II", data[md + 12:md + 20])
    s = stbl["stsz"][0]
    count = struct.unpack(">I", data[s + 8:s + 12])[0]
    sizes = struct.unpack(f">{count}I", data[s + 12:s + 12 + 4 * count])
    ss = stbl["stss"][0]
    n_sync = struct.unpack(">I", data[ss + 4:ss + 8])[0]
    sync = set(struct.unpack(f">{n_sync}I", data[ss + 8:ss + 8 + 4 * n_sync]))
    co = stbl["stco"][0]
    offset = struct.unpack(">I", data[co + 8:co + 12])[0]
    st = stbl["stts"][0]
    stts = struct.unpack(">III", data[st + 4:st + 16])
    vops = []
    pos = offset
    for size in sizes:
        vops.append(data[pos:pos + 4] == b"\x00\x00\x01\xb6"
                    and data[pos + 4] >> 6 == 0)
        pos += size
    esds = data.find(b"esds", *top["moov"])
    # objectTypeIndication 0x20 (MPEG-4 Visual), streamType 4 (visual).
    mpeg4 = esds > 0 and b"\x20\x11" in data[esds:esds + 64]
    text = (f"{count} samples, tkhd {tk_w}x{tk_h}, mdhd timescale "
            f"{timescale} duration {duration} (stts {stts[1:]}), sync "
            f"samples {len(sync)}, every sample an I-VOP at a VOP start code "
            f"{all(vops)}, esds object type 0x20 {mpeg4}")
    gate(mpeg4 and count == n_frames and (tk_w, tk_h) == (width, height)
         and timescale == fps and duration == n_frames
         and stts == (1, n_frames, 1) and sync == set(range(1, count + 1))
         and all(vops) and pos == top["mdat"][1],
         f"{path}: the MP4 boxes disagree with {n_frames} frames of "
         f"{width}x{height} at {fps} fps: {text}")
    return text


def write_codec_llff(root):
    """An LLFF scene `fern` in its own layout under `root` whose images/
    are the committed fixture JPEGs (view i the fixture llff_view_{i % 4}),
    with seeded poses (poses_bounds.npy), MVS depth PFMs at half size and
    MiDaS PFMs, as the eval phase writes fern's. Returns (scene dir, the
    fixture file of each view)."""
    from consistentnerf_tpu_torch.data import pfm

    fixtures = sorted(f for f in os.listdir(JPEG_FIXTURES)
                      if f.startswith("llff_view_"))
    llff_root = os.path.join(root, "nerf_llff_data")
    scene = os.path.join(llff_root, "fern")
    mvs = os.path.join(llff_root, "nerf_llff_data_depth", "fern")
    midas = os.path.join(llff_root, "midas_llff_depth", "output_llff_fern")
    for d in (os.path.join(scene, "images"), mvs, midas):
        os.makedirs(d)
    rng = np.random.RandomState(2)
    h, w = int(CODEC_LLFF_HWF[0]), int(CODEC_LLFF_HWF[1])
    rows, views = [], []
    for i in range(CODEC_LLFF_VIEWS):
        src = fixtures[i % len(fixtures)]
        views.append(src)
        shutil.copy(os.path.join(JPEG_FIXTURES, src),
                    os.path.join(scene, "images", f"IMG_{4026 + i}.JPG"))
        a = rng.randn(3) * 0.03
        rot = np.linalg.qr(np.eye(3) + np.array(
            [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]))[0]
        rot = rot * np.sign(np.diag(rot))[None]
        llff_r = np.stack([-rot[:, 1], rot[:, 0], rot[:, 2]], 1)
        t = np.array([rng.uniform(-0.4, 0.4), rng.uniform(-0.3, 0.3),
                      rng.uniform(-0.05, 0.05)])
        pose = np.concatenate([llff_r, t[:, None],
                               np.array(CODEC_LLFF_HWF)[:, None]], 1)
        rows.append(np.concatenate([pose.reshape(-1),
                                    [1.2 + 0.1 * rng.rand(),
                                     20.0 + rng.rand()]]))
        depth = (3.0 + np.linspace(0, 1, w // 2)[None, :]
                 + 0.5 * np.linspace(0, 1, h // 2)[:, None]).astype(
                     np.float32)
        pfm.write_pfm(os.path.join(mvs, f"depth_{i:03d}.pfm"), depth)
        pfm.write_pfm(os.path.join(midas, f"IMG_{4026 + i}"
                                   "-dpt_beit_large_512.pfm"),
                      rng.randn(h, w).astype(np.float32))
    np.save(os.path.join(scene, "poses_bounds.npy"), np.stack(rows))
    return scene, views


def codec_phases(dev, card, configs, v2, op):
    """The image codecs on the card's machine: the committed JPEG
    fixtures decoded by the port (no imaging package here) against the
    SHA-256 of imageio's decode stored beside them, seconds per megapixel;
    an LLFF scene whose images/ are the fixture JPEGs loaded through
    `_minify` at factor 2 and at factor 1; 3 flagship one-pass steps
    through cli/train.py (#1 / #2 / #3 counted), the test poses rendered
    by cli/render.py (#1 counted) and stitched by cli/video.py into an
    mp4v MP4, held by a box reader; the writer's time a frame. Returns
    {kernel: launches}."""
    import hashlib

    from consistentnerf_tpu_torch.cli import render as render_cli
    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.cli import video as video_cli
    from consistentnerf_tpu_torch.data import images
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.data.video import Mp4Writer

    tag = f"[{card}]"
    if not os.path.isdir(JPEG_FIXTURES):
        fail(f"{JPEG_FIXTURES} is missing: run this script from the root of "
             "a checkout")
    with open(os.path.join("tests", "jpeg_fixtures.json")) as f:
        index = json.load(f)
    decoded, t_all, px_all, t_llff, px_llff = {}, 0.0, 0, 0.0, 0
    for name, want in sorted(index.items()):
        t0 = time.perf_counter()
        img = images.imread(os.path.join(JPEG_FIXTURES, name))
        dt = time.perf_counter() - t0
        got = hashlib.sha256(img.tobytes()).hexdigest()
        gate(list(img.shape) == want["shape"] and got == want["sha256"],
             f"JPEG fixture {name} ({want['what']}) decoded to "
             f"{img.shape} {got[:12]}, not imageio's {want['shape']} "
             f"{want['sha256'][:12]}")
        decoded[name] = img
        mp = img.shape[0] * img.shape[1]
        t_all, px_all = t_all + dt, px_all + mp
        if name.startswith("llff_view_"):
            t_llff, px_llff = t_llff + dt, px_llff + mp
    log(f"{tag} JPEG decode (host): {len(index)} fixtures equal imageio's "
        f"digests; {t_all / (px_all / 1e6):.3f} s a megapixel over all "
        f"({px_all} pixels in {t_all:.3f} s), "
        f"{t_llff / (px_llff / 1e6):.3f} s a megapixel on the 504x378 "
        "baseline 4:2:0 views")

    launches = {}
    tmp = tempfile.mkdtemp()
    try:
        scene_dir, views = write_codec_llff(tmp)
        want = dict(H=378, W=504, near=0.0, far=1.0, train=FERN_SPLITS[0],
                    test=FERN_SPLITS[1])
        for factor in (2, 1):
            cfg = configs.Config(**{**FLAGSHIP, "dataset_type": "llff",
                                    "datadir": scene_dir,
                                    "white_bkgd": False, "factor": factor,
                                    "basedir": tmp, "expname": "load"})
            t0 = time.perf_counter()
            scene = load_scene(cfg, device=dev, attach=False)
            dt = time.perf_counter() - t0
            h, w = 378 // factor, 504 // factor
            f_px = CODEC_LLFF_HWF[2] / factor
            expect = [decoded[v] if factor == 1 else images.resize(
                decoded[v], (w, h), interpolation=images.INTER_AREA)
                for v in views]
            scene_gates(f"codec fern (JPEG images/, factor {factor})", scene,
                        dict(want, H=h, W=w, K=np.array(
                            [[f_px, 0, 0.5 * w], [0, f_px, 0.5 * h],
                             [0, 0, 1]])),
                        [(i, scene.images[i], (e / 255.0).astype(np.float32))
                         for i, e in enumerate(expect)])
            if factor == 2:
                pngs = sorted(os.listdir(os.path.join(scene_dir,
                                                      "images_2")))
                gate(len(pngs) == CODEC_LLFF_VIEWS and all(
                    np.array_equal(images.imread(os.path.join(
                        scene_dir, "images_2", p)), e)
                    for p, e in zip(pngs, expect)),
                    "codec fern: _minify's PNGs are not the INTER_AREA "
                    "halves of the decoded JPEGs")
            what = ("_minify (JPEG decode, INTER_AREA, PNG write) and PNG "
                    "decode" if factor == 2 else "JPEG decode")
            log(f"{tag} codec fern factor {factor}: load_scene {dt:.2f} s "
                f"(host: {what}, PFMs, poses)")
            del scene

        sets = [f"{k}={v}" for k, v in FLAGSHIP.items()] + [
            "dataset_type=llff", f"datadir={scene_dir}", "factor=1",
            "white_bkgd=false", "near=0.0", "far=1.0", "train_view_num=3",
            "i_print=1", f"checkpoint_every={TRAIN_STEPS}",
            "use_tensorboard=false", f"basedir={tmp}", "expname=codec"]
        args = ["--device", str(dev)] + [x for s_ in sets
                                         for x in ("--set", s_)]
        counted = ((v2, "launches", v2.KERNEL),
                   (v2, "bwd_launches", v2.BWD_KERNEL),
                   (op, "launches", op.KERNEL))
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        res = train_cli.main(args + ["--num-steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for mod, attr, k in counted}
        want_l = {k: 2 * TRAIN_STEPS for _, _, k in counted}
        losses = [float(x["loss"]) for x in res.stats_history]
        log(f"codec fern cli.train (JPEG images/, factor 1, one-pass): "
            f"{res.state.step} steps in {dt:.1f} s (load and hard masks "
            f"included), losses {[round(x, 5) for x in losses]}, launches "
            f"{got} (expected {want_l})")
        gate(got == want_l and res.state.step == TRAIN_STEPS
             and all(np.isfinite(losses)),
             f"codec fern: cli.train launched {got} or ended at step "
             f"{res.state.step} with losses {losses}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

        v2.launches = 0
        out_dir = os.path.join(tmp, "frames")
        t0 = time.perf_counter()
        render_cli.main(args + ["--render-test", "--out", out_dir])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_test = len(FERN_SPLITS[1])
        chunks = -(-(378 * 504) // configs.Config().render_chunk_size)
        log(f"codec fern cli.render --render-test: {n_test} poses in "
            f"{dt:.1f} s, {v2.KERNEL} launches {v2.launches} (expected "
            f"{2 * chunks * n_test}: 2 a render chunk)")
        gate(v2.launches == 2 * chunks * n_test,
             f"codec fern: cli.render launched #1 {v2.launches} times")
        launches[v2.KERNEL] += v2.launches
        frames = sorted(os.listdir(out_dir))
        gate(frames == [f"{k}_{i:03d}.png" for k in ("color", "depth")
                        for i in range(n_test)],
             f"codec fern: cli.render wrote {frames}")
        video = os.path.join(tmp, "fern.mp4")
        t0 = time.perf_counter()
        video_cli.main([out_dir, "--out", video, "--fps", str(VIDEO_FPS)])
        dt = time.perf_counter() - t0
        log(f"codec cli.video: {n_test} side-by-side frames of 1008x378 in "
            f"{dt:.2f} s (PNG reads and the encode, host), "
            f"{os.path.getsize(video)} bytes; boxes: "
            + mp4_box_check(video, n_test, 2 * 504, 378, VIDEO_FPS))

        frame = np.concatenate([decoded["llff_view_0.jpg"],
                                decoded["llff_view_1.jpg"]], 1)
        with Mp4Writer(os.path.join(tmp, "timed.mp4"), VIDEO_FPS,
                       (frame.shape[1], frame.shape[0])) as writer:
            writer.write(frame)  # warm-up
            t0 = time.perf_counter()
            for _ in range(5):
                writer.write(frame)
            dt = (time.perf_counter() - t0) / 5
        log(f"{tag} MP4 (mp4v) encode (host): {1e3 * dt:.1f} ms a "
            f"{frame.shape[1]}x{frame.shape[0]} frame")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def mip_noviewdirs_phases(dev, card, configs, fmip, op):
    """The mip backbone without view directions at the JAX package's mip
    benchmark width (bench.py:241-258) on the card: train() through
    cli/train.py with the card's defaults (the kernel step turned on,
    the dispatch warns and takes the eager step; #5 / #6 / #7 launch 0
    times), 3 steps with finite losses; a 128x128 render with
    use_fused_render (it warns and renders through the module); the eager
    step's time; an fp32 step on the card against the CPU."""
    import warnings as warnings_lib

    from consistentnerf_tpu_torch.cli import train as train_cli
    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher, to_device
    from consistentnerf_tpu_torch.train import loop
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import step as step_lib
    from consistentnerf_tpu_torch.train.evaluation import camera_rays_for_view

    tag = f"[{card}]"
    counted = ((fmip, "launches", fmip.KERNEL),
               (fmip, "bwd_launches", fmip.BWD_KERNEL),
               (op, "mip_launches", op.MIP_KERNEL))
    # The kernel flags are left to the CLI's defaults for the card.
    mip = {k: v for k, v in MIP.items()
           if k not in ("use_fused_train", "use_onepass_train")}
    sets = ["dataset_type=synthetic", f"synthetic_views={SCENE['n_views']}",
            f"synthetic_hw={SCENE['H']}", "synthetic_interleave_test=false",
            "i_print=1", "use_tensorboard=false", "use_viewdirs=false",
            f"checkpoint_every={TRAIN_STEPS}"] + [
        f"{k}={v}" for k, v in mip.items() if k != "dataset_type"]
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--device", str(dev)] + [
            x for s_ in sets + [f"basedir={tmp}"] for x in ("--set", s_)]
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)
        with warnings_lib.catch_warnings(record=True) as caught:
            warnings_lib.simplefilter("always")
            t0 = time.perf_counter()
            res = train_cli.main(args + ["--num-steps", str(TRAIN_STEPS)])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for mod, attr, k in counted}
        said = [str(w.message) for w in caught
                if "use_viewdirs=false" in str(w.message)]
        losses = [float(x["loss"]) for x in res.stats_history]
        c = configs.Config(**MIP)
        log(f"mip use_viewdirs=false cli.train ({c.netdepth}x{c.netwidth}, "
            f"{c.mip_num_samples} x {c.mip_num_levels} samples, "
            f"{c.N_rand} + {MIP_PATCH} rays, {c.compute_dtype}): "
            f"{res.state.step} "
            f"steps in {dt:.1f} s, losses {[round(x, 5) for x in losses]}, "
            f"launches {got} (expected 0 of each); warning: {said}")
        gate(len(said) == 1 and "KeyError 'Dense_10'" in said[0]
             and "eager step" in said[0],
             f"mip use_viewdirs=false: the dispatch's warning {said}")
        gate(all(v == 0 for v in got.values()),
             f"mip use_viewdirs=false launched the mip kernels: {got}")
        gate(res.state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS
             and all(np.isfinite(losses)),
             f"mip use_viewdirs=false: step {res.state.step}, losses "
             f"{losses}")
        sd = res.state.model.state_dict()
        gate(sum(k.endswith(".weight") for k in sd) == c.netdepth + 2,
             "mip use_viewdirs=false: the MLP is not the shorter tree")

        cfg = configs.Config(**{**MIP, "use_viewdirs": False,
                                "use_fused_render": True})
        scene = synthetic.make_scene(**SCENE).to_scene_data()
        rays = camera_rays_for_view(scene, scene.poses[0], device=dev)
        with warnings_lib.catch_warnings(record=True) as caught:
            warnings_lib.simplefilter("always")
            render = render_lib.build_render_fn(res.state.model.eval(), cfg)
        for mod, attr, _ in counted:
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out = render(rays)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        said = [str(w.message) for w in caught
                if "through the module" in str(w.message)]
        got = {k: getattr(mod, attr) for mod, attr, k in counted}
        ok = (out["rgb"].shape == (SCENE["H"], SCENE["W"], 3)
              and bool(torch.isfinite(out["rgb"]).all())
              and bool(torch.isfinite(out["depth"]).all()))
        log(f"mip use_viewdirs=false render {SCENE['H']}x{SCENE['W']} "
            f"(use_fused_render): {1e3 * dt:.1f} ms through the module, "
            f"finite {ok}, mean rgb {out['rgb'].mean().item():.4f}, "
            f"launches {got}; warning: {len(said)}")
        gate(ok and len(said) == 1 and all(v == 0 for v in got.values()),
             "mip use_viewdirs=false: the render")

    # The eager step's time at the mip width, bf16.
    t_cfg = configs.Config(**{**MIP, "use_viewdirs": False,
                              "use_fused_train": False})
    state = loop.init_state(t_cfg, dev)
    step_fn = loop.select_train_step(t_cfg, state.model)
    batcher = MipBatcher(scene, t_cfg)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(2)]
    state, _ = step_fn(state, batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(5):
        state, stats = step_fn(state, batches[i % 2])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    log(f"{tag} mip use_viewdirs=false eager step (bf16, "
        f"{batches[0]['rgb'].shape[0]} rays x {MIP['mip_num_samples']} x "
        f"2): {ms:.1f} ms a step, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, batches
    torch.cuda.empty_cache()

    # fp32 on the card against the CPU, same batch and draws, perturb 0.
    c_cfg = configs.Config(**{**MIP, "use_viewdirs": False,
                              "use_fused_train": False,
                              "compute_dtype": "float32",
                              "randomized": False, "use_hardmask": False,
                              "compute_mono_depth_metrics": False,
                              "N_rand": NOVIEW_CPU_RAYS})
    c_state = loop.init_state(c_cfg, "cpu")
    full = to_device(MipBatcher(scene, c_cfg).next_batch(), "cpu")
    n = full["rgb"].shape[0]
    # The batch's N_rand random rays, without the 4x16x16 patch rays
    # that lead every mip batch (no term here reads them).
    batch = {k: (v.map(lambda t: t[-NOVIEW_CPU_RAYS:]) if hasattr(v, "map")
                 else v[-NOVIEW_CPU_RAYS:] if v.shape[:1] == (n,) else v)
             for k, v in full.items()}
    draws = step_lib.make_mip_step_draws(
        c_cfg, batch, torch.Generator().manual_seed(5), "cpu")

    def move(x, d):
        if isinstance(x, dict):
            return {k: move(v, d) for k, v in x.items()}
        if isinstance(x, list):
            return [move(v, d) for v in x]
        if hasattr(x, "map"):
            return x.map(lambda t: t.to(d))
        return x.to(d) if torch.is_tensor(x) else x

    cpu_step_gate(f"mip use_viewdirs=false eager step fp32, "
                  f"{NOVIEW_CPU_RAYS} rays, card vs CPU", c_cfg,
                  lambda c, m: step_lib.build_mip_train_step(m, c), c_state,
                  batch, draws, move, dev, loss_rtol=NOVIEW_LOSS_RTOL,
                  grad_rel=NOVIEW_TENSOR_REL, whole_rel=NOVIEW_GRAD_REL)

    # The step's fp32 floor on the CPU: the same step with each ray
    # origin moved by one ulp (up or down at random) against the CPU's.
    import copy
    import dataclasses

    g = torch.Generator().manual_seed(6)
    o = batch["rays"].origins
    nudged = dict(batch, rays=dataclasses.replace(
        batch["rays"], origins=torch.where(
            torch.randint(0, 2, o.shape, generator=g).bool(),
            torch.nextafter(o, torch.full_like(o, math.inf)),
            torch.nextafter(o, torch.full_like(o, -math.inf)))))
    out = []
    for b in (batch, nudged):
        st = copy.deepcopy(c_state)
        grads, real = [], st.optimizer.step

        def keep(count, st=st, grads=grads, real=real):
            grads.extend(grads_of(st.model))
            real(count)

        st.optimizer.step = keep
        _, stats = step_lib.build_mip_train_step(st.model, c_cfg)(st, b,
                                                                  draws)
        out.append((float(stats["loss"]), grads))
    (l0, g0), (l1, g1) = out
    per, _ = grads_err(g1, g0)
    whole, _ = grads_err([torch.cat([x.reshape(-1) for x in g1])],
                         [torch.cat([x.reshape(-1) for x in g0])])
    log(f"mip use_viewdirs=false fp32 floor on the CPU (origins nudged one "
        f"ulp): loss rel {abs(l1 - l0) / abs(l0):.2e}; grads rel L2 all "
        f"together {whole:.2e}, max a tensor {per:.2e} (the card-vs-CPU "
        f"bounds {NOVIEW_GRAD_REL:g} / {NOVIEW_TENSOR_REL:g})")


if __name__ == "__main__":
    try:
        if "--rank" in sys.argv:
            rank_worker(sys.argv[1:])
        elif "--canary" in sys.argv:
            canary_worker(sys.argv[1:])
        else:
            main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("unexpected error")
