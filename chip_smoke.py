#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds every hand-written kernel of the port from `consistentnerf_tpu_torch/
csrc/` (one nvcc per source, in parallel) and drives the main paths, each
with the launch counts set to 0 just before it and read just after:

* render: the deterministic bf16 render of the 6-view 128x128 synthetic
  scene through `build_render_fn` (full 8x256 model, 64 + 128 samples,
  seeded weights), then the render CLI on two test views;
* train: the train CLI on the flagship config of `bench.py:66-84` (5120
  rays a step: 4096 random + 4x16x16 patch rays, hard mask, depth loss,
  MiDaS and SSIM patch terms, bf16, perturb 1, the one-pass kernel step)
  for a few steps, a checkpoint, and a resume from it;
* mip render: the same scene through the mip backbone's render (MipMLP
  8x256, 16 IPE frequencies, 96 samples x 2 levels, bf16, the fused mip
  forward);
* mip train: the train CLI on the mip config of `bench.py:241-258` (3072
  random + 4x16x16 MiDaS patch rays, hard mask, depth and MiDaS terms,
  bf16, randomized, the one-pass mip step) for a few steps and a resume.

Each kernel is held against its plain PyTorch version at the shapes its
path gives it, in bf16 and fp32; the kernel train step is held against the
plain eager step from the same state, batch and draws; timings are
printed beside the card's name and power limit. The last line is
`{"ok": true, "device": {...}}`; any failure exits non-zero before it.
Imports torch and the port only (no jax, nothing of consistentnerf_tpu).
"""

from __future__ import annotations

import ctypes
import json
import os
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


def rel_err(got, want):
    diff = (got - want).abs()
    return diff.max().item() / want.abs().mean().item(), diff.max().item()


def ptxas_report(_build, name):
    """Registers, spills and stack of each kernel in a build log."""
    entry = None
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = ("bf16" if "bfloat16" in mangled else
                     "fp32" if "reduce" not in mangled else "reduce")
        elif "Used" in line or "spill" in line:
            log(f"  {name} [{entry}]: {line.strip()}")


def grads_err(got, want):
    """(largest ||g - w|| / ||w|| over the tensors, largest |g - w|)."""
    rel = max((torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(
        1e-30)).item() for a, b in zip(got, want))
    mx = max((a - b).abs().max().item() for a, b in zip(got, want))
    return rel, mx


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

    names = [v2.KERNEL, v2.BWD_KERNEL, op.KERNEL, fmip.KERNEL,
             fmip.BWD_KERNEL, op.MIP_KERNEL]
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
    plan_b = _build.load(v2.BWD_KERNEL).fused_mlp_bwd_plan
    plan_b.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    plan_o = _build.load(op.KERNEL).onepass_level_plan
    plan_o.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for bf in (1, 0):
        out = (ctypes.c_longlong * 4)()
        plan_b(196608, 8, 256, 16, 10, 4, bf, out)
        outo = (ctypes.c_longlong * 4)()
        plan_o(4096, 192, 8, 256, 16, 10, 4, bf, outo)
        log(f"  {'bf16' if bf else 'fp32'}: {v2.BWD_KERNEL} {out[3]} bytes "
            f"of shared memory, {out[0]} blocks; {op.KERNEL} {outo[3]} "
            f"bytes, {outo[0]} blocks")
    plan_mb = _build.load(fmip.BWD_KERNEL).fused_mip_bwd_plan
    plan_mb.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    plan_mo = _build.load(op.MIP_KERNEL).onepass_mip_level_plan
    plan_mo.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    for bf in (1, 0):
        out, outo = (ctypes.c_longlong * 4)(), (ctypes.c_longlong * 4)()
        plan_mb(98304, 8, 256, 128, 16, 16, 4, bf, out)
        plan_mo(3072, 96, 8, 256, 128, 16, 16, 4, bf, outo)
        log(f"  {'bf16' if bf else 'fp32'}: {fmip.BWD_KERNEL} {out[3]} "
            f"bytes of shared memory, {out[0]} blocks; {op.MIP_KERNEL} "
            f"{outo[3]} bytes, {outo[0]} blocks")

    t_phase = time.perf_counter()
    render = render_phases(dev, card, configs, fm, v2)
    train = train_phases(dev, card, configs, fm, v2, op)
    log(f"vanilla phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    mip_render = mip_render_phases(dev, card, configs, fm, fmip)
    mip_train = mip_train_phases(dev, card, configs, fm, fmip, op)
    log(f"mip phases: {time.perf_counter() - t_phase:.1f} s")

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
    ] + mip_train["json"]}
    if GATE_FAILURES:
        fail(f"{len(GATE_FAILURES)} gate(s) failed: {GATE_FAILURES}")
    log(json.dumps(kernels))
    log(f"nvidia-smi: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


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
        f"{ms_coarse:.3f} ms/launch, bound {b_coarse:.3f} ms")
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
            "render; by kernel: " + "; ".join(
                f"{k} {ms:.2f} ms x{n}" for k, ms, n in top))
    return {"launches": launches + cli_launches, "json": dict(
        max_abs_err=errs["fine bf16"], ms=ms_fine, plain_ms=plain_ms,
        bound_ms=b_fine, bound_by=by_fine, library_ms=None)}


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
    import copy

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
            del got, want, got_rows, want_rows
            torch.cuda.empty_cache()

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

    def grads_at_update(state):
        """Copies of the grads that the optimizer's next update reads."""
        opt, grads = state.optimizer, []
        update = opt.step

        def step(count):
            grads.extend(torch.zeros_like(q) if q.grad is None else
                         q.grad.detach().clone() for q in opt.params)
            update(count)

        opt.step = step
        return grads

    k_state, e_state = copy.deepcopy(g_state), copy.deepcopy(g_state)
    grads_k, grads_e = grads_at_update(k_state), grads_at_update(e_state)
    s_k, st_k = op.build_onepass_vanilla_train_step(g_cfg)(
        k_state, g_batch, g_draws)
    eager = step_lib.build_vanilla_train_step(e_state.model, g_cfg)
    s_e, st_e = eager(e_state, g_batch, g_draws)
    torch.cuda.synchronize()
    grad_rel, _ = grads_err(grads_k, grads_e)
    norm_rel = abs(float(st_k["grad_norm"]) / float(st_e["grad_norm"]) - 1)
    log(f"step guard grads: max rel L2 over the {len(grads_e)} parameters "
        f"{grad_rel:.3e}, grad norm kernel {float(st_k['grad_norm']):.6e} "
        f"eager {float(st_e['grad_norm']):.6e} (rel {norm_rel:.3e}; tol "
        f"{STEP_GRAD_TOL:g})")
    gate(grad_rel < STEP_GRAD_TOL and norm_rel < STEP_GRAD_TOL,
         f"kernel step grads disagree with the eager step ({grad_rel:.3e})")
    d_loss = abs(float(st_k["loss"]) - float(st_e["loss"]))
    deltas = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(
        s_k.model.parameters(), s_e.model.parameters())])
    lr0 = g_cfg.lrate
    share = (deltas > 0.1 * lr0).float().mean().item()
    log(f"step guard (N_rand {GUARD_N_RAND}, bf16): loss kernel "
        f"{float(st_k['loss']):.6f} eager {float(st_e['loss']):.6f}, "
        f"|dloss| {d_loss:.3e}; max|dparam| {deltas.max().item():.3e} "
        f"(one Adam step moves a parameter by at most ~lr = {lr0:g}); "
        f"share of parameters apart by > 0.1 lr: {share:.4f}")
    gate(d_loss < STEP_LOSS_TOL * abs(float(st_e["loss"])),
         f"kernel step loss disagrees with the eager step ({d_loss})")
    gate(deltas.max().item() <= 2.0 * lr0 * 1.001 and share <= 0.05,
         "kernel step update disagrees with the eager step")
    del s_k, s_e, eager, g_state, k_state, e_state, grads_k, grads_e
    torch.cuda.empty_cache()

    # 9. Timings, tagged with the card.
    tag = f"[{card}]"
    t_state = loop.init_state(cfg, dev)
    step_fn = loop.select_train_step(cfg, t_state.model)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
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
            "render; by kernel: " + "; ".join(
                f"{k} {t:.2f} ms x{c}" for k, t, c in top))
    return {"launches": launches, "json": dict(
        max_abs_err=errs["level 1 bf16"], ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None)}


def mip_train_phases(dev, card, configs, fm, fmip, op):
    """The mip train path: #7 and #5 (and #6 on the patch rays) vs their
    plain versions at the step's shapes, the train CLI with a checkpoint
    and a resume, the step guard, timings and a profile of one step."""
    import copy

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
            del got, want, got_rows, want_rows
            torch.cuda.empty_cache()

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

    def grads_at_update(state):
        opt, grads = state.optimizer, []
        update = opt.step

        def step(count):
            grads.extend(torch.zeros_like(q) if q.grad is None else
                         q.grad.detach().clone() for q in opt.params)
            update(count)

        opt.step = step
        return grads

    k_state, e_state = copy.deepcopy(g_state), copy.deepcopy(g_state)
    grads_k, grads_e = grads_at_update(k_state), grads_at_update(e_state)
    _, st_k = op.build_onepass_mip_train_step(g_cfg)(k_state, g_batch)
    _, st_e = step_lib.build_mip_train_step(e_state.model, g_cfg)(
        e_state, g_batch)
    torch.cuda.synchronize()
    grad_rel, _ = grads_err(grads_k, grads_e)
    norm_rel = abs(float(st_k["grad_norm"]) / float(st_e["grad_norm"]) - 1)
    d_loss = abs(float(st_k["loss"]) - float(st_e["loss"]))
    log(f"mip step guard (N_rand {GUARD_N_RAND}, bf16): loss kernel "
        f"{float(st_k['loss']):.6f} eager {float(st_e['loss']):.6f}, "
        f"|dloss| {d_loss:.3e}; grads max rel L2 over the {len(grads_e)} "
        f"parameters {grad_rel:.3e}, grad norm kernel "
        f"{float(st_k['grad_norm']):.6e} eager "
        f"{float(st_e['grad_norm']):.6e} (rel {norm_rel:.3e}; tol "
        f"{STEP_GRAD_TOL:g})")
    gate(d_loss < STEP_LOSS_TOL * abs(float(st_e["loss"])),
         f"mip kernel step loss disagrees with the eager step ({d_loss})")
    gate(grad_rel < STEP_GRAD_TOL and norm_rel < STEP_GRAD_TOL,
         f"mip kernel step grads disagree with the eager step "
         f"({grad_rel:.3e})")
    del g_state, k_state, e_state, grads_k, grads_e
    torch.cuda.empty_cache()

    # 16. Timings, tagged with the card.
    tag = f"[{card}]"
    t_state = loop.init_state(cfg.replace(density_noise=0.0), dev)
    step_fn = loop.select_train_step(cfg.replace(density_noise=0.0),
                                     t_state.model)
    batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
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


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        fail("unexpected error")
