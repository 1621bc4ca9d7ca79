#!/usr/bin/env python3
"""fp32 times of the level-walk train kernels and of the fp32 preset step,
for this tree and, optionally, an earlier one, on one card:

    python3 tools/fp32_walk_ab.py [--parent DIR] [--out FILE]

Each tree runs in a process of its own that imports the port from that
tree's root and builds its kernels there (`build/torch_kernels/` under
it). With `--parent DIR` the trees take turns: parent, this tree, this
tree, parent. Each process times, with CUDA events over back-to-back
launches on seeded inputs and weights:

* #3 `onepass_level` and #2 `fused_mlp_bwd` in fp32 and bf16 at the
  vanilla presets' step shapes (4096 random rays x 192 / 64 samples;
  4x16x16 patch rays x 192 / 64: 786,432 / 262,144 / 196,608 / 65,536
  points, 8x256, multires 10 / 4), with each launch's nine-slot plan;
  and the device time of one fp32 launch of each at the fine level by
  kernel (torch.profiler: the walk, the dW GEMM, the reduction);
* #5 `onepass_mip_level`, #7 `fused_mip_bwd` and #16
  `fused_mip_bwd_row` in fp32 and bf16 at the mip preset
  regnerf3_dtu_scan114's
  shapes (1024 data rays x 96 samples a level; #7 on the 1024 MiDaS
  patch rays and the 2048 random-pose rays of the TV norm, x 96: 98,304
  and 196,608 points; #16 on the patch rays' points as [N, 3] streams;
  MipMLP 8x256, 16 IPE frequencies), with each launch's nine-slot plan,
  the device time of one fp32 launch of #5 and of #7 on the patch rays
  by kernel, and the plain fp32 versions (autograd) on the same inputs;
  every kernel row also keeps a digest of its outputs' bits, and the
  summary says whether each tree's runs gave the same bits and whether
  the two trees did;
* the lego_3view preset's step as `cli/train.py` builds it on a CUDA
  device (its config through `cli/common.py::resolve_config` and
  `auto_fused_defaults`, the one-pass step, fp32), on the procedural
  scene at lego's half-resolution 400x400 with 3 train views (no dataset
  on the card's machine; the step's shapes are the preset's): ms a step
  after the first over a run of steps (host clock, one sync), device
  time and idle share of one profiled step, peak device memory; then
  the same with `ss_loss`; and likewise the mip presets
  regnerf3_dtu_scan114 (fp32, the one-pass mip step with the TV norm:
  1024 data + 4x16x16 MiDaS patch rays and 2048 random-pose rays, 96 x
  2 samples) and mipnerf3_dtu_scan114 (the same without the TV norm's
  rays), on the procedural scene at DTU's 512x640 crop with 3 train
  views and the random poses `cli/train.py` makes.

Bounds: the train FLOP a point of `chip_smoke.mlp_train_flops_per_point`
over 67.0 TFLOP/s (fp32 on the CUDA cores) and over 989 / 6 = 164.8
TFLOP/s (six bf16 products a fp32 product on the tensor cores). Prints
the card's name and power limit beside the times; writes every number
as JSON to `--out` (default `build/fp32_walk_ab.json`).

    python3 tools/fp32_walk_ab.py --bounds

prints, with no card, the same two fp32 bounds of every kernel row of
`PERF.md` §6 at the shapes that table gives it (`BOUND_SHAPES`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PEAK_FP32 = 67.0e12
PEAK_SIX = 989e12 / 6
FLAG_RAYS, PATCH_RAYS = 4096, 4 * 16 * 16
MIP_DATA_RAYS, MIP_PATCH_RAYS, MIP_RANDOM_RAYS, MIP_S = 1024, 1024, 2048, 96
STEPS = 6
# (row, points, kind) of PERF.md §6's kernel rows at the table's shapes:
# kind "fwd" / "train" of the vanilla MLP (8x256, multires 10 / 4), "mip
# fwd" / "mip train" of the MipMLP (16 IPE frequencies, view width 128),
# "normals" 6n's forward and walk back (2,236,416 FLOP a point).
BOUND_SHAPES = (
    ("#1 fine chunk", 1_572_864, "fwd"), ("#2 fine patch", 196_608, "train"),
    ("#3 fine", 786_432, "train"), ("#4 fine chunk", 1_572_864, "fwd"),
    ("#5 level (flagship mip)", 294_912, "mip train"),
    ("#6 render chunk", 786_432, "mip fwd"),
    ("#7 mip level", 393_216, "mip train"),
    ("6n render chunk", 786_432, "normals"),
    ("#10 two-call fine", 983_040, "fwd"),
    ("#11 two-call fine", 983_040, "train"),
    ("#12 fine chunk", 1_572_864, "fwd"),
    ("#13 two-call fine", 983_040, "fwd"),
    ("#14 two-call fine", 983_040, "train"),
    ("#15 mip level", 393_216, "mip fwd"),
    ("#16 mip level", 393_216, "mip train"))


def flop_table(chip_smoke) -> dict:
    """FLOP a point of each kind of BOUND_SHAPES."""
    f = chip_smoke.mlp_flops_per_point
    t = chip_smoke.mlp_train_flops_per_point
    mip = dict(ipe=True, view_width=128)
    return {"fwd": f(8, 256, (4,), 10, 4), "train": t(8, 256, (4,), 10, 4),
            "mip fwd": f(8, 256, (4,), 16, 4, **mip),
            "mip train": t(8, 256, (4,), 16, 4, **mip),
            "normals": 2_236_416}


def card_text() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else "power limit not read"


def event_ms(fn, iters, warmup=1):
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


def by_kernel(fn):
    """[(kernel name, device ms, count)] of one call of fn, from
    torch.profiler's CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key[:48], getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count) for e in prof.key_averages()]
    return sorted([r for r in rows if r[1] > 0], key=lambda r: -r[1])[:5]


def digest(out) -> str:
    """A short sha1 of the bits of a kernel's outputs (a tensor, or nested
    lists of them), to hold a launch against the other tree's."""
    import hashlib

    import torch

    h = hashlib.sha1()

    def feed(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        else:
            for y in x:
                feed(y)
    feed(out)
    return h.hexdigest()[:16]


def worker(tree: str, out: str) -> None:
    """One tree's numbers (see the module's docstring) into `out`."""
    sys.path.insert(0, tree)
    import ctypes

    import torch

    import consistentnerf_tpu_torch as pkg

    if not Path(pkg.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported the port from {pkg.__file__}, not "
                           f"{tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("this tool needs a CUDA device")
    from consistentnerf_tpu_torch.models.mlp import MipMLP
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.ops import fused_onepass as op

    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    res = {"tree": tree, "card": card_text()}
    t0 = time.perf_counter()
    _build.build_all([v2.BWD_KERNEL, op.KERNEL, fmip.BWD_KERNEL,
                      op.MIP_KERNEL])
    res["build_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)

    def rays(n):
        o = torch.randn((n, 3), generator=gen, device=dev)
        o = 4.0 * o / o.norm(dim=1, keepdim=True)
        d = -o + 0.5 * torch.randn((n, 3), generator=gen, device=dev)
        return o, d, d / d.norm(dim=1, keepdim=True)

    def depths(n, s, lo, hi):
        u = torch.rand((n, s), generator=gen, device=dev)
        return lo + (hi - lo) * torch.sort(u, dim=1).values

    # ---- #3 and #2 at the vanilla preset step's shapes ----
    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.train import loop

    cfg = configs.Config(backbone="vanilla", N_samples=64,
                         N_importance=128, white_bkgd=True)
    state = loop.init_state(cfg, dev)
    skips = op.model_skips(cfg.netdepth)
    kw = dict(net_depth=8, skips=skips, multires=10, multires_views=4)
    flat = [w.detach() for w in fm.flatten_params(state.model.fine, True, 8)]
    plan_o, _ = op._kernel()
    plan_b = _build.load(v2.BWD_KERNEL).fused_mlp_bwd_plan
    plan_b.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rows = {}
    for dtype in ("float32", "bfloat16"):
        w = v2.pack(flat, compute_dtype=dtype, **kw)
        bf = int(dtype == "bfloat16")
        for s, lvl in ((192, "fine"), (64, "coarse")):
            o, d, v = rays(FLAG_RAYS)
            z = depths(FLAG_RAYS, s, 2.0, 6.0)
            pts, views = op._pts_views(o.T.contiguous(), d.T.contiguous(),
                                       v.T.contiguous(), z)
            per_ray = (d.norm(dim=1),
                       torch.full((FLAG_RAYS,), 1e-4, device=dev),
                       torch.rand((FLAG_RAYS, 3), generator=gen, device=dev),
                       torch.full((FLAG_RAYS,), 1e-3, device=dev),
                       4.0 + torch.rand((FLAG_RAYS,), generator=gen,
                                        device=dev))
            pl = (ctypes.c_longlong * 9)()
            plan_o(FLAG_RAYS, s, 8, 256, 16, 10, 4, bf, pl)
            ms = event_ms(lambda: op.onepass_level(
                w, pts, views, z, *per_ray, white_bkgd=True,
                compute_dtype=dtype, **kw), 3 if s == 192 else 5)
            rows[f"#3 {dtype} {lvl}"] = dict(
                points=FLAG_RAYS * s, ms=ms, plan=list(pl),
                bits=digest(op.onepass_level(
                    w, pts, views, z, *per_ray, white_bkgd=True,
                    compute_dtype=dtype, **kw)))
            if dtype == "float32" and s == 192:
                res["split #3 fine fp32"] = by_kernel(lambda: op.onepass_level(
                    w, pts, views, z, *per_ray, white_bkgd=True,
                    compute_dtype=dtype, **kw))
            del pts, views, z
            n = PATCH_RAYS * s
            o, d, v = rays(PATCH_RAYS)
            pts, views = op._pts_views(o.T.contiguous(), d.T.contiguous(),
                                       v.T.contiguous(),
                                       depths(PATCH_RAYS, s, 2.0, 6.0))
            g = 1e-3 * torch.randn((4, n), generator=gen, device=dev)
            pl = (ctypes.c_longlong * 9)()
            plan_b(n, 8, 256, 16, 10, 4, bf, pl)
            ms = event_ms(lambda: v2.bwd_T(w, pts, views, g,
                                           compute_dtype=dtype, **kw),
                          3 if s == 192 else 5)
            rows[f"#2 {dtype} {lvl}"] = dict(
                points=n, ms=ms, plan=list(pl), bits=digest(v2.bwd_T(
                    w, pts, views, g, compute_dtype=dtype, **kw)))
            if dtype == "float32" and s == 192:
                res["split #2 fine fp32"] = by_kernel(lambda: v2.bwd_T(
                    w, pts, views, g, compute_dtype=dtype, **kw))
            del pts, views, g
            torch.cuda.empty_cache()

    # ---- #5 and #7 at the mip preset's shapes ----
    torch.manual_seed(0)
    mflat = [x.detach().to(dev) for x in
             fmip.flatten_mip_params(MipMLP().to(dev))]
    mw = fmip.pack(mflat, 8, 16, "float32")

    def gaussians(n, s):
        o, d, v = rays(n)
        t = depths(n, s + 1, 0.5, 3.5)
        tmid = 0.5 * (t[:, :-1] + t[:, 1:])
        means = (o[:, None] + d[:, None] * tmid[..., None]).reshape(-1, 3)
        covs = 1e-4 * torch.rand(means.shape, generator=gen, device=dev)
        views = v[:, None].expand(n, s, 3).reshape(-1, 3)
        return (means.T.contiguous(), covs.T.contiguous(),
                views.T.contiguous(), t, tmid, d.norm(dim=1))

    mcfg = fmip._cfg_args(mw)[:-1]

    def mip_plan(symbol, lead, bf):
        lib = op.MIP_KERNEL if symbol == op.MIP_KERNEL else fmip.BWD_KERNEL
        fn = getattr(_build.load(lib), symbol + "_plan")
        fn.argtypes = [ctypes.c_int] * (len(lead) + 7) + [ctypes.c_void_p]
        pl = (ctypes.c_longlong * 9)()
        if fn(*lead, *mcfg, bf, pl):
            raise RuntimeError(f"{symbol}_plan failed")
        return list(pl)

    for dtype in ("float32", "bfloat16"):
        mw = fmip.pack(mflat, 8, 16, dtype)
        bf, fp32 = int(dtype == "bfloat16"), dtype == "float32"
        means, covs, views, t, tmid, dn = gaussians(MIP_DATA_RAYS, MIP_S)
        delta = (t[:, 1:] - t[:, :-1]) * dn[:, None]
        ones = torch.ones((MIP_DATA_RAYS,), device=dev)
        margs = (means, covs, views, tmid, delta, t[:, 0].contiguous(),
                 t[:, -1].contiguous(), 1e-4 * ones,
                 torch.rand((MIP_DATA_RAYS, 3), generator=gen, device=dev),
                 1e-3 * ones, 2.0 * ones)

        def run5(fn=op.onepass_mip_level):
            return lambda: fn(mw, *margs, net_depth=8, num_freqs=16,
                              white_bkgd=False,
                              compute_dtype=fm.as_dtype(dtype))
        row5 = rows[f"#5 {dtype} level"] = dict(
            points=MIP_DATA_RAYS * MIP_S, ms=event_ms(run5(), 5),
            plan=mip_plan(op.MIP_KERNEL, (MIP_DATA_RAYS, MIP_S), bf),
            bits=digest(run5()()))
        if fp32:
            row5["plain_ms"] = event_ms(run5(op.plain_onepass_mip_level), 3)
            res["split #5 fp32"] = by_kernel(run5())
        for rays_n, label in ((MIP_PATCH_RAYS, "patch"),
                              (MIP_RANDOM_RAYS, "random-pose")):
            means, covs, views = gaussians(rays_n, MIP_S)[:3]
            n = rays_n * MIP_S
            g = 1e-3 * torch.randn((4, n), generator=gen, device=dev)

            def run7(fn=fmip.bwd_T):
                return lambda: fn(mw, means, covs, views, g, 8, 16, dtype)
            row7 = rows[f"#7 {dtype} {label}"] = dict(
                points=n, ms=event_ms(run7(), 5),
                plan=mip_plan(fmip.BWD_KERNEL, (n,), bf),
                bits=digest(run7()()))
            if fp32:
                row7["plain_ms"] = event_ms(run7(fmip.plain_bwd_T), 3)
            if label == "patch":
                if fp32:
                    res["split #7 fp32"] = by_kernel(run7())
                row = [x.T.contiguous() for x in (means, covs, views, g)]

                def run16():
                    return fmip.bwd(mw, *row, 8, 16, dtype)
                rows[f"#16 {dtype} patch"] = dict(
                    points=n, ms=event_ms(run16, 5),
                    plan=mip_plan(fmip.ROW_BWD_KERNEL, (n,), bf),
                    bits=digest(run16()))
                del row
        del means, covs, views, g, margs
        torch.cuda.empty_cache()
    res["kernels"] = rows

    # ---- the lego_3view preset's fp32 step ----
    from torch.profiler import ProfilerActivity, profile

    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.data.pipeline import (VanillaBatcher,
                                                        to_device)

    from consistentnerf_tpu_torch.data import synthetic
    from consistentnerf_tpu_torch.data.loaders import attach_priors
    from consistentnerf_tpu_torch.data.pipeline import MipBatcher
    from consistentnerf_tpu_torch.data.random_poses import \
        generate_random_poses

    steps = {}
    basedir = tempfile.mkdtemp()  # the hard masks' cache
    cases = [("lego_3view", "plain", False), ("lego_3view", "ss_loss", True),
             ("regnerf3_dtu_scan114", "regnerf3", False),
             ("mipnerf3_dtu_scan114", "mipnerf3", False)]
    for preset, key, ss in cases:
        sets = [f"basedir={basedir}"]
        if preset == "lego_3view":
            sets += ["dataset_type=synthetic", "synthetic_hw=400",
                     "synthetic_views=6", "synthetic_n_test=3",
                     "synthetic_interleave_test=false",
                     f"ss_loss={str(ss).lower()}"]
        argv = ["--scene", preset, "--device", "cuda"] + [
            x for s_ in sets for x in ("--set", s_)]
        args = common.make_parser("fp32 step").parse_args(argv)
        scfg = common.auto_fused_defaults(common.resolve_config(args), args)
        if preset == "lego_3view":
            scene = load_scene(scfg, device="cuda")
            batcher = VanillaBatcher(scene, scfg)
        else:
            # DTU's 512x640 crop, 3 train views (the preset's split of a
            # scan), procedural content; the random poses as cli/train.py
            # makes them.
            scene = attach_priors(synthetic.make_scene(
                n_views=6, H=512, W=640).to_scene_data(n_test=3), scfg,
                "cuda")
            poses = None
            if scfg.load_random_rays:
                poses = generate_random_poses(
                    scene.poses[scene.i_train], n_poses=scfg.n_random_poses,
                    pose_type=scfg.random_pose_type,
                    radius=scfg.random_pose_radius,
                    focusptjitter=scfg.random_pose_focusptjitter,
                    add_test_poses=scfg.random_pose_add_test_poses,
                    test_poses=scene.poses[scene.i_test])
            batcher = MipBatcher(scene, scfg, random_poses=poses)
        sstate = loop.init_state(scfg, dev)
        step_fn = loop.select_train_step(scfg, sstate.model)
        batches = [to_device(batcher.next_batch(), dev) for _ in range(4)]
        b0 = batches[0]
        n_rays = int(b0["rgb"].shape[0]) + (
            int(b0["rays_random"].origins.shape[0])
            if "rays_random" in b0 else 0)
        torch.cuda.reset_peak_memory_stats()
        sstate, stats = step_fn(sstate, batches[0])
        torch.cuda.synchronize()
        n_steps = STEPS if not ss else STEPS // 2
        t0 = time.perf_counter()
        for i in range(n_steps):
            sstate, stats = step_fn(sstate, batches[(i + 1) % 4])
        loss = float(stats["loss"])
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn(sstate, batches[1])
            torch.cuda.synchronize()
        dev_ms = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in prof.key_averages()) / 1e3
        steps[key] = dict(
            preset=preset, dtype=scfg.compute_dtype,
            onepass=bool(scfg.use_onepass_train), rays=n_rays,
            step_ms=step_ms,
            steps=n_steps, device_ms=dev_ms,
            idle=max(0.0, 1 - dev_ms / step_ms), peak_gib=peak, loss=loss)
        del sstate, step_fn, batches, scene
        torch.cuda.empty_cache()
    res["steps"] = steps
    shutil.rmtree(basedir, ignore_errors=True)
    Path(out).write_text(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="an earlier tree, timed in turns with this one")
    ap.add_argument("--out", default=str(REPO / "build" /
                                         "fp32_walk_ab.json"))
    ap.add_argument("--bounds", action="store_true",
                    help="print the fp32 bounds of every kernel row and "
                    "exit (no card)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.worker_out)
        return
    sys.path.insert(0, str(REPO))
    import chip_smoke

    if args.bounds:
        pp = flop_table(chip_smoke)
        for row, n, kind in BOUND_SHAPES:
            flop = n * pp[kind]
            print(f"{row} (N={n}, {pp[kind]} FLOP a point): fp32 bounds "
                  f"{1e3 * flop / PEAK_FP32:.3f} ms (CUDA cores) / "
                  f"{1e3 * flop / PEAK_SIX:.3f} ms (six bf16 products)")
        return
    order = [("change", str(REPO))]
    if args.parent:
        parent = str(Path(args.parent).resolve())
        order = [("parent", parent), ("change", str(REPO)),
                 ("change", str(REPO)), ("parent", parent)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, (tag, tree) in enumerate(order):
        part = f"{args.out}.{i}"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, __file__, "--worker", tree,
                        "--worker-out", part], check=True)
        run = json.loads(Path(part).read_text())
        run["tag"], run["wall_s"] = tag, time.perf_counter() - t0
        runs.append(run)
    pp = {"vanilla": chip_smoke.mlp_train_flops_per_point(8, 256, (4,), 10,
                                                          4),
          "mip": chip_smoke.mlp_train_flops_per_point(
              8, 256, (4,), 16, 4, ipe=True, view_width=128)}
    print(f"card: {runs[0]['card']}")
    print(f"train FLOP a point: vanilla {pp['vanilla']}, mip {pp['mip']}")
    for name in runs[0]["kernels"]:
        k = runs[0]["kernels"][name]
        flop = k["points"] * pp["mip" if name.split()[0] in (
            "#5", "#7", "#16") else "vanilla"]
        times = "; ".join(f"{r['tag']} {r['kernels'][name]['ms']:.3f}"
                          for r in runs)
        slot8 = {r["tag"]: r["kernels"][name].get("plan", [None] * 9)[8]
                 for r in runs}
        plain = "; ".join(f"{r['tag']} {r['kernels'][name]['plain_ms']:.3f}"
                          for r in runs if "plain_ms" in r["kernels"][name])
        bits = {tag: {r["kernels"][name].get("bits") for r in runs
                      if r["tag"] == tag} for tag in ("parent", "change")}
        same = {tag: len(b) == 1 for tag, b in bits.items() if b}
        if len(same) == 2:
            same["change = parent"] = bits["parent"] == bits["change"]
        print(f"{name} (N={k['points']}): {times} ms/launch; bounds "
              f"{1e3 * flop / PEAK_FP32:.3f} (CUDA cores) / "
              f"{1e3 * flop / PEAK_SIX:.3f} (six-product tensor) ms; "
              f"plan slot 8 {slot8}"
              + (f"; plain version {plain} ms" if plain else "")
              + f"; the same bits (each tree's runs; across trees): "
              f"{same}")
    for key in runs[0]["steps"]:
        for r in runs:
            s = r["steps"][key]
            print(f"{s['preset']} step ({key}, {s['dtype']}, one-pass "
                  f"{s['onepass']}, {s['rays']} rays) [{r['tag']}]: "
                  f"{s['step_ms']:.2f} ms/step over {s['steps']}, device "
                  f"{s['device_ms']:.2f} ms, idle {s['idle']:.3f}, peak "
                  f"{s['peak_gib']:.2f} GiB, loss {s['loss']:.5f}")
    for r in runs:
        for key in ("split #3 fine fp32", "split #2 fine fp32",
                    "split #5 fp32", "split #7 fp32"):
            print(f"{key} [{r['tag']}]: " + "; ".join(
                f"{k} {ms:.3f} ms x{c}" for k, ms, c in r[key]))
        print(f"[{r['tag']}] build {r['build_s']:.1f} s, process "
              f"{r['wall_s']:.1f} s ({r['tree']})")
    Path(args.out).write_text(json.dumps(
        {"card": runs[0]["card"], "flop_per_point": pp, "runs": runs}))


if __name__ == "__main__":
    main()
