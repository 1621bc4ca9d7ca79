#!/usr/bin/env python3
"""`evaluate()`'s throughput with and without its images, for this
checkout's `train/evaluation.py` and for other copies of that module, in
turns:

    python3 tools/eval_ab.py [--other NAME=PATH ...]

Writes `chip_smoke.py`'s fixtures (LLFF fern, Blender lego, DTU scan114)
under a temporary directory and loads two of them at the smoke's
settings: fern with the flagship vanilla model (bf16 8x256, 64 + 128
samples), all 20 views scored, and scan114 with the mip model, its 25
pixelnerf test views scored with the IDR-masked metrics. Weights are
seeded, not trained. For each scene, each module's `evaluate()` runs on
the card with its PNGs written (into a temporary directory) and without
them; the modules take turns forwards, then backwards. An other module
is a file loaded under NAME; it imports the rest of the port from this
checkout. Prints the card's name and power limit, and for each call
eval_rays_per_sec, its wall time, its PNG count and its PSNR (equal in
every call of a scene).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", action="append", default=[],
                   metavar="NAME=PATH",
                   help="another copy of train/evaluation.py")
    args = p.parse_args()

    import numpy as np
    import torch

    chip_smoke.torch = torch
    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.ops import _build
    from consistentnerf_tpu_torch.ops import fused_mip as fmip
    from consistentnerf_tpu_torch.ops import fused_mlp as fm
    from consistentnerf_tpu_torch.ops import fused_mlp_v2 as v2
    from consistentnerf_tpu_torch.train import evaluation

    if not torch.cuda.is_available():
        sys.exit("tools/eval_ab.py needs a CUDA device")
    modules = [("this", evaluation)]
    for item in args.other:
        name, path = item.split("=", 1)
        spec = importlib.util.spec_from_file_location(f"eval_ab_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        modules.append((name, mod))
    dev = torch.device("cuda")
    fm.strict_fp32(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    _build.build_all([v2.KERNEL, fmip.KERNEL])

    def cfg_of(sets):
        a = common.make_parser("eval_ab").parse_args(
            ["--device", "cuda"] + [x for s in sets for x in ("--set", s)])
        return common.auto_fused_defaults(common.resolve_config(a), a)

    with tempfile.TemporaryDirectory() as tmp:
        fx = chip_smoke.write_scene_fixtures(tmp)
        dtu, fern = fx["scan114"], fx["fern"]
        scenes = (
            ("scan114", cfg_of(
                [f"{k}={v}" for k, v in chip_smoke.MIP.items()
                 if k not in ("dataset_type", "white_bkgd")]
                + ["dataset_type=dtu", f"datadir={dtu['dir']}",
                   "white_bkgd=false", "dtu_split_type=pixelnerf",
                   "train_view_num=3", f"basedir={tmp}",
                   "expname=scan114", f"dtu_mask_path={dtu['mask_path']}",
                   "factor=0"]), None, True),
            ("fern", cfg_of(
                [f"{k}={v}" for k, v in chip_smoke.FLAGSHIP.items()]
                + ["dataset_type=llff", f"datadir={fern['dir']}",
                   f"factor={chip_smoke.FERN['factor']}",
                   "white_bkgd=false", "near=0.0", "far=1.0",
                   "train_view_num=3", f"basedir={tmp}", "expname=fern"]),
             np.arange(chip_smoke.FERN["n"]), False),
        )
        for label, cfg, views, attach in scenes:
            scene = load_scene(cfg, device=dev, attach=attach)
            model = make_model(cfg, dev).eval()
            n = len(scene.i_test if views is None else views)
            print(f"{label}: {n} views, "
                  f"{evaluation.views_per_call(cfg, dev, n)} a call",
                  flush=True)
            evaluation.evaluate(model, cfg, scene, views=views,
                                save_images=False)
            for name, mod in modules + modules[::-1]:
                out = []
                for images in (True, False):
                    with tempfile.TemporaryDirectory() as d:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        m = mod.evaluate(model, cfg, scene, out_dir=d,
                                         views=views, save_images=images)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                        pngs = sum(f.startswith("color_")
                                   for f in os.listdir(d))
                    out.append(
                        f"{'images' if images else 'no images'} "
                        f"{m['eval_rays_per_sec']:.1f} rays/s (call "
                        f"{wall:.3f} s, {pngs} colour PNGs, psnr "
                        f"{m['psnr']:.6f})")
                print(f"{label} {name}: " + "; ".join(out), flush=True)
            del scene, model


if __name__ == "__main__":
    main()
