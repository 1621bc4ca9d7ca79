"""Repeat the MVS depth net's forward on the card and count how its bits vary.

Runs `models/mvs.py::MVSDepthNet` at the JAX package's defaults (32
planes, base width 8, 2 sources) on a half-res Blender view's 400x400,
with seeded images and three cameras on a circle of radius 4 around the
origin (near 2, far 6), in fp32. The same forward runs `--repeats`
times with cuDNN's default algorithm choice and then as
`train/mvs.py::view_predictor` runs it (`mvs.deterministic_cudnn`).
For each it prints the largest difference of depth and conf from the
first run, the pixels whose depth prior (depth where conf reaches
`mvs_conf_thresh`, else 0) differs, and the median forward time.

    python tools/mvs_predict_repeat.py [--repeats 20] [--device cuda]
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from consistentnerf_tpu_torch.models import mvs as mvs_lib  # noqa: E402
from consistentnerf_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from consistentnerf_tpu_torch.train import mvs as mvs_train  # noqa: E402

CONF_THRESH = 0.25  # Config.mvs_conf_thresh


def orbit_pose(angle: float) -> np.ndarray:
    """A camera at radius 4 on the xz circle, looking at the origin
    (OpenGL axes: the camera looks down its -z)."""
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return np.concatenate([rot, 4.0 * rot[:, 2:3]], 1).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--size", type=int, default=400)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    fm.strict_fp32(dev)
    rng = np.random.default_rng(0)
    h = w = a.size
    images = torch.as_tensor(rng.random((3, h, w, 3), np.float32),
                             device=dev)
    poses = torch.as_tensor(np.stack([orbit_pose(t)
                                      for t in (0.0, 0.2, -0.2)]),
                            device=dev)
    f = 0.5 * w / math.tan(0.5 * 0.6911112070083618)
    K = torch.tensor([[f, 0.0, 0.5 * w], [0.0, f, 0.5 * h],
                      [0.0, 0.0, 1.0]], device=dev)
    net = mvs_lib.MVSDepthNet(32, 8, "float32")
    net.reset_parameters(torch.Generator().manual_seed(0))
    net = net.to(dev).eval()

    def forward():
        with torch.no_grad():
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(images[0], images[1:], poses[0], poses[1:], K, 2.0,
                      6.0)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

    def run(label, ctx):
        with ctx():
            forward()  # warm
            outs, ms = zip(*(forward() for _ in range(a.repeats)))
        first = outs[0]
        prior0 = first["depth"] * (first["conf"] >= CONF_THRESH)
        d_depth = max(float((o["depth"] - first["depth"]).abs().max())
                      for o in outs)
        d_conf = max(float((o["conf"] - first["conf"]).abs().max())
                     for o in outs)
        flips = max(int(((o["depth"] * (o["conf"] >= CONF_THRESH))
                         != prior0).sum()) for o in outs)
        same = sum(all(torch.equal(o[k], first[k]) for k in first)
                   for o in outs)
        res = dict(mode=label, repeats=a.repeats, bitwise_equal_runs=same,
                   max_depth_diff=d_depth, max_conf_diff=d_conf,
                   max_prior_pixels_differing=flips,
                   median_ms=float(np.median(ms)),
                   kept=float((prior0 > 0).float().mean()))
        print(json.dumps(res), flush=True)
        return res

    class default_flags:
        def __enter__(self):
            self.saved = (torch.backends.cudnn.deterministic,
                          torch.backends.cudnn.benchmark)
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = False

        def __exit__(self, *exc):
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = self.saved

    results = [run("cudnn default", default_flags),
               run("deterministic_cudnn", mvs_train.deterministic_cudnn)]
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0), flush=True)
    return results


if __name__ == "__main__":
    main()
