"""Export per-view depth priors as PFM files from a trained checkpoint:

    python -m consistentnerf_tpu_torch.cli.export_depth_priors \
        --scene lego_3view --out priors/lego [--step N] [--views train]

Restores `{basedir}/{expname}/checkpoints/step_*.pt` (the given step,
else the newest; a random init, said so, without one), renders each view
(`--views all`, or the train views) through `build_render_fn` and writes
its expected depth as `depth_{vid:04d}.pfm`, the layout of the
reference's `nerf_*_data_depth/{scene}` priors.
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Export depth priors (PFM) from a checkpoint")
    p.add_argument("--out", type=str, required=True,
                   help="output dir (nerf_*_data_depth/{scene} layout)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--views", type=str, default="all",
                   choices=["all", "train"])
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)

    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.data.pfm import write_pfm
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    scene = load_scene(cfg, device=args.device, attach=False)
    scene.ensure_priors()
    model = make_model(cfg, args.device)
    ckpt_dir = os.path.join(cfg.basedir, cfg.expname, "checkpoints")
    step = CheckpointManager(ckpt_dir).restore_for_eval(model, args.step)
    if step is None:
        print(f"no checkpoint under {ckpt_dir}; exporting from a random "
              f"init (seed {cfg.seed})")
    else:
        print(f"restored step {step} from {ckpt_dir}")
    model.eval()

    os.makedirs(args.out, exist_ok=True)
    render = render_lib.build_render_fn(model, cfg)
    views = (range(scene.images.shape[0]) if args.views == "all"
             else [int(v) for v in scene.i_train])
    for vid in views:
        rays = camera_rays_for_view(scene, scene.poses[vid],
                                    device=args.device)
        depth = render(rays)["depth"].float().cpu().numpy()
        write_pfm(os.path.join(args.out, f"depth_{vid:04d}.pfm"),
                  depth.astype(np.float32))
        print(f"wrote depth_{vid:04d}.pfm")
    return step


if __name__ == "__main__":
    main()
