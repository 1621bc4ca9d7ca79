"""Generate the reprojection hard masks of a scene and save them:

    python -m consistentnerf_tpu_torch.cli.make_masks --scene lego_3view

The masks of `consistency/reproject.py` from the scene's depth priors,
computed on `--device`, written as `{i}_mask_{n}view.jpg` for every view
(the reference's mask generator layout) and packed as `masks.npy` (bool
[N, H, W]) under `--out` (default
`{basedir}/{expname}/mask/{scene}/{n}view`).
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Generate reprojection hard masks")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)

    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.data.images import write_jpeg
    from consistentnerf_tpu_torch.data.loaders import load_scene

    scene = load_scene(cfg, device=args.device, attach=False)
    scene.ensure_priors()
    masks = reproject.compute_hard_masks(
        scene.poses, scene.depths, scene.K, scene.i_train, scene.H, scene.W,
        occlusion_threshold=cfg.occlusion_threshold, device=args.device)

    scene_name = os.path.basename(os.path.normpath(cfg.datadir))
    out_dir = args.out or os.path.join(
        cfg.basedir, cfg.expname, "mask", scene_name,
        f"{cfg.train_view_num}view")
    os.makedirs(out_dir, exist_ok=True)
    for i in range(masks.shape[0]):
        write_jpeg(os.path.join(out_dir,
                                f"{i}_mask_{cfg.train_view_num}view.jpg"),
                   (masks[i] * 255).astype(np.uint8))
    np.save(os.path.join(out_dir, "masks.npy"), masks)
    print(f"wrote {masks.shape[0]} masks to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
