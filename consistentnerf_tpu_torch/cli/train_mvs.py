"""Train the MVS depth-prior network on a scene and export its priors:

    python -m consistentnerf_tpu_torch.cli.train_mvs --set dataset_type=dtu \
        --set datadir=data/DTU/scan114 --steps 800 --with-masks

Fits `models/mvs.py` on the scene's train views (supervised by depth
where the scene's depths are ground truth, photometric otherwise), prints
the priors' depth-MSE against the scene's depths (saying whether those
are ground truth), writes the priors as `depth_{vid:04d}.pfm` under
`--out` (default `{basedir}/{expname}/mvs_priors`) and, with
`--with-masks`, the hard masks derived from them as `{vid}_mask_mvs.jpg`.
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Train the MVS depth-prior net, export PFMs")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default <expdir>/mvs_priors)")
    p.add_argument("--with-masks", action="store_true",
                   help="also write hard masks derived from the priors")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)

    from consistentnerf_tpu_torch.consistency import reproject
    from consistentnerf_tpu_torch.data.images import write_jpeg
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.data.pfm import write_pfm
    from consistentnerf_tpu_torch.train import mvs as mvs_train

    scene = load_scene(cfg, device=args.device, attach=False)
    scene.ensure_priors()
    result = mvs_train.train_mvs_depth(cfg, scene, num_steps=args.steps,
                                       device=args.device)
    priors = mvs_train.predict_depth_priors(cfg, scene, result.params,
                                            device=args.device)

    i_train = np.asarray(scene.i_train)
    ref = np.asarray(scene.depths)[i_train]
    if float(np.max(ref)) > 0:
        valid = ref > 0
        mse = float(np.mean((priors[i_train][valid] - ref[valid]) ** 2))
        # Only ground truth is called GT; loaded PFM priors are estimates.
        kind = "GT" if scene.depth_is_gt else "existing prior (NOT GT)"
        print(f"prior depth-MSE vs scene {kind} on train views: {mse:.5f}")

    out = args.out or os.path.join(cfg.basedir, cfg.expname, "mvs_priors")
    os.makedirs(out, exist_ok=True)
    for vid in i_train:
        write_pfm(os.path.join(out, f"depth_{vid:04d}.pfm"), priors[vid])
    print(f"wrote {len(i_train)} depth PFMs to {out}")

    if args.with_masks:
        masks = reproject.compute_hard_masks(
            scene.poses, priors, scene.K, i_train, scene.H, scene.W,
            occlusion_threshold=cfg.occlusion_threshold, device=args.device)
        for vid in i_train:
            write_jpeg(os.path.join(out, f"{vid}_mask_mvs.jpg"),
                       (masks[vid] * 255).astype(np.uint8))
        print(f"wrote {len(i_train)} hard masks to {out}")
    return result, priors


if __name__ == "__main__":
    main()
