"""Train CLI of both backbones:

    python -m consistentnerf_tpu_torch.cli.train \
        --set dataset_type=synthetic --set compute_dtype=bfloat16
    python -m consistentnerf_tpu_torch.cli.train --set backbone=mipnerf \
        --set dataset_type=synthetic --set compute_dtype=bfloat16

Loads the scene, trains with checkpoints under
`{basedir}/{expname}/checkpoints/` and resumes from the newest one. On a
CUDA device the kernel step is on unless use_fused_train /
use_onepass_train are set explicitly; `--device cpu` runs the same step
with the kernels' plain versions. `--eval-after` scores the test views
when training ends (`train/evaluation.py::evaluate`, artifacts under
`{basedir}/{expname}/test_preds/`). `--bootstrap-priors N` first makes the
scene's depth priors and hard masks in-framework (`train/bootstrap.py`:
an N-step warmup NeRF or MVS net, `cfg.bootstrap_mode`) and trains on
them.
"""

from __future__ import annotations

import os


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Train a ConsistentNeRF model (PyTorch port)")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--eval-after", action="store_true",
                   help="run the test-set eval when training finishes")
    p.add_argument(
        "--bootstrap-priors", type=int, default=0, metavar="WARMUP_STEPS",
        help="two-stage flow: a producer (cfg.bootstrap_mode: a warmup NeRF "
        "with no consistency terms, or the MVS net) for N steps, per-view "
        "depth priors, fused, hard masks from them, then the consistent "
        "training on those priors; the priors are written under "
        "<expdir>/bootstrap_priors")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    cfg = common.auto_fused_defaults(cfg, args)
    cfg = common.reconcile_schedule_horizon(cfg, args)
    exp_dir = common.setup_experiment_dir(cfg)

    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.train import loop as loop_lib

    scene = load_scene(cfg, device=args.device)
    if args.bootstrap_priors > 0:
        from consistentnerf_tpu_torch.train.bootstrap import \
            bootstrap_scene_priors

        scene, _ = bootstrap_scene_priors(
            cfg, scene, args.bootstrap_priors,
            export_dir=os.path.join(exp_dir, "bootstrap_priors"),
            device=args.device)
    random_poses = None
    if cfg.backbone == "mipnerf" and cfg.load_random_rays:
        from consistentnerf_tpu_torch.data.random_poses import \
            generate_random_poses

        random_poses = generate_random_poses(
            scene.poses[scene.i_train], n_poses=cfg.n_random_poses,
            pose_type=cfg.random_pose_type, radius=cfg.random_pose_radius,
            focusptjitter=cfg.random_pose_focusptjitter,
            add_test_poses=cfg.random_pose_add_test_poses,
            test_poses=scene.poses[scene.i_test])
    result = loop_lib.train(cfg, scene, num_steps=args.num_steps,
                            device=args.device, random_poses=random_poses)
    print(f"done: {result.rays_per_sec:,.0f} rays/sec ({exp_dir})")
    if args.eval_after:
        from consistentnerf_tpu_torch.train.evaluation import evaluate

        model = result.state.model.eval()
        result.metrics = evaluate(model, cfg, scene,
                                  out_dir=os.path.join(exp_dir, "test_preds"),
                                  step=int(result.state.step))
        print("test metrics:", result.metrics)
    return result


if __name__ == "__main__":
    main()
