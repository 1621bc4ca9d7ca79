"""Train CLI of both backbones:

    python -m consistentnerf_tpu_torch.cli.train \
        --set dataset_type=synthetic --set compute_dtype=bfloat16
    python -m consistentnerf_tpu_torch.cli.train --set backbone=mipnerf \
        --set dataset_type=synthetic --set compute_dtype=bfloat16

Loads the scene, trains with checkpoints under
`{basedir}/{expname}/checkpoints/` and resumes from the newest one. On a
CUDA device the kernel step is on unless use_fused_train /
use_onepass_train are set explicitly; `--device cpu` runs the same step
with the kernels' plain versions.
"""

from __future__ import annotations


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Train a ConsistentNeRF model (PyTorch port)")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--eval-after", action="store_true",
                   help="not ported yet (ROADMAP Queue 1: eval metrics)")
    p.add_argument("--bootstrap-priors", type=int, default=0,
                   metavar="WARMUP_STEPS",
                   help="not ported yet (ROADMAP Queue 1: depth-prior "
                   "producers)")
    args = p.parse_args(argv)
    if args.bootstrap_priors > 0:
        raise NotImplementedError(
            "--bootstrap-priors is not ported yet (ROADMAP Queue 1: "
            "depth-prior producers)")
    if args.eval_after:
        raise NotImplementedError(
            "--eval-after is not ported yet (ROADMAP Queue 1: eval metrics)")
    cfg = common.resolve_config(args)
    cfg = common.auto_fused_defaults(cfg, args)
    cfg = common.reconcile_schedule_horizon(cfg, args)
    exp_dir = common.setup_experiment_dir(cfg)

    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.train import loop as loop_lib

    scene = load_scene(cfg, device=args.device)
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
    return result


if __name__ == "__main__":
    main()
