"""Render CLI: render the test views (or the render path) of a trained
model (vanilla or mip backbone) and write `color_*.png` / `depth_*.png`
per frame.

    python -m consistentnerf_tpu_torch.cli.render --render-test \
        --set dataset_type=synthetic --set compute_dtype=bfloat16

Weights come from the newest train checkpoint under
`{basedir}/{expname}/checkpoints/` (`step_*.pt`, as the port's train CLI
writes them), else from the newest reference-format `*.tar` under
`{basedir}/{expname}/` (`cnerf-export-torch-ckpt` writes those); --step
picks a step. Without either the model renders from its seeded init, and
says so.
"""

from __future__ import annotations

import glob
import os


def find_checkpoint(exp_dir: str, step=None):
    """The file to restore: a train checkpoint `checkpoints/step_*.pt`
    (the given step, else the newest), else a `.tar`: `{step:06d}.tar`,
    else the newest."""
    from consistentnerf_tpu_torch.train.checkpoints import (
        CheckpointManager, checkpoint_steps)

    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    steps = checkpoint_steps(ckpt_dir) if os.path.isdir(ckpt_dir) else []
    if steps and (step is None or step in steps):
        return CheckpointManager(ckpt_dir).path(
            steps[-1] if step is None else step)
    if step is not None:
        path = os.path.join(exp_dir, f"{step:06d}.tar")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        return path
    tars = sorted(glob.glob(os.path.join(exp_dir, "*.tar")))
    return tars[-1] if tars else None


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Render a camera path from a trained model")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--render-test", action="store_true",
                   help="render test poses instead of the path")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--views-per-call", type=int, default=1,
                   help="views stacked into one render call")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    cfg = common.auto_fused_defaults(cfg, args)
    device = args.device
    exp_dir = os.path.join(cfg.basedir, cfg.expname)

    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train import render as render_lib
    from consistentnerf_tpu_torch.train import vis
    from consistentnerf_tpu_torch.train.evaluation import \
        camera_rays_for_view

    scene = load_scene(cfg, device=args.device)
    model = make_model(cfg, device)
    ckpt = find_checkpoint(exp_dir, args.step)
    if ckpt is None:
        step = 0
        print(f"no checkpoint under {exp_dir}; rendering from a random "
              f"init (seed {cfg.seed})")
    elif ckpt.endswith(".pt"):
        from consistentnerf_tpu_torch.train.checkpoints import \
            CheckpointManager

        step = CheckpointManager(os.path.dirname(ckpt)).restore_for_eval(
            model, int(os.path.basename(ckpt)[5:-3]))
        print(f"restored {ckpt} (step {step})")
    elif cfg.backbone == "mipnerf":
        raise NotImplementedError(
            f"{ckpt}: importing a reference mip-NeRF checkpoint is not "
            "ported yet (ROADMAP Queue 1: import_mipnerf_ckpt)")
    else:
        state, step = interop.load_reference_tar(ckpt)
        model.load_state_dict(state)
        print(f"restored {ckpt} (step {step})")
    model.eval()

    if args.render_test or scene.render_poses is None:
        poses = scene.poses[scene.i_test]
    else:
        poses = scene.render_poses
    tag = "test" if args.render_test else "path"
    out_dir = args.out or os.path.join(exp_dir,
                                       f"renderonly_{tag}_{step:06d}")
    os.makedirs(out_dir, exist_ok=True)

    render = render_lib.build_render_fn(model, cfg)
    g = max(1, min(args.views_per_call, len(poses)))
    for start in range(0, len(poses), g):
        group = poses[start: start + g]
        rays = render_lib.stack_rays(
            [camera_rays_for_view(scene, pp, cfg.render_factor, device)
             for pp in group])
        out = {k: v.cpu().numpy() for k, v in render(rays).items()}
        for j in range(len(group)):
            i = start + j
            vis.save_img_u8(out["rgb"][j],
                            os.path.join(out_dir, f"color_{i:03d}.png"))
            vis.save_img_u8(
                vis.visualize_depth(out["depth"][j], out["acc"][j]),
                os.path.join(out_dir, f"depth_{i:03d}.png"),
            )
            print(f"rendered {i + 1}/{len(poses)}")
    print("wrote", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
