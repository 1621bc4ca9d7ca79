"""Render CLI: render the test views (or the render path) of a trained
model (vanilla or mip backbone) and write `color_*.png` / `depth_*.png`
per frame.

    python -m consistentnerf_tpu_torch.cli.render --render-test \
        --set dataset_type=synthetic --set compute_dtype=bfloat16

Weights come from the newest train checkpoint under
`{basedir}/{expname}/checkpoints/` (`step_*.pt`, as the port's train CLI
writes them), else from the newest reference-format `*.tar` under
`{basedir}/{expname}/` (`cnerf-export-torch-ckpt` writes those; vanilla
only: a mip experiment takes a train checkpoint, which
`cli/import_mipnerf_ckpt.py` writes from a pretrained flax checkpoint);
--step picks a step. Without either the model renders from its seeded init, and
says so.
"""

from __future__ import annotations

import glob
import os

# Fixed per-scene depth-visualization ranges, for renders comparable
# across settings (RegNeRF/render.py:47-73).
LLFF_DEPTH_RANGES = {
    "fern": [0.059100067913532256, 0.8538959634304046],
    "flower": [0.2099738734960556, 0.996519325375557],
    "fortress": [0.3405687987804413, 0.8795422136783599],
    "horns": [0.3501826047897339, 0.9596474349498749],
    "leaves": [0.00022197533398866584, 0.9934533953666687],
    "orchids": [0.23377860009670257, 0.9828365403413772],
    "room": [0.4059941208362579, 0.9502887094020843],
    "trex": [0.016071857213974, 0.9458529788255692],
}
DTU_DEPTH_RANGES = {
    "scan8": [0.9593777, 1.5342957],
    "scan21": [0.98255014, 1.7484968],
    "scan30": [1.1381109, 1.6074754],
    "scan31": [1.0627427, 1.6069319],
    "scan34": [1.1172018, 1.5005568],
    "scan38": [1.0385504, 1.5373354],
    "scan40": [0.8312144, 1.62111],
    "scan41": [0.9469194, 1.5374442],
    "scan45": [1.0098513, 1.5830635],
    "scan55": [0.85020584, 1.513227],
    "scan63": [1.1894969, 1.7325872],
    "scan82": [1.0984676, 1.7162027],
    "scan103": [1.0771852, 1.5858444],
    "scan110": [0.96143025, 1.5147997],
    "scan114": [0.96940583, 1.548706],
}


def scene_depth_range(cfg):
    """The fixed depth range of an LLFF or DTU scene, else None."""
    name = os.path.basename(os.path.normpath(cfg.datadir))
    if cfg.dataset_type == "llff":
        return LLFF_DEPTH_RANGES.get(name)
    if cfg.dataset_type == "dtu":
        return DTU_DEPTH_RANGES.get(name)
    return None


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
        raise ValueError(
            f"{ckpt}: a .tar holds a vanilla nerf-pytorch network; import a "
            "pretrained mip-NeRF checkpoint into this experiment with "
            "cli/import_mipnerf_ckpt.py")
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
    # The fixed ranges are on disparity (1 / depth), as visualize_depth's
    # lo / hi are.
    lo, hi = scene_depth_range(cfg) or (None, None)
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
                vis.visualize_depth(out["depth"][j], out["acc"][j], lo=lo,
                                    hi=hi),
                os.path.join(out_dir, f"depth_{i:03d}.png"),
            )
            print(f"rendered {i + 1}/{len(poses)}")
    print("wrote", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
