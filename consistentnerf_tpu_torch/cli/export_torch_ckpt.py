"""Export a train checkpoint of this package as a reference
(nerf-pytorch) `.tar`:

    python -m consistentnerf_tpu_torch.cli.export_torch_ckpt out.tar \
        --scene lego_3view [--step N]

The inverse of `cli/import_torch_ckpt.py`, and the file the JAX
package's `export_torch_ckpt` writes: the `{step:06d}.tar` layout of
`run_nerf_view.py:2001-2016`,

    {'global_step', 'network_fn_state_dict' (COARSE),
     'network_fine_state_dict' (fine), 'optimizer_state_dict'}

with the reference's layer names (this package's own) and fp32 tensors.
The reference never restores `optimizer_state_dict` (its load at
`run_nerf_view.py:351` is commented out), so a fresh-optimizer
placeholder is written for the dict's shape. No checkpoint under
`{basedir}/{expname}/checkpoints/` is an error: random-init weights are
not exported.
"""

from __future__ import annotations

import os

from consistentnerf_tpu_torch.interop import TAR_LEVELS


def reference_tar_dict(state_dict, step: int) -> dict:
    """A VanillaNeRF state_dict -> the reference `.tar`'s dict."""
    ckpt = {"global_step": int(step),
            "optimizer_state_dict": {"state": {}, "param_groups": []}}
    for key, level in TAR_LEVELS.items():
        prefix = level + "."
        sub = {k[len(prefix):]: v.detach().float().cpu().clone()
               for k, v in state_dict.items() if k.startswith(prefix)}
        if sub:
            ckpt[key] = sub
    return ckpt


def export_checkpoint(cfg, out_tar: str, step=None) -> int:
    """Write the checkpoint of `step` (default: the newest) under
    {basedir}/{expname}/checkpoints as a reference `.tar`; returns its
    step."""
    import torch

    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager

    if cfg.backbone != "vanilla":
        raise ValueError("reference .tar export is for the vanilla "
                         "(nerf-pytorch) backbone; mip checkpoints have no "
                         "torch counterpart format")
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    if step is None and mgr.latest_step() is None:
        raise SystemExit(f"no checkpoint found under {exp_dir}/checkpoints "
                         "— refusing to export random-init weights")
    model = make_model(cfg, "cpu")
    step = mgr.restore_for_eval(model, step)
    torch.save(reference_tar_dict(model.state_dict(), step), out_tar)
    return step


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Export a checkpoint as a reference .tar")
    p.add_argument("out_tar", help="output .tar path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the newest)")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    step = export_checkpoint(cfg, args.out_tar, args.step)
    print(f"exported step {step} -> {args.out_tar}")
    return step


if __name__ == "__main__":
    main()
