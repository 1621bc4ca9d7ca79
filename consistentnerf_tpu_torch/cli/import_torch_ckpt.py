"""Import a reference (nerf-pytorch) `.tar` checkpoint as a train
checkpoint of this package:

    python -m consistentnerf_tpu_torch.cli.import_torch_ckpt ckpt.tar \
        --scene lego_3view

The `{step:06d}.tar` of the reference trainer (`run_nerf_view.py:
2001-2016`), or of either package's `export_torch_ckpt`, holds
`network_fn_state_dict` (the COARSE model) and `network_fine_state_dict`
with the reference's layer names, which are this package's (torch [out,
in] weights, the temperature scalars). They load strictly into the
configured `VanillaNeRF` (`interop.load_reference_tar`), which checks
every name and shape, and are written with a fresh optimizer at the tar's
step to `{basedir}/{expname}/checkpoints/`, where `cli/train.py` resumes
and `cli/eval.py` / `cli/render.py` restore them.
"""

from __future__ import annotations

import os


def import_checkpoint(tar_path: str, cfg, device="cuda"):
    """A reference `.tar` -> a `TrainState` of `cfg` at the tar's step,
    its optimizer fresh, on `device` (`cuda` unless the caller asks for
    the CPU)."""
    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train.state import create_train_state

    if cfg.backbone != "vanilla":
        raise ValueError("a reference .tar holds the vanilla (nerf-pytorch) "
                         "backbone; import a mip-NeRF checkpoint with "
                         "cli/import_mipnerf_ckpt.py")
    sd, step = interop.load_reference_tar(tar_path)
    model = make_model(cfg, device)
    model.load_state_dict(sd)
    state = create_train_state(cfg, model)
    state.step = step
    return state


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager

    p = common.make_parser("Import a reference .tar checkpoint")
    p.add_argument("tar", help="reference .tar checkpoint")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    exp_dir = common.setup_experiment_dir(cfg)
    state = import_checkpoint(args.tar, cfg, args.device)
    path = CheckpointManager(os.path.join(exp_dir, "checkpoints")).save(
        state.step, state)
    print(f"imported step {state.step} -> {path}")
    return path


if __name__ == "__main__":
    main()
