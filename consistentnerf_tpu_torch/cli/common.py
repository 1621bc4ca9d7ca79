"""Shared CLI plumbing: config flags, device choice, fused-path defaults,
the experiment directory."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from consistentnerf_tpu_torch.configs import (Config, config_file_keys,
                                              load_config)
from consistentnerf_tpu_torch.ops import fused_mlp as fm


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None,
                   help="config file (JSON)")
    p.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override (repeatable), e.g. --set N_samples=32",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def resolve_config(args) -> Config:
    return load_config(args.config, args.overrides)


def explicit_keys(args) -> set:
    """Config keys the user set via --set or a config file."""
    explicit = {o.split("=")[0].strip() for o in args.overrides}
    if getattr(args, "config", None):
        explicit |= config_file_keys(args.config)
    return explicit


def auto_fused_defaults(cfg: Config, args) -> Config:
    """The JAX package's rule for accelerators (cli/common.py:168-197), on
    a CUDA device: a vanilla or mip config trains through the kernel step
    (`use_fused_train` and `use_onepass_train`) unless those were set
    explicitly, and a bfloat16 one renders through the fused kernels
    unless `use_fused_render` was. fp32 renders stay on the plain path,
    the reference-parity default."""
    vanilla_ok = (
        cfg.backbone == "vanilla"
        and cfg.use_viewdirs
        and cfg.netwidth % 32 == 0
    )
    mip_render_ok = (
        cfg.backbone == "mipnerf"
        and cfg.stop_level_grad
        and cfg.min_deg_point == 0
        and cfg.netwidth % 32 == 0
    )
    # The train step also needs disable_normals (the normals forward has
    # no backward).
    mip_ok = mip_render_ok and cfg.disable_normals
    if (torch.device(args.device).type != "cuda"
            or not (vanilla_ok or mip_render_ok)):
        return cfg
    explicit = explicit_keys(args)
    updates = {}
    if ("use_fused_train" not in explicit and not cfg.use_fused_train
            and (vanilla_ok or mip_ok)):
        updates["use_fused_train"] = True
    if ("use_onepass_train" not in explicit and not cfg.use_onepass_train
            and (cfg.use_fused_train or "use_fused_train" in updates)):
        updates["use_onepass_train"] = True
    if ("use_fused_render" not in explicit and not cfg.use_fused_render
            and fm.as_dtype(cfg.compute_dtype) == torch.bfloat16):
        updates["use_fused_render"] = True
    return cfg.replace(**updates) if updates else cfg


def setup_experiment_dir(cfg: Config) -> str:
    """Create basedir/expname and dump the resolved config as JSON (the
    reference dumps args.txt + config.txt, run_nerf_view.py:977-989)."""
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    return exp_dir
