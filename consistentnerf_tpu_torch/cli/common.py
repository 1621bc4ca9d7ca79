"""Shared CLI plumbing: config flags, device choice, the schedule horizon,
fused-path defaults, the experiment directory."""

from __future__ import annotations

import argparse
import os
import warnings

import torch

from consistentnerf_tpu_torch.configs import (Config, config_file_keys,
                                              load_config, parse_overrides)
from consistentnerf_tpu_torch.ops import fused_mlp as fm


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", type=str, default=None,
                   help="config file: JSON, or a reference experiment "
                        "file (.gin from the RegNeRF grid, .txt from the "
                        "nerf-pytorch config_parser)")
    p.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override (repeatable), e.g. --set N_samples=32",
    )
    p.add_argument("--scene", type=str, default=None,
                   help="named scene preset from configs.scenes (--config "
                        "is then ignored)")
    p.add_argument("--list-scenes", action="store_true",
                   help="list scene presets and exit")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def resolve_config(args) -> Config:
    """The run's config, as the JAX package resolves it: `--list-scenes`
    prints the presets and exits; `--scene` takes a preset and then the
    `--set` overrides (a `--config` beside it is ignored); otherwise the
    config file, then the overrides. With `num_processes > 1` the process
    joins its group (`parallel/mesh.py::maybe_initialize_distributed`,
    from every entry point as in the JAX package), and a bare `cuda`
    `--device` becomes this rank's card."""
    if getattr(args, "list_scenes", False):
        from consistentnerf_tpu_torch.configs import scenes

        for name in scenes.list_scenes():
            print(name)
        raise SystemExit(0)
    if getattr(args, "scene", None):
        from consistentnerf_tpu_torch.configs import scenes

        cfg = parse_overrides(scenes.get_scene_config(args.scene),
                              args.overrides)
    else:
        cfg = load_config(args.config, args.overrides)
    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    device = getattr(args, "device", "cuda")
    if mesh_lib.maybe_initialize_distributed(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id,
            device=device) and hasattr(args, "device"):
        args.device = str(mesh_lib.rank_device(device))
    return cfg


def explicit_keys(args) -> set:
    """Config keys the user set via --set or a config file (a reference
    file's seeded defaults count as set). A scene preset's values are
    recipe defaults, not the user's intent, so they are not counted: a
    preset value can be reconciled, an explicit one is always kept."""
    explicit = {o.split("=")[0].strip()
                for o in getattr(args, "overrides", [])}
    if getattr(args, "config", None):
        explicit |= config_file_keys(args.config)
    return explicit


def reconcile_schedule_horizon(cfg: Config, args) -> Config:
    """Keep `--num-steps` and the schedule horizon `total_iters` coherent
    (the JAX package's cli/common.py::reconcile_schedule_horizon).

    `--num-steps N` with `total_iters` not set explicitly (--set or a
    config file): the horizon follows N, and `anneal_nearfar_steps` and
    `lr_delay_steps`, where not explicit either, rescale in proportion so
    the recipe keeps its shape. With both explicit and N below 0.2 of the
    horizon while a schedule is active: a warning (a resumed longer run
    may mean it), nothing changed."""
    num_steps = getattr(args, "num_steps", None)
    if not num_steps or num_steps == cfg.total_iters:
        return cfg
    explicit = explicit_keys(args)
    if "total_iters" not in explicit:
        old = cfg.total_iters
        updates = {"total_iters": int(num_steps)}
        for key in ("anneal_nearfar_steps", "lr_delay_steps"):
            if key not in explicit:
                val = getattr(cfg, key)
                if 0 < val:
                    updates[key] = max(1, round(val * num_steps / old))
        print(
            f"[schedule] --num-steps={num_steps} != total_iters={old}; "
            f"rescaling schedule horizon: "
            + ", ".join(f"{k}={v}" for k, v in updates.items())
            + " (pass --set total_iters=... to pin the horizon explicitly)"
        )
        return cfg.replace(**updates)
    schedules_active = (cfg.lr_final != cfg.lr_init) or cfg.anneal_nearfar
    if schedules_active and num_steps < 0.2 * cfg.total_iters:
        lr_end = cfg.lr_init * (cfg.lr_final / cfg.lr_init) ** (
            num_steps / cfg.total_iters)
        warnings.warn(
            f"--num-steps={num_steps} is <20% of the explicit schedule "
            f"horizon total_iters={cfg.total_iters}: lr will only decay "
            f"{cfg.lr_init:g}->~{lr_end:.2g} and "
            f"anneal_nearfar={cfg.anneal_nearfar} runs on the long horizon. "
            "Intended only when resuming a longer run.", stacklevel=2)
    return cfg


def auto_fused_defaults(cfg: Config, args) -> Config:
    """The JAX package's rule for accelerators (cli/common.py:146-197), on
    a CUDA device: a vanilla or mip config trains through the kernel step
    (`use_fused_train` and `use_onepass_train`) unless those were set
    explicitly, and a bfloat16 one renders through the fused kernels
    unless `use_fused_render` was. fp32 renders stay on the plain path,
    the reference-parity default.

    The predicates are the JAX package's term for term: vanilla with view
    directions and 3*multires, 3*multires_views <= 60; mip with
    stop_level_grad, min_deg_point 0 and 3*max_deg_point <= 60 (the train
    step also disable_normals). One term is the port's own: its kernels
    take widths that are multiples of 32 (`fused_mlp_v2.pack`), so a
    config of another width keeps the plain paths."""
    vanilla_ok = (
        cfg.backbone == "vanilla"
        and cfg.use_viewdirs
        and 3 * cfg.multires <= 60
        and 3 * cfg.multires_views <= 60
    )
    mip_render_ok = (
        cfg.backbone == "mipnerf"
        and cfg.stop_level_grad
        and cfg.min_deg_point == 0
        and 3 * cfg.max_deg_point <= 60
    )
    # The train step also needs disable_normals (the normals forward has
    # no backward); the render computes the normals in kernel 6n.
    mip_ok = mip_render_ok and cfg.disable_normals
    width_ok = cfg.netwidth % 32 == 0  # the port's own term
    if (torch.device(args.device).type != "cuda" or not width_ok
            or not (vanilla_ok or mip_render_ok)):
        return cfg
    explicit = explicit_keys(args)
    updates = {}
    if ("use_fused_train" not in explicit and not cfg.use_fused_train
            and (vanilla_ok or mip_ok)):
        updates["use_fused_train"] = True
        if "fused_tile" not in explicit:
            updates["fused_tile"] = 1024
    if ("use_onepass_train" not in explicit and not cfg.use_onepass_train
            and (cfg.use_fused_train or "use_fused_train" in updates)):
        updates["use_onepass_train"] = True
    if ("use_fused_render" not in explicit and not cfg.use_fused_render
            and fm.as_dtype(cfg.compute_dtype) == torch.bfloat16):
        updates["use_fused_render"] = True
        if "fused_tile" not in explicit and "fused_tile" not in updates:
            updates["fused_tile"] = 1024
    return cfg.replace(**updates) if updates else cfg


def setup_experiment_dir(cfg: Config) -> str:
    """Create basedir/expname and dump the resolved config as JSON (the
    reference dumps args.txt + config.txt, run_nerf_view.py:977-989)."""
    exp_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(exp_dir, exist_ok=True)
    cfg.save(os.path.join(exp_dir, "config.json"))
    return exp_dir
