"""Named scene/experiment presets.

Regenerates the reference's experiment grids as code:

* the PyTorch `configs_3view/6view/16view/{scene}.txt` interface
  (ConsistentNeRF vanilla backbone; settings per `alky/jobs*.sh`:
  `--hardmask --with_depth_loss` is the ConsistentNeRF setting),
* the RegNeRF gin grid `configs/{regnerf3,mipnerf3}/{dtu,llff,nerf}/*.gin`
  (settings transcribed from e.g. `configs/regnerf3/dtu/scan114_3.gin`).

The port of `consistentnerf_tpu/configs/scenes.py`: the same 147
presets, field for field.

Preset names:
  vanilla: `{scene}_{3,6,16}view`  (e.g. `lego_3view`, `fern_3view`)
  mip:     `regnerf3_{dtu_scanN | llff_scene | nerf_scene}`,
           `mipnerf3_...`
"""

from __future__ import annotations

from typing import Dict

from consistentnerf_tpu_torch.configs import Config

BLENDER_SCENES = ["lego", "chair", "ship", "drums", "materials", "ficus",
                  "hotdog", "mic"]
LLFF_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids",
               "room", "trex"]
DTU_SCANS = ["scan21", "scan31", "scan34", "scan38", "scan40", "scan41",
             "scan45", "scan55", "scan63", "scan82", "scan103", "scan110",
             "scan114"]


def _vanilla_base(**kw) -> Config:
    """Shared ConsistentNeRF (PyTorch-backbone) settings
    (run_nerf_view.py config_parser defaults + alky/jobs1.sh flags)."""
    base = dict(
        backbone="vanilla",
        N_rand=4096,
        N_samples=64,
        N_importance=128,
        use_viewdirs=True,
        lrate=5e-4,
        lrate_decay=250,
        total_iters=50000,
        hardmask=True,
        with_depth_loss=True,
        hardmask_coef=0.2,
        occlusion_threshold=0.1,
        grad_max_val=0.1,
        grad_max_norm=0.0,
        n_patches=4,
        patch_size=16,
    )
    base.update(kw)
    return Config(**base)


def _mip_base(variant: str, **kw) -> Config:
    """Shared RegNeRF/mip-NeRF settings (gin grid)."""
    base = dict(
        backbone="mipnerf",
        N_rand=2048 - 4 * 256,  # batch 2048 incl. 4x16x16 patches
        batch_size_random=2048,
        mip_num_samples=96,
        mip_num_levels=2,
        lr_init=2e-3,
        lr_final=2e-5,
        lr_delay_steps=512,
        lr_delay_mult=0.01,
        grad_max_norm=0.1,
        grad_max_val=0.1,
        total_iters=50000,
        density_noise=1.0,
        compute_depth_metrics=True,
        compute_mono_depth_metrics=True,
        use_hardmask=True,
        random_patch_size=8,
    )
    if variant == "regnerf3":
        base.update(
            depth_tvnorm_loss_mult=0.1,
            depth_tvnorm_decay=True,
            depth_tvnorm_maxstep=512,
            depth_tvnorm_loss_mult_start=400.0,
            depth_tvnorm_loss_mult_end=0.1,
            anneal_nearfar=True,
            load_random_rays=True,
        )
    else:  # mipnerf3 baseline: no geometry regularizer
        base.update(load_random_rays=False)
    base.update(kw)
    return Config(**base)


def _build_registry() -> Dict[str, Config]:
    reg: Dict[str, Config] = {}

    for n_views in (3, 6, 16):
        for scene in BLENDER_SCENES:
            reg[f"{scene}_{n_views}view"] = _vanilla_base(
                expname=f"blender_{scene}_{n_views}view",
                datadir=f"data/nerf_synthetic/{scene}",
                dataset_type="blender",
                train_view_num=n_views,
                white_bkgd=True,
                half_res=True,
                near=2.0,
                far=6.0,
            )
        for scene in LLFF_SCENES:
            reg[f"{scene}_{n_views}view"] = _vanilla_base(
                expname=f"llff_{scene}_{n_views}view",
                datadir=f"data/nerf_llff_data/{scene}",
                dataset_type="llff",
                train_view_num=n_views,
                factor=4,
                near=0.0,
                far=1.0,
            )
        for scan in DTU_SCANS:
            reg[f"dtu_{scan}_{n_views}view"] = _vanilla_base(
                expname=f"dtu_{scan}_{n_views}view",
                datadir=f"data/DTU/{scan}",
                dataset_type="dtu",
                train_view_num=n_views,
                no_ndc=True,
            )

    for variant in ("regnerf3", "mipnerf3"):
        for scan in DTU_SCANS:
            reg[f"{variant}_dtu_{scan}"] = _mip_base(
                variant,
                expname=f"{variant}_dtu_{scan.replace('scan', '')}",
                datadir=f"data/DTU/{scan}",
                dataset_type="dtu",
                train_view_num=3,
                white_bkgd=False,
                near=0.5,
                far=3.5,
                factor=2,
                render_factor=2,
                dtu_split_type="masknerf",
                total_iters=43945 if scan == "scan114" else 50000,
                anneal_nearfar_steps=256,
                anneal_nearfar_perc=0.5,
                depth_tvnorm_mask_weight=(
                    1.0 if variant == "regnerf3" else 0.0
                ),
            )
        for scene in LLFF_SCENES:
            reg[f"{variant}_llff_{scene}"] = _mip_base(
                variant,
                expname=f"{variant}_llff_{scene}",
                datadir=f"data/nerf_llff_data/{scene}",
                dataset_type="llff",
                train_view_num=3,
                white_bkgd=False,
                factor=4,
                render_factor=4,
                near=0.0,
                far=1.0,
                ray_shape="cylinder",
                anneal_nearfar_steps=512,
                anneal_nearfar_perc=0.0001,
                anneal_mid_perc=1.0,
            )
        for scene in BLENDER_SCENES:
            reg[f"{variant}_nerf_{scene}"] = _mip_base(
                variant,
                expname=f"{variant}_nerf_{scene}",
                datadir=f"data/nerf_synthetic/{scene}",
                dataset_type="blender",
                train_view_num=3,
                white_bkgd=True,
                near=2.0,
                far=6.0,
                anneal_nearfar_steps=256,
                anneal_nearfar_perc=0.0001,
                anneal_mid_perc=1.0,
            )

    # Dataset-free proof-of-life presets (no real datasets ship in every
    # environment): the capacity-matched procedural scene the round-4
    # hardware runs used (RUNS_r4.md §5). `synthetic_pol` is the flagship
    # vanilla recipe; `synthetic_pol_mip` the regnerf3-style mip recipe.
    reg["synthetic_pol"] = _vanilla_base(
        expname="synthetic_pol",
        dataset_type="synthetic",
        synthetic_views=16,
        synthetic_hw=128,
        synthetic_n_test=4,
        synthetic_interleave_test=True,
        white_bkgd=True,
        compute_dtype="bfloat16",
        total_iters=8000,
    )
    # total_iters MUST equal the intended run length: lr decay and
    # resample-padding schedules stretch over it (a 3k-step run against
    # the 50k default keeps lr at lr_init throughout and diverges —
    # measured, RUNS_r4.md §9). Anneal params follow the regnerf3/nerf
    # grid files (256 steps, perc 1e-4, mid 1.0).
    reg["synthetic_pol_mip"] = _mip_base(
        "regnerf3",
        expname="synthetic_pol_mip",
        dataset_type="synthetic",
        synthetic_views=16,
        synthetic_hw=128,
        synthetic_n_test=4,
        synthetic_interleave_test=True,
        white_bkgd=True,
        disable_normals=True,
        N_rand=3072,
        compute_dtype="bfloat16",
        total_iters=3000,
        anneal_nearfar_steps=256,
        anneal_nearfar_perc=0.0001,
        anneal_mid_perc=1.0,
        # The grid files' lr_init=2e-3 is tuned for 70k+ horizons; at
        # short (<=8k) horizons it holds >1e-3 through the post-anneal
        # window and the trunk collapses (RUNS_r5.md §1b one-axis
        # probes: 2e-3 -> 7.78 PSNR, 1e-3 -> 26.71 at 8k steps).
        lr_init=1e-3,
    )
    return reg


_REGISTRY = None


def registry() -> Dict[str, Config]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


def get_scene_config(name: str) -> Config:
    reg = registry()
    if name not in reg:
        close = [k for k in reg if name in k][:8]
        raise KeyError(
            f"Unknown scene preset {name!r}; close matches: {close}"
        )
    return reg[name]


def list_scenes():
    return sorted(registry())
