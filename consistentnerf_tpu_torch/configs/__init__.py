"""The port's config: the fields of `consistentnerf_tpu.configs.Config`
that the ported slice reads, with the same names and defaults.

Configs load from JSON files and accept `key=value` override strings
(`parse_overrides`). The named scene presets and the reference's
`.gin` / `.txt` experiment files are not ported yet (ROADMAP Queue 1:
configs).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class Config:
    """Everything the vanilla and mip render and train slices read."""

    # --- experiment --------------------------------------------------------
    expname: str = "exp"
    basedir: str = "./logs"
    datadir: str = "./data/nerf_synthetic/lego"
    seed: int = 0
    backbone: str = "vanilla"  # 'vanilla' | 'mipnerf'

    # --- dataset -----------------------------------------------------------
    dataset_type: str = "blender"  # only 'synthetic' is ported
    train_view_num: int = 3  # names the hard-mask cache file
    synthetic_interleave_test: bool = True
    synthetic_views: int = 8
    synthetic_hw: int = 64
    synthetic_n_test: int = 2
    synthetic_texture_freq: float = 0.0
    synthetic_layout: str = "sphere"  # 'sphere' | 'cluster'
    lindisp: bool = False
    white_bkgd: bool = False
    near: float = 2.0
    far: float = 6.0

    # --- batching ----------------------------------------------------------
    N_rand: int = 4096  # random rays per step (excl. patch rays)
    batching: str = "single_image_patch"  # all_images|single_image|single_image_patch
    patch_size: int = 16
    n_patches: int = 4
    batch_size_random: int = 2048  # random-pose rays (mip/RegNeRF TV loss)
    random_patch_size: int = 8  # RegNeRF random-patch size
    load_random_rays: bool = False  # mip: random-pose rays for the TV norm
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    use_batching: bool = False  # vanilla-nerf "use_batching" mode

    # --- vanilla model -----------------------------------------------------
    netdepth: int = 8
    netwidth: int = 256
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0  # not ported (ROADMAP Queue 1: raw noise)
    use_fused_render: bool = False  # fused-MLP kernel for rendering
    use_fused_train: bool = False  # kernel train step
    # A TPU lane tile of the JAX package, kept so its config files load;
    # the CUDA kernels choose their own tiles and do not read it.
    fused_tile: int = 256
    # The two-call step's fused MLP (and the fused render's forward):
    # 'v2' transposed streams (#1/#2), 'v2row' row-major (#10/#11), 'v2h'
    # the plain forward + #11 (the render: #1), 'v1' the v1 kernels (#13
    # forward, #14 weight grads; the render: #12), 'hybrid' the plain
    # forward + #14 (the render: #12).
    fused_kernel: str = "v2"
    # One-pass kernel train step (MLP fwd + compositing + loss cotangents
    # + bwd in one launch per level) when use_fused_train is on.
    use_onepass_train: bool = False
    # In-kernel compositing for the render (one forward kernel per level,
    # #4) when use_fused_render is on.
    use_onepass_render: bool = False
    # The fused resampling kernels (#8 vanilla fine level, #9 mip level)
    # on the fused and one-pass paths; sample_pdf + sort otherwise.
    use_pdf_kernel: bool = False
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' MLP compute

    # --- mip model ---------------------------------------------------------
    mip_num_samples: int = 96
    mip_num_levels: int = 2
    stop_level_grad: bool = True
    genspace_fn: Optional[str] = None  # None/linear|log|reciprocal
    ray_shape: str = "cone"
    disable_integration: bool = False
    single_jitter: bool = False
    min_deg_point: int = 0
    max_deg_point: int = 16
    deg_view: int = 4
    density_noise: float = 0.0
    rgb_padding: float = 0.001
    # False: the render's normals (the steps refuse it: Queue 1, mip normals)
    disable_normals: bool = True
    resample_padding_init: float = 0.01
    resample_padding_final: float = 0.01
    randomized: bool = True
    vis_num_rays: int = 64

    # --- consistency priors ------------------------------------------------
    hardmask: bool = False
    hardmask_coef: float = 0.2
    occlusion_threshold: float = 0.1  # reprojection |depth diff| threshold
    # The softmask PNGs and the edge masks are not ported yet (ROADMAP
    # Queue 1: consistency); load_scene raises for them.
    softmask: bool = False
    softmask_K: int = 30
    use_canny_edge_detection: bool = False
    use_sobel_edge_detection: bool = False
    softLpmask: bool = False
    Lp_coef: float = 2.0
    with_depth_loss: bool = False
    with_depth_norm: bool = False
    use_test_pseudo_label: bool = False
    use_noise: bool = False
    ss_loss: bool = False  # not ported (ROADMAP Queue 1: consistency)
    temp_start: float = 1.0
    temp_end: float = 1.0
    mono_depth_loss_mult: float = 0.001
    patch_ssim_loss_mult: float = 0.005
    patch_lpips_loss_mult: float = 0.005
    lpips_weights_path: Optional[str] = None

    # --- RegNeRF losses ----------------------------------------------------
    compute_depth_metrics: bool = False
    compute_mono_depth_metrics: bool = True
    compute_disp_metrics: bool = False
    compute_normal_metrics: bool = False
    use_hardmask: bool = True
    use_nerf_depth: bool = False
    coarse_loss_mult: float = 0.1
    weight_decay_mult: float = 0.0
    disable_multiscale_loss: bool = False
    # The RegNeRF TV norm on random-pose patches and the near/far
    # annealing (the regnerf3 settings of the JAX configs/scenes.py).
    depth_tvnorm_loss_mult: float = 0.0
    depth_tvnorm_selector: str = "distance_mean_save"
    depth_tvnorm_decay: bool = False
    depth_tvnorm_maxstep: int = 0
    depth_tvnorm_loss_mult_start: float = 0.0
    depth_tvnorm_loss_mult_end: float = 0.0
    depth_tvnorm_mask_weight: float = 0.0
    depth_tvnorm_type: str = "l2"
    anneal_nearfar: bool = False
    anneal_nearfar_steps: int = 2000
    anneal_nearfar_perc: float = 0.2
    anneal_mid_perc: float = 0.5
    random_pose_type: str = "renderpath"
    random_pose_focusptjitter: bool = True
    random_pose_radius: float = 1.0
    random_pose_add_test_poses: bool = False
    n_random_poses: int = 1000

    # --- optimization ------------------------------------------------------
    total_iters: int = 50000
    lrate: float = 5e-4  # vanilla init lr
    lrate_decay: int = 250  # vanilla: x0.1 every lrate_decay*1000 steps
    lr_init: float = 2e-3  # mip init lr
    lr_final: float = 2e-5
    lr_delay_steps: int = 512
    lr_delay_mult: float = 0.01
    grad_max_val: float = 0.1  # value clip (0 = off)
    grad_max_norm: float = 0.0  # norm clip (0 = off)
    check_grad_for_nans: bool = True
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8

    # --- logging / checkpointing -------------------------------------------
    i_print: int = 100
    checkpoint_every: int = 10000
    checkpoint_keep: int = 100

    # --- rendering ---------------------------------------------------------
    render_chunk_size: int = 8192
    render_factor: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}


def _coerce(name: str, value: str) -> Any:
    """Coerce a string override to the field's type."""
    if name not in _FIELDS:
        raise KeyError(f"Unknown config field {name!r}")
    if value in ("None", "null"):
        return None
    # Python-style booleans in any casing: the JSON fallthrough would
    # otherwise return the truthy string "False".
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value  # plain string


def parse_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply 'key=value' override strings."""
    updates = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must look like key=value")
        k, v = item.split("=", 1)
        updates[k.strip()] = _coerce(k.strip(), v.strip())
    return cfg.replace(**updates)


def load_config(
    path: Optional[str] = None, overrides: Sequence[str] = ()
) -> Config:
    cfg = Config()
    if path:
        if path.endswith((".gin", ".txt")):
            raise NotImplementedError(
                "reference experiment files are not ported yet "
                "(ROADMAP Queue 1: configs)"
            )
        with open(path) as f:
            data = json.load(f)
        unknown = set(data) - set(_FIELDS)
        if unknown:
            raise KeyError(
                f"Unknown config fields in {path}: {sorted(unknown)}"
            )
        cfg = cfg.replace(**data)
    return parse_overrides(cfg, overrides)


def config_file_keys(path: str) -> set:
    """Field names a JSON config file sets explicitly."""
    with open(path) as f:
        return set(json.load(f))
