"""The port's config: the fields of `consistentnerf_tpu.configs.Config`,
with the same names and defaults.

Configs load from JSON files, from the reference's experiment files
(`.gin` of the RegNeRF grid, `.txt` of the nerf-pytorch config_parser;
`configs/legacy.py`) and from the named presets (`configs/scenes.py`),
and accept `key=value` override strings (`parse_overrides`). The JAX
package's `llffhold` is left out, since neither package reads it: a file
or an override that names it is skipped with a warning.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass
class Config:
    """Everything the vanilla and mip render and train slices read."""

    # --- experiment --------------------------------------------------------
    expname: str = "exp"
    basedir: str = "./logs"
    datadir: str = "./data/nerf_synthetic/lego"
    depthdir: Optional[str] = None  # MVSNeRF depth PFM dir (auto if None)
    seed: int = 0
    backbone: str = "vanilla"  # 'vanilla' | 'mipnerf'

    # --- dataset -----------------------------------------------------------
    dataset_type: str = "blender"  # blender|llff|dtu|deepvoxels|LINEMOD|synthetic
    train_view_num: int = 3
    testskip: int = 8
    synthetic_interleave_test: bool = True
    synthetic_views: int = 8
    synthetic_hw: int = 64
    synthetic_n_test: int = 2
    synthetic_texture_freq: float = 0.0
    synthetic_layout: str = "sphere"  # 'sphere' | 'cluster'
    factor: int = 8  # LLFF downsample factor
    no_ndc: bool = False
    lindisp: bool = False
    spherify: bool = False
    half_res: bool = False
    white_bkgd: bool = False
    near: float = 2.0
    far: float = 6.0
    dtu_light_cond: int = 3
    dtu_max_images: int = 49
    dtu_split_type: str = "pixelnerf"  # 'pixelnerf' | 'masknerf'
    dtu_mask_path: Optional[str] = None
    shape: str = "greek"  # deepvoxels scene

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
    # The reference's fine-network and embedder flags; neither package
    # reads them (both levels take netdepth / netwidth).
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0
    raw_noise_std: float = 0.0  # density noise of the eager vanilla step
    stable_init: bool = False  # read by neither package
    # TPU knobs of the JAX package that do not change the numbers: the
    # MLP's activation remat and the v2 forward kernel's tile and
    # interleaved streams. Accepted; the CUDA kernels choose their own.
    remat_mlp: bool = False
    fused_fwd_tile: int = 0
    fused_fwd_streams: int = 1
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
    # False: normals in the render and the eager mip step (the fused
    # steps need True, as in the JAX package)
    disable_normals: bool = True
    resample_padding_init: float = 0.01
    resample_padding_final: float = 0.01
    randomized: bool = True
    vis_num_rays: int = 64

    # --- consistency priors ------------------------------------------------
    hardmask: bool = False
    hardmask_coef: float = 0.2
    occlusion_threshold: float = 0.1  # reprojection |depth diff| threshold
    # The depth-prior producers (train/bootstrap.py, `--bootstrap-priors`;
    # the MVS net of models/mvs.py, train/mvs.py, cli/train_mvs.py).
    bootstrap_fuse_priors: bool = True
    bootstrap_fuse_min_consensus: int = 1
    bootstrap_mode: str = "warmup"  # 'warmup' | 'mvs'
    mvs_num_depths: int = 32
    mvs_base_ch: int = 8
    mvs_n_src: int = 2
    mvs_lr: float = 1e-3
    mvs_conf_thresh: float = 0.25
    mvs_photo_weight: float = 1.0
    mvs_smooth_weight: float = 0.05
    mvs_supervise_gt: bool = True
    # Masks of the train views (data/loaders.py::attach_masks, in this
    # order of precedence): canny edges, sobel edges, the precomputed
    # Softmask PNGs (`softmask_K` per cent), the reprojection hard masks.
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
    # The online reprojection loss on a reference view's rays
    # (consistency/online.py; run_nerf_view_test.py).
    ss_loss: bool = False
    ss_loss_mult: float = 1.0
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
    # The reference's logging intervals; neither package reads them.
    i_img: int = 500
    i_weights: int = 10000
    i_testset: int = 50000
    i_video: int = 50000
    checkpoint_every: int = 10000
    checkpoint_keep: int = 100
    # The loop's housekeeping (train/loop.py::train).
    train_render_every: int = 0
    use_tensorboard: bool = True
    profile_steps: int = 0
    profile_dir: Optional[str] = None
    gc_every: int = 10000

    # --- rendering ---------------------------------------------------------
    render_chunk_size: int = 8192
    render_factor: int = 0
    # The reference's render flags; the render CLI takes --render-test.
    render_only: bool = False
    render_test: bool = False
    render_path_frames: int = 120
    num_showcase_images: int = 5

    # --- evaluation --------------------------------------------------------
    eval_only_once: bool = True
    eval_save_output: bool = True
    eval_render_interval: int = 1
    eval_disable_lpips: bool = False
    # Views stacked into one render call during eval; 0: 1 on the CPU,
    # 4 on a card.
    eval_views_per_call: int = 0
    dtu_no_mask_eval: bool = False

    # --- parallelism -------------------------------------------------------
    # Data parallelism over torch.distributed (parallel/mesh.py): one
    # process per GPU. num_processes > 1 joins the group of rank
    # process_id at coordinator_address ("host:port" of rank 0);
    # mesh_shape (default: every rank on the "data" axis) must hold the
    # world size, and its other axes replicate the batch.
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axis_names: Tuple[str, ...] = ("data",)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


_FIELDS = {f.name: f for f in dataclasses.fields(Config)}
# Fields of the JAX Config that nothing reads, left out of the port's:
# a file or an override naming one is skipped with a warning.
UNREAD = frozenset({"llffhold"})


def skip_unread(updates: dict, source: str) -> dict:
    """`updates` without the UNREAD fields, warning for each it names."""
    for name in sorted(UNREAD & set(updates)):
        warnings.warn(f"{source}: skipping {name!r}, which nothing reads",
                      stacklevel=3)
    return {k: v for k, v in updates.items() if k not in UNREAD}


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
        k = k.strip()
        updates[k] = v if k in UNREAD else _coerce(k, v.strip())
    return cfg.replace(**skip_unread(updates, "--set"))


def load_config(
    path: Optional[str] = None, overrides: Sequence[str] = ()
) -> Config:
    cfg = Config()
    if path:
        if path.endswith((".gin", ".txt")):
            # Reference experiment files (RegNeRF gin grid /
            # nerf-pytorch configargparse) load directly.
            from consistentnerf_tpu_torch.configs import legacy

            cfg = legacy.load_reference_config(path)
        else:
            with open(path) as f:
                data = skip_unread(json.load(f), path)
            unknown = set(data) - set(_FIELDS)
            if unknown:
                raise KeyError(
                    f"Unknown config fields in {path}: {sorted(unknown)}"
                )
            cfg = cfg.replace(**data)
    return parse_overrides(cfg, overrides)


def config_file_keys(path: str) -> set:
    """Field names a config file sets explicitly (any supported format)."""
    if path.endswith((".gin", ".txt")):
        from consistentnerf_tpu_torch.configs import legacy

        return legacy.reference_config_keys(path)
    with open(path) as f:
        return set(json.load(f))
