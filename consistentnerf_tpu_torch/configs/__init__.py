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
    """Everything the vanilla render and train slices read."""

    # --- experiment --------------------------------------------------------
    expname: str = "exp"
    basedir: str = "./logs"
    datadir: str = "./data/nerf_synthetic/lego"
    seed: int = 0
    backbone: str = "vanilla"  # only 'vanilla' is ported

    # --- dataset -----------------------------------------------------------
    dataset_type: str = "blender"  # only 'synthetic' is ported
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
    patch_size: int = 16
    n_patches: int = 4
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
    use_fused_train: bool = False  # kernel train step (vanilla)
    # A TPU lane tile of the JAX package, kept so its config files load;
    # the CUDA kernels choose their own tiles and do not read it.
    fused_tile: int = 256
    fused_kernel: str = "v2"  # only 'v2' is ported
    # One-pass kernel train step (MLP fwd + compositing + loss cotangents
    # + bwd in one launch per level) when use_fused_train is on.
    use_onepass_train: bool = False
    use_onepass_render: bool = False  # not ported (ROADMAP Queue 2)
    use_pdf_kernel: bool = False  # not ported (ROADMAP Queue 2)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' MLP compute

    # --- consistency priors ------------------------------------------------
    hardmask: bool = False
    hardmask_coef: float = 0.2
    softmask: bool = False
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

    # --- optimization ------------------------------------------------------
    total_iters: int = 50000
    lrate: float = 5e-4  # vanilla init lr
    lrate_decay: int = 250  # vanilla: x0.1 every lrate_decay*1000 steps
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
