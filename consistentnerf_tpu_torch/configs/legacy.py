"""Ingest the reference's experiment files directly.

A user switching from skhu101/ConsistentNeRF carries two kinds of
experiment files, and both load here unchanged via ``--config``:

* RegNeRF gin files (``RegNeRF/configs/**/**.gin``, consumed by gin in
  the reference, `RegNeRF/internal/configs.py:153-168`): lines of
  ``Scope.key = <python literal>`` bindings against the reference's
  ``Config`` / ``MLP`` / ``MipNerfModel`` scopes.
* nerf-pytorch configargparse files (the ``--config`` flag of
  `run_nerf_view.py:672-808` / `run_nerf.py:424`): ``key = value``
  lines with unquoted strings.

Both are translated onto the native :class:`Config`. Key differences
handled here rather than by the caller:

* gin splits the data path into ``data_dir`` + a per-dataset scene key
  (``dtu_scan`` / ``llff_scan`` / ``blender_scene``, joined at
  `RegNeRF/internal/datasets.py:462-469`); the native config carries
  one ``datadir``. DTU additionally drops a trailing ``Rectified``
  component: the native DTU loader takes ``{root}/{scan}`` with the
  ``Rectified/`` tree *under* root (`data/dtu.py`).
* ``checkpoint_dir`` maps to ``basedir`` + ``expname``.
* ``Config.batch_size`` is decorative in the reference's
  ``single_image_patch`` mode — the batch is hardcoded to 4 16x16
  patches + 1024 random rays (`RegNeRF/internal/datasets.py:636-654`)
  — so it is ignored and the composition fields are seeded instead.
* Reference keys that exist but are consumed nowhere in the reference
  (``flow_loss_mult``, `RegNeRF/internal/configs.py:119`;
  ``use_flow_depth`` is not even defined) are collected into the
  returned ``ignored`` list, not errors.

This is the port of `consistentnerf_tpu/configs/legacy.py`, which gives
the same Config field for field. The one difference: a field that only
the JAX Config has (`configs.UNREAD`, e.g. the configargparse
``llffhold``) is skipped with a warning naming it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Tuple

from consistentnerf_tpu_torch.configs import UNREAD, Config, skip_unread

_FIELDS = {f.name: f for f in dataclasses.fields(Config)}

# --- gin (RegNeRF backbone) -------------------------------------------------

# Reference-name -> native-name, where they differ.
_GIN_RENAME = {
    "white_background": "white_bkgd",
    "dataset_loader": "dataset_type",
    "n_input_views": "train_view_num",
    "max_steps": "total_iters",
    "print_every": "i_print",
}

# Defined by the reference but consumed nowhere in it, or subsumed by a
# hardcoded reference behavior that the native config expresses directly.
_GIN_IGNORED = {
    "flow_loss_mult",  # defined (configs.py:119) but never read
    "use_flow_depth",  # not even defined in the reference Config
    "batch_size",  # hardcoded patch composition, see module docstring
    "near_origin",  # DTU origin adjustment, never set by the grid
}

# RegNeRF defaults that differ from the native Config() defaults, so a
# gin file that omits them still reproduces the reference behavior
# (`RegNeRF/internal/configs.py` lines noted inline).
_REGNERF_BASE = dict(
    backbone="mipnerf",
    # single_image_patch composition (datasets.py:636-654): 4 16x16
    # patches + 1024 random rays per step.
    N_rand=1024,
    n_patches=4,
    patch_size=16,
    batching="single_image_patch",
    batch_size_random=2048,  # configs.py:54
    random_patch_size=8,  # configs.py:131 ("patch_size" there)
    lr_init=5e-4,  # configs.py:75
    lr_final=5e-5,  # configs.py:76
    lr_delay_steps=0,  # configs.py:77
    lr_delay_mult=0.0,  # configs.py:78
    total_iters=50002,  # configs.py:125 (max_steps)
    grad_max_val=0.0,  # configs.py:82
    factor=0,  # configs.py:55
    white_bkgd=True,  # configs.py:91
    load_random_rays=True,  # configs.py:132
    train_render_every=2000,  # configs.py:128
    checkpoint_every=25000,  # configs.py:126
    render_chunk_size=4096,  # configs.py:95
)


def _strip_comment(line: str) -> str:
    """Drop a trailing ``# ...`` comment, respecting quoted strings."""
    out = []
    quote = None
    for ch in line:
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#":
            break
        out.append(ch)
    return "".join(out)


def parse_gin_bindings(text: str) -> Dict[str, object]:
    """``Scope.key = literal`` lines -> {key: value} (scope dropped)."""
    bindings: Dict[str, object] = {}
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line or "=" not in line:
            continue
        name, value = line.split("=", 1)
        key = name.strip().split(".")[-1]
        bindings[key] = ast.literal_eval(value.strip())
    return bindings


def gin_overrides(text: str) -> Tuple[Dict[str, object], List[str]]:
    """Translate gin bindings to native Config overrides.

    Returns (overrides, ignored reference keys).
    """
    bindings = parse_gin_bindings(text)
    updates: Dict[str, object] = {}
    ignored: List[str] = []

    data_dir = bindings.pop("data_dir", None)
    scene = None
    for scene_key in ("dtu_scan", "llff_scan", "blender_scene"):
        if scene_key in bindings:
            scene = bindings.pop(scene_key)
    if data_dir is not None:
        data_dir = os.path.normpath(str(data_dir))
        if scene is not None:
            # The native DTU loader takes {root}/{scan} with Rectified/
            # under root; the reference points data_dir AT Rectified.
            if os.path.basename(data_dir) == "Rectified":
                data_dir = os.path.dirname(data_dir)
            updates["datadir"] = os.path.join(data_dir, str(scene))
        else:
            updates["datadir"] = data_dir

    ckpt_dir = bindings.pop("checkpoint_dir", None)
    if ckpt_dir is not None:
        ckpt_dir = os.path.normpath(str(ckpt_dir))
        updates["basedir"] = os.path.dirname(ckpt_dir) or "."
        updates["expname"] = os.path.basename(ckpt_dir)

    for key, value in bindings.items():
        name = _GIN_RENAME.get(key, key)
        if name in UNREAD:
            skip_unread({name: value}, "gin file")
        if key in _GIN_IGNORED or name not in _FIELDS:
            ignored.append(key)
            continue
        updates[name] = value
    return updates, ignored


def load_reference_gin(path: str) -> Config:
    with open(path) as f:
        updates, _ = gin_overrides(f.read())
    cfg = Config(**_REGNERF_BASE)
    if "expname" not in updates:
        updates["expname"] = os.path.splitext(os.path.basename(path))[0]
    return cfg.replace(**updates)


# --- configargparse txt (PyTorch backbone) ----------------------------------

_TXT_RENAME = {
    "chunk": "render_chunk_size",  # host render chunk -> jit boundary
}

_TXT_IGNORED = {
    "config",  # nested config files: not supported, pass the leaf file
    "no_reload",  # checkpoint restore is automatic (orbax latest-step)
    "ft_path",  # torch .tar restore: cli/import_torch_ckpt.py
    "netchunk",  # host net chunking has no analog under jit
}


def txt_overrides(text: str) -> Tuple[Dict[str, object], List[str]]:
    """Translate configargparse ``key = value`` lines to overrides."""
    updates: Dict[str, object] = {}
    ignored: List[str] = []
    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line or line.startswith(";"):
            continue
        if "=" in line:
            key, value = line.split("=", 1)
        elif ":" in line:
            key, value = line.split(":", 1)
        else:
            key, value = line, "True"  # bare store_true flag
        key, value = key.strip(), value.strip()
        try:
            parsed: object = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            parsed = value  # unquoted string (configargparse style)
        if key == "no_batching":
            updates["use_batching"] = not bool(parsed)
            continue
        name = _TXT_RENAME.get(key, key)
        if name in UNREAD:
            skip_unread({name: parsed}, "config file")
        if key in _TXT_IGNORED or name not in _FIELDS:
            ignored.append(key)
            continue
        updates[name] = parsed
    return updates, ignored


def load_reference_txt(path: str) -> Config:
    with open(path) as f:
        updates, _ = txt_overrides(f.read())
    # Native Config() defaults mirror the reference config_parser
    # defaults (run_nerf_view.py:672-808), pinned by the oracle tests.
    cfg = Config(backbone="vanilla")
    if "expname" not in updates:
        updates["expname"] = os.path.splitext(os.path.basename(path))[0]
    return cfg.replace(**updates)


# --- dispatch ----------------------------------------------------------------


def load_reference_config(path: str) -> Config:
    """Load a reference experiment file (.gin or .txt) as a Config."""
    if path.endswith(".gin"):
        return load_reference_gin(path)
    if path.endswith(".txt"):
        return load_reference_txt(path)
    raise ValueError(
        f"Not a reference config format: {path!r} (expect .gin or .txt)"
    )


def reference_config_keys(path: str) -> set:
    """The native field names a reference file sets (for the CLI's
    explicit-override bookkeeping in cli/common.py)."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".gin"):
        updates, _ = gin_overrides(text)
        return set(updates) | set(_REGNERF_BASE)
    updates, _ = txt_overrides(text)
    return set(updates)
