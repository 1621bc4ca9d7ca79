"""Scene loading and the consistency masks. Only the procedural synthetic
scene is ported; the dataset loaders come with a later slice (ROADMAP
Queue 1: data loaders)."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.scene import SceneData


def attach_masks(scene: SceneData, cfg, cache_dir=None,
                 device="cuda") -> SceneData:
    """Attach the configured consistency masks (the JAX package's
    `data/loaders.py::attach_masks`).

    hardmask: the reprojection masks of `consistency/reproject.py`,
    computed on `device` and cached as .npy under `cache_dir`, keyed on
    the train split and the scene shape. Otherwise the scene's own masks
    (all-ones where it has none). The softmask PNGs and the canny / sobel
    edge masks are not ported yet and raise rather than train on other
    masks."""
    scene.ensure_priors()
    for flag in ("use_canny_edge_detection", "use_sobel_edge_detection",
                 "softmask"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag}=true: the softmask and edge-mask branches of "
                "attach_masks are not ported yet (ROADMAP Queue 1: "
                "consistency)")
    if not cfg.hardmask:
        return scene
    cache = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        # Keyed on the actual train split and scene shape, so a changed
        # split or scene regenerates the masks instead of loading stale
        # ones.
        ident = "-".join(map(str, scene.i_train)) + ":" + "x".join(
            map(str, scene.images.shape[:3]))
        tag = hashlib.sha1(ident.encode()).hexdigest()[:10]
        cache = os.path.join(
            cache_dir, f"hardmask_{cfg.train_view_num}view_"
            f"{cfg.occlusion_threshold}_{tag}.npy")
    if cache and os.path.isfile(cache):
        scene.masks = np.load(cache).astype(np.float32)
        return scene
    from consistentnerf_tpu_torch.consistency import reproject

    hard = reproject.compute_hard_masks(
        scene.poses, scene.depths, scene.K, scene.i_train, scene.H, scene.W,
        occlusion_threshold=cfg.occlusion_threshold, device=device)
    scene.masks = hard.astype(np.float32)
    if cache:
        np.save(cache, hard)
    return scene


def load_scene(cfg, device="cuda") -> SceneData:
    """Load the scene named by cfg and attach its masks (`attach_masks`,
    computed on `device`) under `{basedir}/{expname}/mask_cache`."""
    if cfg.dataset_type != "synthetic":
        raise NotImplementedError(
            f"dataset_type={cfg.dataset_type!r} is not ported yet: only "
            "'synthetic' loads (ROADMAP Queue 1: data loaders)"
        )
    scene = synthetic.make_scene(
        n_views=cfg.synthetic_views,
        H=cfg.synthetic_hw,
        W=cfg.synthetic_hw,
        texture_freq=cfg.synthetic_texture_freq,
        layout=cfg.synthetic_layout,
    ).to_scene_data(
        n_test=cfg.synthetic_n_test,
        interleave_test=cfg.synthetic_interleave_test,
    )
    cache_dir = os.path.join(cfg.basedir, cfg.expname, "mask_cache")
    return attach_masks(scene, cfg, cache_dir, device=device)
