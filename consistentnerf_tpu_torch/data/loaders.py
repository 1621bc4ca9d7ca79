"""Dataset dispatch and the consistency masks.

`load_scene(cfg)` loads the dataset named by `cfg.dataset_type` (LLFF,
Blender, DTU, the legacy DeepVoxels and LINEMOD layouts, or the
procedural synthetic scene) and attaches its masks, as the JAX package's
`data/loaders.py` does, with the hard masks made on `device`.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from consistentnerf_tpu_torch.data import images as images_lib
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.scene import SceneData


def load_deepvoxels(datadir: str, shape: str = "greek",
                    testskip: int = 8) -> SceneData:
    """DeepVoxels loader (the legacy vanilla-NeRF layout,
    load_deepvoxels.py)."""

    def parse_intrinsics(filepath, target_side_len):
        with open(filepath) as f:
            lines = f.readlines()
        f_, cx, cy = map(float, lines[0].split()[:3])
        height, width = map(float, lines[4].split())
        cx = cx / width * target_side_len
        cy = cy / height * target_side_len
        f_ = target_side_len / height * f_
        return f_, cx, cy

    def load_pose(filename):
        return np.loadtxt(filename).reshape(4, 4).astype(np.float32)

    basedir = os.path.join(datadir, shape)
    all_imgs, all_poses, counts = [], [], [0]
    H = W = 512
    focal = None
    for s in ("train", "val", "test"):
        d = os.path.join(basedir, s if s != "val" else "validation")
        if not os.path.isdir(d):
            d = os.path.join(basedir, s)
        fnames = sorted(os.listdir(os.path.join(d, "rgb")))
        skip = 1 if s == "train" or testskip == 0 else testskip
        fnames = fnames[::skip]
        imgs = [images_lib.imread(os.path.join(d, "rgb", f)) / 255.0
                for f in fnames]
        poses = [load_pose(os.path.join(d, "pose", f.replace(".png", ".txt")))
                 for f in fnames]
        own = os.path.join(basedir, s, "intrinsics.txt")
        focal, _, _ = parse_intrinsics(
            own if os.path.isfile(own) else os.path.join(d, "intrinsics.txt"),
            H)
        all_imgs.append(np.stack(imgs).astype(np.float32)[..., :3])
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    poses = np.concatenate(all_poses, 0)
    hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                 np.float32)
    return SceneData(
        images=np.concatenate(all_imgs, 0),
        poses=poses[:, :3, :4],
        K=K,
        H=H,
        W=W,
        focal=float(focal),
        near=hemi_r - 1.0,
        far=hemi_r + 1.0,
        i_train=i_split[0],
        i_test=i_split[2],
        i_val=i_split[1],
    )


def load_linemod(datadir: str, half_res: bool = False,
                 testskip: int = 8) -> SceneData:
    """LINEMOD loader (the legacy vanilla-NeRF layout, load_LINEMOD.py)."""
    all_imgs, all_poses, counts = [], [], [0]
    K = None
    near = far = None
    for s in ("train", "val", "test"):
        with open(os.path.join(datadir, f"transforms_{s}.json")) as f:
            meta = json.load(f)
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(datadir, frame["file_path"])
            imgs.append(images_lib.imread(fname) / 255.0)
            poses.append(np.array(frame["transform_matrix"], np.float32))
        K = np.array(meta["frames"][0]["intrinsic_matrix"], np.float32)
        near = float(meta.get("near", 0.1))
        far = float(meta.get("far", 2.0))
        all_imgs.append(np.stack(imgs).astype(np.float32))
        all_poses.append(np.stack(poses))
        counts.append(counts[-1] + len(imgs))

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)[..., :3]
    poses = np.concatenate(all_poses, 0)
    H, W = imgs.shape[1:3]
    focal = float(K[0, 0])
    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2
        K = K.copy()
        K[:2] /= 2
        imgs = np.stack([images_lib.resize(im, (W, H),
                                           interpolation=images_lib.INTER_AREA)
                         for im in imgs], 0)
    return SceneData(
        images=imgs,
        poses=poses[:, :3, :4],
        K=K[:3, :3],
        H=H,
        W=W,
        focal=focal,
        near=near,
        far=far,
        i_train=i_split[0],
        i_test=i_split[2],
        i_val=i_split[1],
    )


def attach_masks(scene: SceneData, cfg, cache_dir=None,
                 device="cuda") -> SceneData:
    """Attach the configured consistency masks (the JAX package's
    `data/loaders.py::attach_masks`), the first that applies of:

    canny / sobel: edge masks of the train views
    (`consistency/masks.py`, cv2's arithmetic in numpy); softmask: the
    precomputed Softmask PNGs (run_nerf_view.py:1047-1054), read from
    `Softmask/{dataset_type}/{scene}/iter_500/` under the working
    directory, nonzero pixels kept, zeros where a train view has none;
    hardmask: the reprojection masks of `consistency/reproject.py`,
    computed on `device` and cached as .npy under `cache_dir`, keyed on
    the train split and the scene shape. Otherwise the scene's own masks
    (all-ones where it has none)."""
    from consistentnerf_tpu_torch.consistency import masks as masks_mod

    scene.ensure_priors()
    if cfg.use_canny_edge_detection:
        scene.masks = masks_mod.canny_masks(
            scene.images, scene.i_train).astype(np.float32)
        return scene
    if cfg.use_sobel_edge_detection:
        scene.masks = masks_mod.sobel_masks(
            scene.images, scene.i_train).astype(np.float32)
        return scene
    if cfg.softmask:
        scene_name = os.path.basename(os.path.normpath(cfg.datadir))
        out = np.zeros(scene.images.shape[:3], np.float32)
        for i in scene.i_train:
            fname = (f"Softmask/{cfg.dataset_type}/{scene_name}/iter_500/"
                     f"softmask_{i:04d}_{cfg.softmask_K}per.png")
            if os.path.isfile(fname):
                out[i] = images_lib.imread(fname).astype(np.float32) / 255.0
        scene.masks = (out > 0).astype(np.float32)
        return scene
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


def _synthetic_scene(n_views, hw, texture_freq, layout, n_test,
                     interleave_test) -> SceneData:
    return synthetic.make_scene(
        n_views=n_views, H=hw, W=hw, texture_freq=texture_freq,
        layout=layout,
    ).to_scene_data(n_test=n_test, interleave_test=interleave_test)


def scene_reader(cfg):
    """The reader of the dataset named by cfg and its arguments, every one
    of them taken from cfg here: (function, kwargs). `read_scene` calls
    `function(**kwargs)`, so the pair is also what a read depends on."""
    kind = cfg.dataset_type
    if kind == "blender":
        from consistentnerf_tpu_torch.data.blender import load_blender

        return load_blender, dict(
            datadir=cfg.datadir, half_res=cfg.half_res,
            testskip=cfg.testskip, train_view_num=cfg.train_view_num,
            white_bkgd=cfg.white_bkgd, depthdir=cfg.depthdir)
    if kind == "llff":
        from consistentnerf_tpu_torch.data.llff import load_llff

        return load_llff, dict(
            datadir=cfg.datadir, factor=cfg.factor, spherify=cfg.spherify,
            no_ndc=cfg.no_ndc, train_view_num=cfg.train_view_num,
            depthdir=cfg.depthdir)
    if kind == "dtu":
        from consistentnerf_tpu_torch.data.dtu import load_dtu

        return load_dtu, dict(
            datadir=cfg.datadir, train_view_num=cfg.train_view_num,
            light_idx=cfg.dtu_light_cond, num_views=cfg.dtu_max_images,
            use_nerf_depth=cfg.use_nerf_depth,
            split_type=cfg.dtu_split_type, depthdir=cfg.depthdir)
    if kind == "deepvoxels":
        return load_deepvoxels, dict(datadir=cfg.datadir, shape=cfg.shape,
                                     testskip=cfg.testskip)
    if kind == "LINEMOD":
        return load_linemod, dict(datadir=cfg.datadir,
                                  half_res=cfg.half_res,
                                  testskip=cfg.testskip)
    if kind == "synthetic":
        return _synthetic_scene, dict(
            n_views=cfg.synthetic_views, hw=cfg.synthetic_hw,
            texture_freq=cfg.synthetic_texture_freq,
            layout=cfg.synthetic_layout, n_test=cfg.synthetic_n_test,
            interleave_test=cfg.synthetic_interleave_test)
    raise ValueError(f"Unknown dataset type {kind!r}")


def read_scene(cfg) -> SceneData:
    """The dataset named by cfg as its reader gives it, before any prior
    or mask is attached."""
    fn, kwargs = scene_reader(cfg)
    return fn(**kwargs)


def attach_priors(scene: SceneData, cfg, device="cuda") -> SceneData:
    """`load_scene`'s second step: `attach_masks` (hard masks computed on
    `device`, cached under `{basedir}/{expname}/mask_cache`), except for
    DTU, whose masks are its GT-depth coverage: there only the missing
    priors are filled."""
    if cfg.dataset_type == "dtu":
        return scene.ensure_priors()
    cache_dir = os.path.join(cfg.basedir, cfg.expname, "mask_cache")
    return attach_masks(scene, cfg, cache_dir, device=device)


def load_scene(cfg, device="cuda", attach=True) -> SceneData:
    """Load the dataset named by cfg (`read_scene`) and, with `attach`,
    prepare its priors and masks (`attach_priors`)."""
    scene = read_scene(cfg)
    return attach_priors(scene, cfg, device) if attach else scene
