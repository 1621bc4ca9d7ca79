"""Blender (nerf_synthetic) loader with ConsistentNeRF's view splits,
`load_blender.py:load_blender_view_data` (:130-223) semantics: every split
indexes the *train* transforms through the pairs registry (train, val,
then val again as test), MVSNeRF depth PFMs come from
`nerf_synthesic_data_depth/{scene}` (the reference's spelling), MiDaS
disparity from `midas_nerf_depth/output_nerf_{scene}`, the render path
is a 40-pose arc, and half_res shrinks with INTER_AREA."""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from consistentnerf_tpu_torch.data import images
from consistentnerf_tpu_torch.data import pairs as pairs_lib
from consistentnerf_tpu_torch.data import poses as poses_lib
from consistentnerf_tpu_torch.data.pfm import read_pfm
from consistentnerf_tpu_torch.data.scene import SceneData


def _find_dir(candidates):
    for c in candidates:
        if c and os.path.isdir(c):
            return c
    return None


def _depth_dirs(datadir: str, scene: str, depthdir: Optional[str]):
    parent = os.path.dirname(os.path.abspath(datadir))
    mvs = _find_dir([
        depthdir,
        os.path.join("nerf_synthesic_data_depth", scene),
        os.path.join(parent, "nerf_synthesic_data_depth", scene),
    ])
    midas = _find_dir([
        os.path.join("data", "midas_nerf_depth", f"output_nerf_{scene}"),
        os.path.join(parent, "midas_nerf_depth", f"output_nerf_{scene}"),
    ])
    return mvs, midas


def _half(stack: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.stack([images.resize(x, (w, h), interpolation=images.INTER_AREA)
                     for x in stack], 0)


def load_blender(
    datadir: str,
    half_res: bool = False,
    testskip: int = 8,
    train_view_num: int = 3,
    white_bkgd: bool = True,
    depthdir: Optional[str] = None,
    pairs_path: Optional[str] = None,
) -> SceneData:
    """`testskip` is the JAX signature's and unused: the registry picks
    the views."""
    scene = os.path.basename(os.path.normpath(datadir))
    with open(os.path.join(datadir, "transforms_train.json")) as f:
        meta = json.load(f)

    mvs_dir, midas_dir = _depth_dirs(datadir, scene, depthdir)
    depth_files = (sorted(os.path.join(mvs_dir, f)
                          for f in os.listdir(mvs_dir) if f.endswith("pfm"))
                   if mvs_dir else [])

    i_train_src = pairs_lib.get_split(scene, "train", train_view_num,
                                      pairs_path)
    i_val_src = pairs_lib.get_split(scene, "val", path=pairs_path)

    all_idx = list(i_train_src) + list(i_val_src) + list(i_val_src)
    imgs, poses, depths, mono = [], [], [], []
    for idx in all_idx:
        frame = meta["frames"][int(idx)]
        fname = os.path.join(datadir, frame["file_path"] + ".png")
        img = images.imread(fname)
        imgs.append(img)
        poses.append(np.array(frame["transform_matrix"], np.float32))
        if depth_files:
            d = np.array(read_pfm(depth_files[int(idx)])[0], np.float32)
        else:
            d = np.zeros(img.shape[:2], np.float32)
        depths.append(d)
        base = os.path.basename(fname)[:-4]
        midas_file = (os.path.join(midas_dir, f"{base}-dpt_beit_large_512.pfm")
                      if midas_dir else None)
        if midas_file and os.path.isfile(midas_file):
            dpt = read_pfm(midas_file)[0]
            mono.append(np.where(dpt < 0, 0, dpt).astype(np.float32))
        else:
            mono.append(np.zeros(img.shape[:2], np.float32))

    imgs = (np.stack(imgs, 0) / 255.0).astype(np.float32)
    poses = np.stack(poses, 0)
    depths = np.stack(depths, 0)
    mono = np.stack(mono, 0)

    n_train = len(i_train_src)
    n_val = len(i_val_src)
    i_train = np.arange(0, n_train)
    i_val = np.arange(n_train, n_train + n_val)
    i_test = np.arange(n_train + n_val, n_train + 2 * n_val)

    H, W = imgs.shape[1:3]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    # The partial arc render path (load_blender.py:210).
    render_poses = np.stack(
        [poses_lib.pose_spherical(a, -30.0, 4.0)
         for a in np.linspace(-185, -95, 40 + 1)[:-1]], 0)

    if half_res:
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs = _half(imgs, H, W)
        if depths.shape[1] != H:
            depths = _half(depths, H, W)
        if mono.shape[1] != H:
            mono = _half(mono, H, W)

    if imgs.shape[-1] == 4:
        if white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]

    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    return SceneData(
        images=imgs.astype(np.float32),
        poses=poses[:, :3, :4],
        K=K,
        H=H,
        W=W,
        focal=float(focal),
        near=2.0,
        far=6.0,
        i_train=i_train,
        i_test=i_test,
        i_val=i_val,
        depths=depths,
        mono_disp=mono,
        render_poses=render_poses,
    )
