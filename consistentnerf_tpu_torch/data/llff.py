"""LLFF (forward-facing) loader, `load_llff.py:62-356` semantics:
poses_bounds.npy with the [down, right, back] -> [right, up, back] column
swap, the bd_factor rescale, recentring or spherifying, the spiral render
path, MVS depth PFMs from `nerf_llff_data_depth/{scene}` resized to the
image size, MiDaS disparity from `midas_llff_depth/output_llff_{scene}`.
`images_{factor}/` is made by an INTER_AREA resize (no imagemagick)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from consistentnerf_tpu_torch.data import images
from consistentnerf_tpu_torch.data import pairs as pairs_lib
from consistentnerf_tpu_torch.data import poses as poses_lib
from consistentnerf_tpu_torch.data.pfm import read_pfm
from consistentnerf_tpu_torch.data.scene import SceneData

_IMAGE_EXTS = ("jpg", "jpeg", "png")


def _minify(basedir: str, factor: int):
    """Write images_{factor}/ as PNGs shrunk by INTER_AREA from images/."""
    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return
    srcdir = os.path.join(basedir, "images")
    files = [f for f in sorted(os.listdir(srcdir))
             if f.lower().endswith(_IMAGE_EXTS)]
    os.makedirs(imgdir)
    for f in files:
        img = images.imread(os.path.join(srcdir, f))
        h, w = img.shape[:2]
        out = images.resize(img, (w // factor, h // factor),
                            interpolation=images.INTER_AREA)
        images.write_png(
            os.path.join(imgdir, os.path.splitext(f)[0] + ".png"), out)


def _load_data(basedir: str, factor: Optional[int], midas_dir: Optional[str]):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factor)
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)
    imgfiles = [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir))
                if f.lower().endswith(_IMAGE_EXTS)]
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(
            f"Mismatch between imgs {len(imgfiles)} and poses "
            f"{poses.shape[-1]}"
        )

    imgs = [images.imread(f) for f in imgfiles]
    poses[:2, 4, :] = np.array(imgs[0].shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    imgs = np.stack([im[..., :3] / 255.0 for im in imgs], -1)

    mono = []
    for f in imgfiles:
        base = os.path.basename(f)[:-4]
        mf = (os.path.join(midas_dir, f"{base}-dpt_beit_large_512.pfm")
              if midas_dir else None)
        if mf and os.path.isfile(mf):
            d = read_pfm(mf)[0]
            mono.append(np.where(d < 0, 0, d).astype(np.float32))
        else:
            mono.append(np.zeros(imgs.shape[:2], np.float32))
    return poses, bds, imgs, np.stack(mono)


def load_llff(
    datadir: str,
    factor: int = 4,
    recenter: bool = True,
    bd_factor: float = 0.75,
    spherify: bool = False,
    no_ndc: bool = False,
    train_view_num: int = 3,
    depthdir: Optional[str] = None,
    pairs_path: Optional[str] = None,
) -> SceneData:
    scene = os.path.basename(os.path.normpath(datadir))
    parent = os.path.dirname(os.path.abspath(datadir))
    midas_dir = None
    for c in [
        os.path.join("data", "midas_llff_depth", f"output_llff_{scene}"),
        os.path.join(parent, "midas_llff_depth", f"output_llff_{scene}"),
    ]:
        if os.path.isdir(c):
            midas_dir = c
            break

    poses, bds, imgs, mono = _load_data(datadir, factor, midas_dir)

    # [down, right, back] -> [right, up, back] (load_llff.py:290).
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1
    )
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = poses_lib.recenter_poses(poses)
    spherify_render_poses = None
    if spherify:
        hwf_col = poses[:, :3, 4:]
        poses34, spherify_render_poses, bds = poses_lib.spherify_poses(
            poses[:, :3, :4], bds
        )
        poses = np.concatenate([poses34, hwf_col], -1).astype(np.float32)

    hwf = poses[0, :3, -1]
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])

    # MVS depth priors, resized (INTER_LINEAR) to the image size
    # (run_nerf_view.py:834-845).
    depth_dir = None
    for c in [
        depthdir,
        os.path.join("nerf_llff_data_depth", scene),
        os.path.join(parent, "nerf_llff_data_depth", scene),
    ]:
        if c and os.path.isdir(c):
            depth_dir = c
            break
    if depth_dir:
        depth_files = sorted(os.path.join(depth_dir, f)
                             for f in os.listdir(depth_dir)
                             if f.endswith("pfm"))
        depths = [images.resize(np.array(read_pfm(f)[0], np.float32), (W, H),
                                interpolation=images.INTER_LINEAR)
                  for f in depth_files]
        depths = np.stack(depths[: imgs.shape[0]], 0)
    else:
        depths = np.zeros(imgs.shape[:3], np.float32)

    i_train = pairs_lib.get_split(scene, "train", train_view_num, pairs_path)
    i_test = pairs_lib.get_split(scene, "val", path=pairs_path)

    if no_ndc:
        near = float(bds.min()) * 0.9
        far = float(bds.max()) * 1.0
        use_ndc = False
    else:
        near, far = 0.0, 1.0
        use_ndc = True

    if spherify_render_poses is not None:
        render_poses = spherify_render_poses
    else:
        render_poses = poses_lib.generate_spiral_path(
            poses_lib.poses_avg(poses),
            poses[:, :3, 1].mean(0),
            np.percentile(np.abs(poses[:, :3, 3]), 90, 0),
            1.0 / ((1 - 0.75) / (bds.min() * 0.9) + 0.75 / (bds.max() * 5.0)),
            zdelta=bds.min() * 0.9 * 0.2,
            zrate=0.5,
            rots=2,
            N=60,
        )

    K = np.array(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], np.float32
    )
    return SceneData(
        images=imgs,
        poses=poses[:, :3, :4],
        K=K,
        H=H,
        W=W,
        focal=focal,
        near=near,
        far=far,
        i_train=i_train,
        i_test=i_test,
        i_val=i_test,
        depths=depths,
        mono_disp=mono,
        render_poses=render_poses.astype(np.float32),
        use_ndc=use_ndc,
        bounds=bds,
    )
