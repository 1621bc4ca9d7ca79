"""DTU MVS loader (`load_dtu.py`, RegNeRF `datasets.py` DTU semantics):

* 49 views, `Rectified/{scan}_train/rect_{vid+1:03d}_{light}_r5000.png`
  images and `Depths/Cameras/train/{vid:08d}_cam.txt` MVSNet camera files,
* intrinsics x4 (the cam files are quarter resolution), pose translation
  x 1/200, OpenCV -> OpenGL column flip,
* GT depth: PFM -> x0.5 nearest -> crop [44:556, 80:720] -> /200; the
  MVSNeRF prior depth read raw,
* the RegNeRF half-res + crop of the images to 512x640, with the
  intrinsics shifted to match,
* MiDaS disparity from `midas_dtu_depth/output_dtu_{scan}`, negatives
  clamped to zero,
* near / far from the cam files' depth range / 200.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from consistentnerf_tpu_torch.data import images
from consistentnerf_tpu_torch.data import pairs as pairs_lib
from consistentnerf_tpu_torch.data.pfm import read_pfm
from consistentnerf_tpu_torch.data.scene import SceneData

CROP = (44, 556, 80, 720)  # rows 44:556, cols 80:720 at half resolution

# The fixed pixelnerf DTU split of the IDR-mask evaluation
# (RegNeRF/internal/datasets.py:1719-1721).
PIXELNERF_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
PIXELNERF_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37,
                         38, 39]
IDR_SCANS = ["scan40", "scan55", "scan63", "scan110", "scan114"]


def pixelnerf_test_idx(num_views: int = 49):
    excluded = set(PIXELNERF_TRAIN_IDX) | set(PIXELNERF_EXCLUDE_IDX)
    return [i for i in np.arange(num_views) if i not in excluded]


def load_idr_masks(mask_path: str, scan: str, factor: int = 0,
                   num_views: int = 49):
    """IDR evaluation masks of the pixelnerf test views
    (datasets.py:1711-1746): [n_test, H, W, 3] float, 1 where scored."""
    if scan in IDR_SCANS:
        def maskf_fn(x):
            return os.path.join(mask_path, scan, "mask", f"{x:03d}.png")
    else:
        def maskf_fn(x):
            return os.path.join(mask_path, scan, f"{x:03d}.png")

    masks = []
    for idx in pixelnerf_test_idx(num_views):
        image = images.imread(maskf_fn(idx))[:, :, :3].astype(
            np.float32) / 255.0
        image = (image == 1).astype(np.float32)
        if factor > 0:
            h, w = image.shape[:2]
            image = images.resize(image, (w // factor, h // factor),
                                  interpolation=images.INTER_NEAREST)
        masks.append(image)
    return np.stack(masks)


def read_cam_file(filename: str):
    """MVSNet cam.txt: intrinsics (3x3), extrinsics (w2c 4x4), depth
    range."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.array(" ".join(lines[1:5]).split(),
                          np.float32).reshape(4, 4)
    intrinsics = np.array(" ".join(lines[7:10]).split(),
                          np.float32).reshape(3, 3)
    depth_min = float(lines[11].split()[0])
    depth_max = depth_min + float(lines[11].split()[1]) * 192 * 1.06
    return intrinsics, extrinsics, [depth_min, depth_max]


def read_gt_depth(filename: str) -> np.ndarray:
    """The GT depth of load_dtu.py:171-177 (before the /200 scale)."""
    depth_h = np.array(read_pfm(filename)[0], dtype=np.float32)
    depth_h = images.resize(depth_h, None, fx=0.5, fy=0.5,
                            interpolation=images.INTER_NEAREST)
    r0, r1, c0, c1 = CROP
    return depth_h[r0:r1, c0:c1]


def _fit(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """A prior map at the image size (INTER_NEAREST where it is not)."""
    if x.shape == (h, w):
        return x
    return images.resize(x, (w, h), interpolation=images.INTER_NEAREST)


def load_dtu(
    datadir: str,
    train_view_num: int = 3,
    light_idx: int = 3,
    num_views: int = 49,
    crop_images: bool = True,
    use_nerf_depth: bool = True,
    split_type: str = "masknerf",
    depthdir: Optional[str] = None,
    pairs_path: Optional[str] = None,
) -> SceneData:
    """datadir: `{root}/{scan}`, in the MVSNet DTU layout under root.

    crop_images=True takes the RegNeRF half-res + [44:556, 80:720] crop,
    so the images align with the (cropped) GT depths at 512x640, the
    resolution DTU numbers are reported at."""
    root_dir = os.path.dirname(os.path.normpath(datadir))
    scan = os.path.basename(os.path.normpath(datadir))
    parent = os.path.dirname(os.path.abspath(datadir))

    cas_dir = None
    for c in [
        depthdir,
        os.path.join("nerf_dtu_data_depth", scan),
        os.path.join(parent, "nerf_dtu_data_depth", scan),
    ]:
        if c and os.path.isdir(c):
            cas_dir = c
            break

    midas_dir = None
    for c in [
        os.path.join("data", "midas_dtu_depth", f"output_dtu_{scan}"),
        os.path.join(parent, "midas_dtu_depth", f"output_dtu_{scan}"),
    ]:
        if os.path.isdir(c):
            midas_dir = c
            break

    imgs, poses, depths_cas, depths_gt, monos, bds = [], [], [], [], [], []
    intrinsic = None
    for vid in range(num_views):
        img_filename = os.path.join(
            root_dir, f"Rectified/{scan}_train/rect_{vid + 1:03d}_"
            f"{light_idx}_r5000.png")
        proj_mat_filename = os.path.join(
            root_dir, f"Depths/Cameras/train/{vid:08d}_cam.txt")
        depth_filename = os.path.join(
            root_dir, f"Depths/{scan}/depth_map_{vid:04d}.pfm")

        intrinsic, w2c, near_far = read_cam_file(proj_mat_filename)
        intrinsic = intrinsic.copy()
        intrinsic[:2] *= 4  # the cam files are quarter-res

        img = images.imread(img_filename).astype(np.float32) / 255.0

        c2w = np.linalg.inv(w2c)
        c2w[:3, 3] *= 1 / 200
        # OpenCV (y down, z forward) -> OpenGL (y up, z back) columns.
        pose = np.concatenate(
            [c2w[:, :1], -c2w[:, 1:2], -c2w[:, 2:3], c2w[:, 3:4]], axis=-1)

        dgt = (read_gt_depth(depth_filename) / 200
               if os.path.isfile(depth_filename) else None)

        dcas = None
        if cas_dir:
            cas_file = os.path.join(cas_dir, f"depth_{vid:04d}.pfm")
            if os.path.isfile(cas_file):
                dcas = np.array(read_pfm(cas_file)[0], np.float32)

        dmono = None
        if midas_dir:
            mono_file = os.path.join(
                midas_dir, f"rect_{vid + 1:03d}_{light_idx}_r5000"
                "-dpt_beit_large_512.pfm")
            if os.path.isfile(mono_file):
                dmono = np.array(read_pfm(mono_file)[0], np.float32)
                dmono = np.where(dmono < 0, 0, dmono)

        if crop_images:
            h, w = img.shape[:2]
            r0, r1, c0, c1 = CROP
            if h // 2 < r1 or w // 2 < c1:
                raise ValueError(
                    f"DTU crop {CROP} needs >= {2 * r1}x{2 * c1} images, "
                    f"got {h}x{w}; pass crop_images=False for non-standard "
                    "resolutions")
            img = images.resize(img, (w // 2, h // 2),
                                interpolation=images.INTER_AREA)
            img = img[r0:r1, c0:c1]
            intrinsic[:2] *= 0.5
            intrinsic[0, 2] -= c0
            intrinsic[1, 2] -= r0

        H, W = img.shape[:2]
        zeros = np.zeros((H, W), np.float32)
        imgs.append(img[..., :3])
        poses.append(pose.astype(np.float32))
        depths_gt.append(zeros if dgt is None else _fit(dgt, H, W))
        depths_cas.append(zeros if dcas is None else _fit(dcas, H, W))
        monos.append(zeros if dmono is None else _fit(dmono, H, W))
        bds += [near_far[0] / 200, near_far[1] / 200]

    imgs = np.stack(imgs, 0).astype(np.float32)
    poses = np.stack(poses, 0)
    depths_gt = np.stack(depths_gt, 0)
    depths_cas = np.stack(depths_cas, 0)
    mono_disp = np.stack(monos, 0)
    bds = np.asarray(bds, np.float32)

    if split_type == "masknerf":
        # ConsistentNeRF's split: the pairs registry's dtu_train / dtu_val.
        i_train = pairs_lib.get_split("dtu", "train", train_view_num,
                                      pairs_path)
        i_test = pairs_lib.get_split("dtu", "val", path=pairs_path)
    elif split_type == "pixelnerf":
        i_train = np.asarray(PIXELNERF_TRAIN_IDX[:train_view_num])
        i_test = np.asarray(pixelnerf_test_idx(num_views))
    else:
        raise ValueError(f"Unknown dtu split_type {split_type!r}")

    H, W = imgs.shape[1:3]
    return SceneData(
        images=imgs,
        poses=poses[:, :3, :4],
        K=intrinsic.astype(np.float32),
        H=H,
        W=W,
        focal=float(intrinsic[0, 0]),
        near=float(bds.min()),
        far=float(bds.max()),
        i_train=i_train,
        i_test=i_test,
        i_val=i_test,
        depths=depths_cas if use_nerf_depth else depths_gt,
        # The cas depths are an upstream MVS estimate; only the
        # structured-light scans count as ground truth.
        depth_is_gt=not use_nerf_depth,
        masks=(depths_gt > 0).astype(np.float32),
        mono_disp=mono_disp,
        render_poses=None,
        bounds=bds.reshape(-1, 2),
    )
