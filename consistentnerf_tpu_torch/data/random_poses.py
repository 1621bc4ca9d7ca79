"""Random poses and near/far annealing for the RegNeRF regularizer: a
numpy copy of `consistentnerf_tpu/data/random_poses.py`.

Random poses on or around the render path with focus-point jitter
(`RegNeRF/internal/datasets.py:1828-1863`) feed the mip batcher's
random-pose patch rays (the TV norm's input); the near/far annealing
schedule (`datasets.py:405-429`) rewrites every ray bundle of a batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from consistentnerf_tpu_torch.core.rays import Rays


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position, subtract_position=False):
    vec2 = normalize((lookdir - position) if subtract_position else lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses):
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def focus_pt_fn(poses):
    """Nearest point to all focal axes (datasets.py/load_dtu.py:49-55)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_random_poses(
    poses: np.ndarray,
    n_poses: int = 1000,
    pose_type: str = "renderpath",
    radius: float = 1.0,
    focusptjitter: bool = True,
    add_test_poses: bool = False,
    test_poses: Optional[np.ndarray] = None,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random c2w poses [n, 3, 4] float32 for unobserved-view
    regularization (datasets.py:1828-1863). poses: [N, 3, 4] train c2w
    stack; rng defaults to RandomState(0)."""
    rng = rng or np.random.RandomState(0)
    poses = np.asarray(poses)[:, :3, :4]
    if pose_type == "renderpath":
        positions = poses[:, :3, 3]
        radii = np.percentile(np.abs(positions), 100, 0)
        radii = np.concatenate([radii, [1.0]])
        cam2world = poses_avg(poses)
        up = poses[:, :3, 1].mean(0)
        z_axis = focus_pt_fn(poses)
        out = []
        for _ in range(n_poses):
            t = radii * np.concatenate([2 * radius * (rng.rand(3) - 0.5),
                                        [1.0]])
            position = cam2world @ t
            if focusptjitter:
                z_axis_i = z_axis + rng.randn(*z_axis.shape) * 0.125
            else:
                z_axis_i = z_axis
            out.append(viewmatrix(z_axis_i, up, position, True))
        if add_test_poses and test_poses is not None:
            out = out + list(np.asarray(test_poses)[:, :3, :4])
    elif pose_type == "linearcomb":
        out = list(poses)
        for _ in range(n_poses - poses.shape[0]):
            idx = rng.choice(poses.shape[0], size=(2,), replace=False)
            w = rng.rand()
            out.append(w * poses[idx[0]] + (1 - w) * poses[idx[1]])
    elif pose_type == "testposes":
        if test_poses is None:
            raise ValueError("random_pose_type 'testposes' needs test_poses")
        out = list(np.asarray(test_poses)[:, :3, :4])
    elif pose_type == "allposes":
        out = list(poses)
    else:
        raise ValueError(f"Unknown random_pose_type {pose_type!r}")
    return np.stack(out, axis=0).astype(np.float32)


def anneal_nearfar_values(it: int, near_final: float, far_final: float,
                          n_steps: int = 2000, init_perc: float = 0.2,
                          mid_perc: float = 0.5) -> tuple:
    """Annealed (near, far) at step `it` (datasets.py:405-421)."""
    mid = near_final + mid_perc * (far_final - near_final)
    near_init = mid + init_perc * (near_final - mid)
    far_init = mid + init_perc * (far_final - mid)
    weight = min(it * 1.0 / n_steps, 1.0)
    near_i = near_init + weight * (near_final - near_init)
    far_i = far_init + weight * (far_final - far_init)
    return near_i, far_i


def with_annealed_nearfar(rays: Rays, near: float, far: float) -> Rays:
    """A numpy ray bundle with every near / far set to the given values."""
    ones = np.ones_like(rays.origins[..., :1])
    return Rays(origins=rays.origins, directions=rays.directions,
                viewdirs=rays.viewdirs, radii=rays.radii,
                lossmult=rays.lossmult, near=ones * near, far=ones * far)
