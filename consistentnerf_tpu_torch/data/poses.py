"""Camera pose constructions (numpy): the spherical render path of the
Blender loader (`load_blender.py:9-35` semantics), and the LLFF pose
stack's averaging, recentring, spherifying and spiral render path
(`load_llff.py:178-279` semantics)."""

from __future__ import annotations

import numpy as np


def _trans_t(t):
    return np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]], np.float32
    )


def _rot_phi(phi):
    return np.array(
        [
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def _rot_theta(th):
    return np.array(
        [
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """c2w for a camera on a sphere looking at the origin."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            np.float32,
        )
        @ c2w
    )
    return c2w


def spherical_render_poses(n: int = 40, phi: float = -30.0,
                           radius: float = 4.0) -> np.ndarray:
    """The blender 360-degree render path."""
    return np.stack(
        [pose_spherical(angle, phi, radius)
         for angle in np.linspace(-180, 180, n + 1)[:-1]],
        0,
    )


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    """Camera-to-world from forward/up/position (load_llff.py convention)."""
    vec2 = normalize(z)
    vec1_avg = up
    vec0 = normalize(np.cross(vec1_avg, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    """Average pose of a [N, 3, 5] LLFF pose stack."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def _homogeneous(mats34):
    """[N, 3, 4] camera matrices -> [N, 4, 4] with a (0,0,0,1) last row."""
    last_row = np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                       [mats34.shape[0], 1, 1])
    return np.concatenate([mats34, last_row], 1)


def recenter_poses(poses):
    """Recenter a pose stack about its average pose
    (load_llff.py:256-268)."""
    out = poses + 0
    avg_h = np.concatenate(
        [poses_avg(poses)[:3, :4], np.reshape([0, 0, 0, 1.0], [1, 4])], -2
    )
    cams_h = _homogeneous(poses[:, :3, :4])
    out[:, :3, :4] = (np.linalg.inv(avg_h) @ cams_h)[:, :3, :4]
    return out


def _nearest_point_to_axes(origins, axes):
    """Least-squares point closest to every camera focal axis.

    Each axis contributes a residual projected onto the plane orthogonal
    to its direction; the normal equations solve for the crossing point.
    """
    proj = np.eye(3) - axes * np.transpose(axes, [0, 2, 1])
    rhs = -proj @ origins
    normal = (np.transpose(proj, [0, 2, 1]) @ proj).mean(0)
    return np.squeeze(-np.linalg.inv(normal) @ rhs.mean(0))


def _orbit_pose(theta, orbit_radius, orbit_height):
    """A camera on the z=orbit_height circle, looking at the origin."""
    position = np.array([orbit_radius * np.cos(theta),
                         orbit_radius * np.sin(theta), orbit_height])
    forward = normalize(position)
    right = normalize(np.cross(forward, np.array([0, 0, -1.0])))
    down = normalize(np.cross(forward, right))
    return np.stack([right, down, forward, position], 1)


def spherify_poses(poses, bds):
    """Recenter 360-degree captures about the point nearest all focal axes
    and rescale to unit radius; also returns a circular render path
    (load_llff.py:223-279, including its [.1, .2, .3] cross-product
    seed)."""
    focus = _nearest_point_to_axes(poses[:, :3, 3:4], poses[:, :3, 2:3])
    mean_up = (poses[:, :3, 3] - focus).mean(0)

    axis_z = normalize(mean_up)
    axis_x = normalize(np.cross([0.1, 0.2, 0.3], axis_z))
    axis_y = normalize(np.cross(axis_z, axis_x))
    frame = np.stack([axis_x, axis_y, axis_z, focus], 1)

    world = np.linalg.inv(_homogeneous(frame[None])) @ _homogeneous(
        poses[:, :3, :4]
    )
    mean_radius = np.sqrt(np.mean(np.sum(np.square(world[:, :3, 3]), -1)))

    scale = 1.0 / mean_radius
    world[:, :3, 3] *= scale
    bds = bds * scale
    mean_radius *= scale

    orbit_height = np.mean(world[:, :3, 3], 0)[2]
    orbit_radius = np.sqrt(mean_radius**2 - orbit_height**2)
    orbit = np.stack(
        [_orbit_pose(theta, orbit_radius, orbit_height)
         for theta in np.linspace(0.0, 2.0 * np.pi, 120)], 0
    )
    return world[:, :3, :4], orbit, bds


def generate_spiral_path(
    c2w, up, rads, focal, zdelta, zrate, rots, N, hwf=None
):
    """LLFF spiral render path (load_llff.py:178-199 semantics)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array(
                [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
            )
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        pose = viewmatrix(z, up, c)
        if hwf is not None:
            pose = np.concatenate([pose, hwf], 1)
        render_poses.append(pose)
    return np.stack(render_poses, 0)
