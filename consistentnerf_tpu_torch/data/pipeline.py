"""Host-side ray batching of both trainers.

Reproduces the reference's batch composition:
* vanilla single-image mode with 4x16x16 patch rays (white-background
  rejection sampling) + N_rand random rays (`run_nerf_view.py:1441-1517`);
* vanilla `use_batching` mode: a pre-shuffled global ray pool
  (`run_nerf_view.py:1221-1253`);
* mip batching modes `single_image_patch` / `single_image` / `all_images`
  (`RegNeRF/internal/datasets.py:600-680`), with a `Rays` bundle under
  "rays", the random-pose patch rays of the TV norm under "rays_random"
  (`load_random_rays`) and the near/far annealing (`anneal_nearfar`).
All draw from `np.random.RandomState(cfg.seed)` in the JAX package's
order, so a seed gives the same batches. Batches are numpy dicts; the
trainer moves them to the device. `Prefetcher` runs a batcher on a
thread ahead of the loop (the JAX package's, `data/pipeline.py:398-451`).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from consistentnerf_tpu_torch.core import rays as rays_core
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data import random_poses as rp
from consistentnerf_tpu_torch.data.scene import SceneData


def _np_rays(scene: SceneData):
    """Per-view (origins, dirs, viewdirs) stacks [N, H, W, 3] in numpy.

    Viewdirs come from the camera-space directions; NDC scenes then warp
    origins/directions (the reference does this inside render(),
    run_nerf_view.py:216-228)."""
    os_, ds_, vs_ = [], [], []
    for p in scene.poses:
        o, d = rays_core.get_rays(scene.H, scene.W, scene.K, p[:3, :4],
                                  device="cpu")
        v = d.numpy()
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        if scene.use_ndc:
            o, d = rays_core.ndc_rays(scene.H, scene.W, scene.focal, 1.0, o,
                                      d)
        os_.append(o.numpy())
        ds_.append(d.numpy())
        vs_.append(v)
    return np.stack(os_, 0), np.stack(ds_, 0), np.stack(vs_, 0)


class VanillaBatcher:
    """Single-image patch + random ray batches."""

    def __init__(self, scene: SceneData, cfg, seed: Optional[int] = None):
        scene.ensure_priors()
        self.scene = scene
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed if seed is None else seed)
        self.origins, self.dirs, self.vdirs = _np_rays(scene)
        self.step = 0
        h, w = scene.H, scene.W
        self._all_coords = np.stack(
            np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1
        ).reshape(-1, 2)

    @property
    def batch_size(self) -> int:
        return self.cfg.n_patches * self.cfg.patch_size**2 + self.cfg.N_rand

    def _sample_patches(self, target: np.ndarray) -> np.ndarray:
        """Patch top-lefts with white-background rejection
        (run_nerf_view.py:1476-1505). Returns [n_patches*ps^2, 2] coords."""
        cfg = self.cfg
        ps = cfg.patch_size
        h, w = target.shape[:2]
        # During precrop, patch origins stay in the central crop
        # (run_nerf_view.py:1479-1481).
        if self.step < cfg.precrop_iters:
            dh = int(h // 2 * cfg.precrop_frac)
            dw = int(w // 2 * cfg.precrop_frac)
            r_lo, r_hi = h // 2 - dh, max(h // 2 - dh + 1, h // 2 + dh - ps)
            c_lo, c_hi = w // 2 - dw, max(w // 2 - dw + 1, w // 2 + dw - ps)
        else:
            r_lo, r_hi = 0, h - ps + 1
            c_lo, c_hi = 0, w - ps + 1
        grid = np.stack(
            np.meshgrid(np.arange(ps), np.arange(ps), indexing="xy"), -1
        ).reshape(-1, 2)
        if cfg.n_patches <= 0:
            return np.zeros((0, 2), np.int64)
        out = []
        num = attempts = 0
        while num < cfg.n_patches:
            attempts += 1
            x0 = self.rng.randint(r_lo, r_hi)
            y0 = self.rng.randint(c_lo, c_hi)
            idx = np.array([x0, y0]) + grid  # rows, cols
            patch_rgb = target[idx[:, 0], idx[:, 1]].mean(1)
            # Accept patches that are less than half pure-white background
            # (the reference's `< 257` of 256 pixels); give up rejection
            # after enough attempts (degenerate all-white images).
            if (patch_rgb == 1.0).sum() < ps * ps + 1 or attempts > 100:
                out.append(idx)
                num += 1
        return np.concatenate(out, 0)

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        scene = self.scene
        # Pseudo-label branch (run_nerf_view.py:1520-1571): with p=0.1
        # draw rays from a non-train view restricted to masked pixels,
        # and downweight its losses x0.1.
        pseudo = False
        if (cfg.use_test_pseudo_label and self.step >= cfg.precrop_iters
                and self.rng.random_sample() >= 0.9
                and len(scene.i_test) > 0):
            pseudo = True
            img_i = int(self.rng.choice(scene.i_test))
        else:
            img_i = int(self.rng.choice(scene.i_train))
        target = scene.images[img_i]
        patch_idx = self._sample_patches(target)

        if self.step < cfg.precrop_iters:
            h, w = scene.H, scene.W
            dh = int(h // 2 * cfg.precrop_frac)
            dw = int(w // 2 * cfg.precrop_frac)
            rows, cols = np.meshgrid(np.arange(h // 2 - dh, h // 2 + dh),
                                     np.arange(w // 2 - dw, w // 2 + dw),
                                     indexing="ij")
            coords = np.stack([rows, cols], -1).reshape(-1, 2)
        elif pseudo:
            coords = np.stack(np.nonzero(scene.masks[img_i] > 0), -1)
            if coords.shape[0] == 0:
                coords = self._all_coords
        else:
            coords = self._all_coords
        replace = coords.shape[0] < cfg.N_rand
        sel = self.rng.choice(coords.shape[0], size=cfg.N_rand,
                              replace=replace)
        select = np.concatenate([patch_idx, coords[sel]], 0)

        r, c = select[:, 0], select[:, 1]
        batch = {
            "origins": self.origins[img_i][r, c],
            "directions": self.dirs[img_i][r, c],
            "viewdirs": self.vdirs[img_i][r, c],
            "rgb": target[r, c],
            "depth": scene.depths[img_i][r, c],
            "mask": scene.masks[img_i][r, c].astype(np.float32),
            "mono_disp": scene.mono_disp[img_i][r, c],
        }
        batch["loss_scale"] = np.float32(0.1 if pseudo else 1.0)
        if cfg.ss_loss:
            # The online reprojection loss's reference view, drawn after
            # every other draw of the batch (the JAX package's order).
            ref_i = int(self.rng.choice(scene.i_train))
            batch["ref_image"] = scene.images[ref_i].astype(np.float32)
            batch["ref_depth"] = scene.depths[ref_i].astype(np.float32)
            batch["ref_pose"] = scene.poses[ref_i][:3, :4].astype(np.float32)
            batch["K"] = np.asarray(scene.K, np.float32)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


class AllImagesBatcher:
    """`use_batching` mode: shuffled global ray pool."""

    def __init__(self, scene: SceneData, cfg, seed: Optional[int] = None):
        scene.ensure_priors()
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed if seed is None else seed)
        origins, dirs, vdirs = _np_rays(scene)
        tr = np.asarray(scene.i_train)

        def flat(x):
            return x[tr].reshape(-1, *x.shape[3:])

        self.pool = {
            "origins": flat(origins).astype(np.float32),
            "directions": flat(dirs).astype(np.float32),
            "viewdirs": flat(vdirs).astype(np.float32),
            "rgb": flat(scene.images).astype(np.float32),
            "depth": scene.depths[tr].reshape(-1).astype(np.float32),
            "mask": scene.masks[tr].reshape(-1).astype(np.float32),
            "mono_disp": scene.mono_disp[tr].reshape(-1).astype(np.float32),
        }
        self.n = self.pool["rgb"].shape[0]
        self.perm = self.rng.permutation(self.n)
        self.i = 0

    def next_batch(self) -> Dict[str, np.ndarray]:
        bs = self.cfg.n_patches * self.cfg.patch_size**2 + self.cfg.N_rand
        if self.i + bs > self.n:
            self.perm = self.rng.permutation(self.n)
            self.i = 0
        idx = self.perm[self.i: self.i + bs]
        self.i += bs
        return {k: v[idx] for k, v in self.pool.items()}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


class MipBatcher:
    """Rays-bundle batches of the mip trainer (pipeline.py:228-395):
    `single_image_patch` = 4x16x16 patches + N_rand rays random from the
    same image; `single_image` = all rays random from one image;
    `all_images` = every ray from a random (view, pixel). With
    `random_poses` [P, 3, 4] and `load_random_rays` every batch carries
    random-pose patch rays under "rays_random"."""

    def __init__(self, scene: SceneData, cfg, seed: Optional[int] = None,
                 random_poses: Optional[np.ndarray] = None):
        scene.ensure_priors()
        self.scene = scene
        self.cfg = cfg
        self.step = 0
        self.rng = np.random.RandomState(cfg.seed if seed is None else seed)
        self.origins, self.dirs, self.viewdirs = _np_rays(scene)
        dx = np.sqrt(
            np.sum((self.dirs[:, :, :-1] - self.dirs[:, :, 1:]) ** 2, -1))
        dx = np.concatenate([dx, dx[:, :, -2:-1]], 2)
        self.radii = (dx * 2 / np.sqrt(12))[..., None].astype(np.float32)
        self.random_poses = random_poses
        self._pixdirs = None  # [H, W, 3] camera-frame directions

    def _rays_at(self, img, r, c) -> Rays:
        s = self.scene
        ones = np.ones((r.shape[0], 1), np.float32)
        return Rays(
            origins=self.origins[img, r, c].astype(np.float32),
            directions=self.dirs[img, r, c].astype(np.float32),
            viewdirs=self.viewdirs[img, r, c].astype(np.float32),
            radii=self.radii[img, r, c],
            lossmult=ones,
            near=ones * s.near,
            far=ones * s.far,
        )

    def _random_pose_patch_rays(self) -> Rays:
        """batch_size_random // ps^2 patches of ps x ps rays, each from a
        random pose and window (pipeline.py:266-312): per patch a pose
        index, then the window's row and column, from the batcher's
        RandomState."""
        cfg, s = self.cfg, self.scene
        ps = cfg.random_patch_size
        n_patches = max(1, cfg.batch_size_random // (ps * ps))
        if self._pixdirs is None:
            self._pixdirs = rays_core.pixel_dirs(s.H, s.W, s.K,
                                                 device="cpu").numpy()
        origins, dirs, view, radii = [], [], [], []
        for _ in range(n_patches):
            pose = np.asarray(self.random_poses[self.rng.randint(
                0, self.random_poses.shape[0])])[:3, :4]
            r0 = self.rng.randint(0, s.H - ps + 1)
            c0 = self.rng.randint(0, s.W - ps + 1)
            dc = self._pixdirs[r0:r0 + ps, c0:c0 + ps].reshape(-1, 3)
            dp = dc @ pose[:3, :3].T
            origins.append(np.broadcast_to(pose[:3, 3], dp.shape)
                           .astype(np.float32))
            dirs.append(dp.astype(np.float32))
            view.append(dp / np.linalg.norm(dp, axis=-1, keepdims=True))
            radii.append(np.full((ps * ps, 1),
                                 1.0 / s.focal * 2 / np.sqrt(12),
                                 np.float32))
        ones = np.ones((n_patches * ps * ps, 1), np.float32)
        return Rays(origins=np.concatenate(origins, 0).astype(np.float32),
                    directions=np.concatenate(dirs, 0).astype(np.float32),
                    viewdirs=np.concatenate(view, 0).astype(np.float32),
                    radii=np.concatenate(radii, 0), lossmult=ones,
                    near=ones * s.near, far=ones * s.far)

    def next_batch(self) -> Dict[str, object]:
        cfg, s = self.cfg, self.scene
        mode = cfg.batching
        if mode == "all_images":
            n = 4 * 256 + max(0, cfg.N_rand)
            img = self.rng.choice(s.i_train, size=n)
            sel = self.rng.randint(0, s.H * s.W, size=n)
            r, c = sel // s.W, sel % s.W
            rays = self._rays_at(img, r, c)
            rays.near = np.full((n, 1), s.near, np.float32)
            rays.far = np.full((n, 1), s.far, np.float32)
        else:
            img = int(self.rng.choice(s.i_train))
            ps, n_random = 16, max(0, cfg.N_rand)
            coords = []
            if mode == "single_image_patch":
                for _ in range(4):
                    r0 = self.rng.randint(0, s.H - ps + 1)
                    c0 = self.rng.randint(0, s.W - ps + 1)
                    rr, cc = np.meshgrid(np.arange(r0, r0 + ps),
                                         np.arange(c0, c0 + ps),
                                         indexing="ij")
                    coords.append(np.stack([rr, cc], -1).reshape(-1, 2))
            elif mode == "single_image":
                n_random += 4 * ps * ps
            else:
                raise ValueError(f"Unknown batching mode {mode!r}")
            if n_random:
                sel = self.rng.randint(0, s.H * s.W, size=n_random)
                coords.append(np.stack([sel // s.W, sel % s.W], -1))
            coords = np.concatenate(coords, 0)
            r, c = coords[:, 0], coords[:, 1]
            rays = self._rays_at(img, r, c)
        batch = {
            "rays": rays,
            "rgb": s.images[img, r, c].astype(np.float32),
            "dpts": s.depths[img, r, c].astype(np.float32),
            "masks": s.masks[img, r, c].astype(np.float32),
            "mono_dpts": s.mono_disp[img, r, c].astype(np.float32),
            "bounds": np.array([s.near, s.far], np.float32),
        }
        if self.random_poses is not None and cfg.load_random_rays:
            batch["rays_random"] = self._random_pose_patch_rays()
        if cfg.anneal_nearfar:
            near_i, far_i = rp.anneal_nearfar_values(
                self.step, s.near, s.far, cfg.anneal_nearfar_steps,
                cfg.anneal_nearfar_perc, cfg.anneal_mid_perc)
            for k in list(batch):
                if k.startswith("rays"):
                    batch[k] = rp.with_annealed_nearfar(
                        batch[k], near_i, far_i)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


class Prefetcher:
    """Thread + bounded queue prefetch (datasets.py:443-533 pattern).

    The producer makes ONE batch at a time and retries the put until it
    lands (or `close()` is called), so no batch is dropped and the
    consumed stream is exactly the batcher's stream: a seeded run gives
    the same batches with prefetch on or off. A batcher exception is
    captured and re-raised in the consumer's `__next__` (StopIteration as
    StopIteration, anything else as a RuntimeError from it). Every wait
    has a timeout; `close()` empties the queue so that a producer blocked
    on a full one ends at once, or after the batch it is making."""

    _POLL = 0.5  # seconds between the consumer's looks at the thread
    _PUT = 0.1  # seconds between the producer's looks at `close()`

    def __init__(self, batcher: Iterator, depth: int = 3):
        self.batcher = batcher
        self.queue: "queue.Queue" = queue.Queue(depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                batch = next(self.batcher)
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=self._PUT)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # surfaced in __next__
            self._error = exc

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                return self.queue.get(timeout=self._POLL)
            except queue.Empty:
                if self._error is not None:
                    err, self._error = self._error, None
                    if isinstance(err, StopIteration):
                        raise StopIteration
                    raise RuntimeError(
                        "Prefetcher batcher thread failed") from err
                if not self.thread.is_alive():
                    raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        """Stop the thread and wait for it (at most `timeout` seconds);
        the batches it made ahead are dropped."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self.queue.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(self._PUT)


def to_device(batch: Dict[str, object], device) -> Dict:
    """numpy batch -> tensors on `device` (scalars become 0-d tensors; a
    `Rays` bundle field by field)."""
    def move(v):
        return torch.as_tensor(np.asarray(v), device=device)

    return {k: v.map(move) if isinstance(v, Rays) else move(v)
            for k, v in batch.items()}
