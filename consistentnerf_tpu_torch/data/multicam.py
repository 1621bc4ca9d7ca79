"""The multicam (mip-NeRF multiscale Blender) dataset.

The port of `consistentnerf_tpu/data/multicam.py`, with the semantics of
`RegNeRF/internal/datasets.py:Multicam` (:932-1026): a metadata.json of
per-image pix2cam / cam2world / width / height / lossmult / near / far,
images at several scales, rays that carry their image's lossmult so the
multiscale loss weighs the coarse copies down. The PNGs are read by
`data/images.py`. Image sizes differ per view, so batches are drawn from
the flattened global ray pool (the reference's `all_images` batching).
Rays and batches are numpy, as the other batchers' (`data/pipeline.py`);
the trainer moves them to the device.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data.images import imread


class MulticamDataset:
    def __init__(self, data_dir: str, split: str = "train",
                 white_background: bool = True):
        with open(os.path.join(data_dir, "metadata.json")) as fp:
            meta = json.load(fp)[split]
        self.meta = {k: np.array(meta[k]) for k in meta}
        images = []
        for fbase in self.meta["file_path"]:
            image = imread(os.path.join(data_dir, str(fbase))).astype(
                np.float32) / 255.0
            if white_background and image.shape[-1] == 4:
                image = image[..., :3] * image[..., -1:] + (
                    1.0 - image[..., -1:])
            images.append(image[..., :3])
        self.images = images
        self.n_examples = len(images)
        self._generate_rays()

    def _generate_rays(self):
        pix2cam, cam2world = self.meta["pix2cam"], self.meta["cam2world"]

        def res2grid(w, h):
            return np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                               np.arange(h, dtype=np.float32) + 0.5,
                               indexing="xy")

        xy = [res2grid(w, h) for w, h in zip(self.meta["width"],
                                              self.meta["height"])]
        pixel_dirs = [np.stack([x, y, np.ones_like(x)], axis=-1)
                      for x, y in xy]
        camera_dirs = [v @ p2c[:3, :3].T
                       for v, p2c in zip(pixel_dirs, pix2cam)]
        directions = [v @ c2w[:3, :3].T
                      for v, c2w in zip(camera_dirs, cam2world)]
        origins = [np.broadcast_to(c2w[:3, -1], v.shape)
                   for v, c2w in zip(directions, cam2world)]
        viewdirs = [v / np.linalg.norm(v, axis=-1, keepdims=True)
                    for v in directions]

        def bsa(x):
            return [np.broadcast_to(x[i], origins[i][..., :1].shape)
                    for i in range(self.n_examples)]

        dx = [np.sqrt(np.sum((v[:-1, :, :] - v[1:, :, :]) ** 2, -1))
              for v in directions]
        dx = [np.concatenate([v, v[-2:-1, :]], axis=0) for v in dx]
        radii = [v[..., None] * 2 / np.sqrt(12) for v in dx]
        self.rays = Rays(origins=origins, directions=directions,
                         viewdirs=viewdirs, radii=radii,
                         lossmult=bsa(self.meta["lossmult"]),
                         near=bsa(self.meta["near"]),
                         far=bsa(self.meta["far"]))

    def flat_pool(self) -> Dict[str, object]:
        """The flattened global ray pool of `all_images` batching."""

        def flat(xs, dim):
            return np.concatenate([np.asarray(y).reshape(-1, dim)
                                   for y in xs], 0).astype(np.float32)

        dims = {"radii": 1, "lossmult": 1, "near": 1, "far": 1}
        return {"rgb": flat(self.images, 3),
                "rays": Rays(**{
                    f: flat(getattr(self.rays, f), dims.get(f, 3))
                    for f in ("origins", "directions", "viewdirs", "radii",
                              "lossmult", "near", "far")})}


class MulticamBatcher:
    """`all_images` ray batches over the multiscale pool, from
    `np.random.RandomState(seed)` as the JAX batcher draws them."""

    def __init__(self, dataset: MulticamDataset, batch_size: int,
                 seed: int = 0):
        self.pool = dataset.flat_pool()
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self.n = self.pool["rgb"].shape[0]

    def next_batch(self) -> Dict[str, object]:
        idx = self.rng.randint(0, self.n, size=self.batch_size)
        rays = self.pool["rays"].map(lambda x: x[idx])
        return {
            "rays": rays,
            "rgb": self.pool["rgb"][idx],
            "dpts": np.zeros(self.batch_size, np.float32),
            "masks": np.ones(self.batch_size, np.float32),
            "mono_dpts": np.zeros(self.batch_size, np.float32),
            "bounds": np.array([float(rays.near.min()),
                                float(rays.far.max())], np.float32),
        }

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()
