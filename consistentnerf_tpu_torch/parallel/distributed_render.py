"""The sharded full-image render: each rank renders its shard of the rays
and the image is gathered on every rank.

The port of `consistentnerf_tpu/parallel/distributed_render.py` (the
counterpart of the reference's `pmap(render_fn)` + `all_gather` eval
path, `RegNeRF/train.py:332-346`). Each rank renders its rows through
`train/render.py::build_render_fn`'s chunk path (the fused kernels #1 or
#6 with `use_fused_render`), and `parallel/mesh.py::gather_outputs`
reassembles them. The outputs are `rgb`, `depth` and `acc`; for the mip
backbone `depth` is the last level's distance_mean and `acc` ones, as
the JAX function has them.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.parallel import mesh as mesh_lib
from consistentnerf_tpu_torch.train.render import build_render_fn


def build_sharded_render_fn(model, cfg, mesh: mesh_lib.Mesh
                            ) -> Callable[[Rays], Dict[str, torch.Tensor]]:
    """render(rays[N, ...]) with the ray axis sharded over the data axis:
    N must divide it. Returns the whole [N, ...] outputs on every rank."""
    render_fn = build_render_fn(model, cfg)

    @torch.no_grad()
    def render(rays: Rays) -> Dict[str, torch.Tensor]:
        n = rays.origins.shape[0]
        sl = mesh_lib.data_slice(n, mesh)
        out = render_fn(rays.map(lambda x: x[sl]))
        local = {"rgb": out["rgb"], "depth": out["depth"]}
        local["acc"] = (torch.ones_like(out["depth"])
                        if cfg.backbone == "mipnerf" else out["acc"])
        return mesh_lib.gather_outputs(local, mesh, sl.stop - sl.start)

    return render


def render_image_sharded(model, cfg, rays: Rays, mesh: mesh_lib.Mesh
                         ) -> Dict[str, np.ndarray]:
    """A full image ([H, W] rays) rendered over the mesh; the rays are
    padded with repeats of the last ray to a multiple of the data axis."""
    h, w = rays.origins.shape[:2]
    n = h * w
    flat = rays.map(lambda x: x.reshape(-1, x.shape[-1]))
    pad = (-n) % mesh.data_size
    if pad:
        flat = flat.map(lambda x: torch.cat([x, x[-1:].expand(pad, -1)], 0))
    out = build_sharded_render_fn(model, cfg, mesh)(flat)
    return {k: v[:n].reshape((h, w) + tuple(v.shape[1:])).cpu().numpy()
            for k, v in out.items()}
