"""Test-set evaluation: render the test views and score them with the
reference metric suite (`RegNeRF/eval.py:137-290`,
`run_nerf_view.py:2034-2127`): PSNR, SSIM, MS-SSIM (images of at least
176 pixels a side), census error, LPIPS (VGG) and avg_err = geomean(MSE,
sqrt(1 - SSIM), LPIPS) where LPIPS is on, and the DTU-masked PSNR / SSIM
/ LPIPS where a view has an evaluation mask. Per-metric txt artifacts
are what the metric aggregator reads.

The metrics run on the render's device, queued behind the renders; the
scalars come back to the host once, after the last view. A group's PNGs
are written on a host thread while the next group is queued.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from consistentnerf_tpu_torch.core import mathx
from consistentnerf_tpu_torch.core import rays as rays_core
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.data.scene import SceneData
from consistentnerf_tpu_torch.ops import fused_mlp as fm
from consistentnerf_tpu_torch.train import image_metrics
from consistentnerf_tpu_torch.train import render as render_lib
from consistentnerf_tpu_torch.train.lpips import LPIPS

# The smallest side MS-SSIM's five scales take.
MS_SSIM_MIN_SIDE = 176


def camera_rays_for_view(scene: SceneData, pose, render_factor: int = 0,
                         device="cuda") -> Rays:
    """Rays for one camera; render_factor > 1 renders downsampled."""
    h, w, k, focal = scene.H, scene.W, scene.K, scene.focal
    if render_factor and render_factor > 1:
        h, w = h // render_factor, w // render_factor
        k = np.asarray(k).copy()
        k[:2] = k[:2] / render_factor
        focal = focal / render_factor
    return rays_core.camera_rays(
        h, w, k, np.asarray(pose)[:3, :4], scene.near, scene.far,
        use_ndc=scene.use_ndc, ndc_focal=focal, device=device,
    )


def image_metric_values(pred: torch.Tensor, gt: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        lpips_fn: Optional[LPIPS] = None
                        ) -> Dict[str, torch.Tensor]:
    """The metric suite of one view ([H, W, 3] tensors in [0, 1], mask
    [H, W]) as 0-dim tensors on their device, nothing read back; in full
    fp32 on a card (no TF32)."""
    fm.strict_fp32(pred.device)
    out = {}
    out["psnr"] = image_metrics.psnr(pred, gt)
    out["ssim"] = image_metrics.ssim(pred[None], gt[None])[0]
    if min(pred.shape[0], pred.shape[1]) >= MS_SSIM_MIN_SIDE:
        out["ms_ssim"] = image_metrics.ms_ssim(pred[None], gt[None])[0]
    out["census_err"] = mathx.compute_census_err(pred, gt,
                                                 epsilon=1.0 / 255)
    if lpips_fn is not None:
        out["lpips"] = lpips_fn(pred, gt)[0]
        out["avg_err"] = mathx.compute_avg_error(out["psnr"], out["ssim"],
                                                 out["lpips"])
    if mask is not None:
        out["masked_psnr"] = image_metrics.masked_psnr(pred, gt, mask)
        # Masked SSIM / LPIPS: both images on black outside the mask (the
        # DTU-masked convention of RegNeRF eval.py:190-225).
        pm, gm = pred * mask[..., None], gt * mask[..., None]
        out["masked_ssim"] = image_metrics.ssim(pm[None], gm[None])[0]
        if lpips_fn is not None:
            out["masked_lpips"] = lpips_fn(pm, gm)[0]
    return out


def compute_image_metrics(pred, gt, lpips_fn: Optional[LPIPS] = None,
                          mask=None) -> Dict[str, float]:
    """All metrics of one (pred, gt) pair of [H, W, 3] images in [0, 1]:
    tensors on their device, numpy arrays on the CPU."""

    def tensor(x):
        if x is None or isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x, np.float32))

    with torch.no_grad():
        vals = image_metric_values(tensor(pred), tensor(gt), tensor(mask),
                                   lpips_fn)
    return {k: float(v) for k, v in vals.items()}


def _idr_masks(cfg, scene: SceneData):
    """DTU: the IDR evaluation masks by test view, where `dtu_mask_path`
    holds them (RegNeRF eval.py:190-225 via datasets._load_masks).

    Masks the size of the dataset's images are brought to the DTU
    loader's crop (half resolution by INTER_NEAREST, rows 44:556, cols
    80:720), as the images and GT depths are; the JAX package scores them
    as they are, which fails on the cropped images (ROADMAP Queue 3 note
    E). Masks of any other size than the images' raise."""
    if (cfg.dataset_type != "dtu" or cfg.dtu_no_mask_eval
            or not cfg.dtu_mask_path or not os.path.isdir(cfg.dtu_mask_path)):
        return None
    from consistentnerf_tpu_torch.data import dtu, images

    scan = os.path.basename(os.path.normpath(cfg.datadir))
    try:
        idr = dtu.load_idr_masks(cfg.dtu_mask_path, scan, cfg.factor)
    except FileNotFoundError:
        return None
    idr = idr[..., 0]
    r0, r1, c0, c1 = dtu.CROP
    if (idr.shape[1:] != (scene.H, scene.W)
            and (r1 - r0, c1 - c0) == (scene.H, scene.W)
            and idr.shape[1] // 2 >= r1 and idr.shape[2] // 2 >= c1):
        idr = np.stack([images.resize(m, None, fx=0.5, fy=0.5,
                                      interpolation=images.INTER_NEAREST)
                        [r0:r1, c0:c1] for m in idr])
    if idr.shape[1:] != (scene.H, scene.W):
        raise ValueError(
            f"IDR masks of {idr.shape[1:]} for {scene.H}x{scene.W} images "
            f"(dtu_mask_path={cfg.dtu_mask_path!r}, factor={cfg.factor})")
    return {int(v): idr[i] for i, v in enumerate(scene.i_test[: len(idr)])}


def selected_views(cfg, views) -> List[Tuple[int, int]]:
    """(n, view) of the views evaluate() renders: every
    `cfg.eval_render_interval`-th of `views`."""
    return [(n, vi) for n, vi in enumerate(views)
            if n % max(1, cfg.eval_render_interval) == 0]


def views_per_call(cfg, device, n_views: int) -> int:
    """Views evaluate() renders in one call: `cfg.eval_views_per_call`
    (0: 1 on the CPU, 4 on a card), at most half of `n_views` rounded up,
    so two groups at least leave a warm window."""
    g = int(cfg.eval_views_per_call or 0)
    if g <= 0:
        g = 1 if torch.device(device).type == "cpu" else 4
    return max(1, min(g, (n_views + 1) // 2)) if n_views else g


def render_groups(render, scene: SceneData,
                  selected: Sequence[Tuple[int, int]], g: int,
                  device) -> Iterator[Tuple[list, list]]:
    """Render `selected` g views a call, as evaluate() does: yield each
    group with its views' outputs (dicts of [H, W, ...] tensors). A ragged
    last group repeats its last view, so every call renders g views; the
    repeats are dropped here."""
    for s in range(0, len(selected), g):
        group = list(selected[s: s + g])
        rl = [camera_rays_for_view(scene, scene.poses[vi], device=device)
              for _, vi in group]
        rl += [rl[-1]] * (g - len(rl))
        out = render(render_lib.stack_rays(rl) if g > 1 else rl[0])
        yield group, [{k: v[j] for k, v in out.items()} if g > 1 else out
                      for j in range(len(group))]


# The outputs a view's PNGs are made of.
_SAVED = ("rgb", "depth", "acc", "normals")


def _to_host(views: List[Dict[str, torch.Tensor]]):
    """The saved outputs of a group's views on the host. On a card, each is
    copied into pinned memory behind the work queued so far, and an event
    marks the copies' end: the next group can be queued before they land,
    and the writer waits for this group's copies only."""
    if views[0]["rgb"].device.type != "cuda":
        return [{k: v for k, v in view.items() if k in _SAVED}
                for view in views], None
    host = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(
                v, non_blocking=True)
             for k, v in view.items() if k in _SAVED} for view in views]
    done = torch.cuda.Event()
    done.record()
    return host, done


def _save_group(out_dir: str, group, host, done) -> None:
    """Write a group's PNGs once its copies have landed (on the writer
    thread)."""
    if done is not None:
        done.synchronize()
    for (n, _), view in zip(group, host):
        _save_view(out_dir, n, {k: v.numpy() for k, v in view.items()})


def _save_view(out_dir: str, n: int, outs: Dict[str, np.ndarray]) -> None:
    from consistentnerf_tpu_torch.train import vis

    vis.save_img_u8(outs["rgb"], os.path.join(out_dir, f"color_{n:03d}.png"))
    vis.save_img_u8(vis.visualize_depth(outs["depth"], outs["acc"]),
                    os.path.join(out_dir, f"depth_{n:03d}.png"))
    vis.save_img_u8(np.repeat(np.clip(outs["acc"], 0, 1)[..., None], 3, -1),
                    os.path.join(out_dir, f"acc_{n:03d}.png"))
    if "normals" in outs:
        vis.save_img_u8(vis.visualize_normals(outs["normals"], outs["acc"]),
                        os.path.join(out_dir, f"normals_{n:03d}.png"))


def evaluate(
    model,
    cfg,
    scene: SceneData,
    out_dir: Optional[str] = None,
    views: Optional[np.ndarray] = None,
    save_images: bool = True,
    step: int = 0,
) -> Dict[str, float]:
    """Render and score the test views on the model's device; write the
    per-metric txt artifacts (and, with `save_images` and
    `cfg.eval_save_output`, each view's PNGs) under `out_dir`.

    Views render `views_per_call` at a time, every
    `cfg.eval_render_interval`-th one. `eval_rays_per_sec` is measured
    over the groups after the first, which stays outside the window (the
    first launches and their allocations, and its PNGs), masked views or
    not; the window closes with one synchronize after the last group."""
    device = next(model.parameters()).device
    views = scene.i_test if views is None else views
    lpips_fn = (None if cfg.eval_disable_lpips
                else LPIPS(cfg.lpips_weights_path, device=device))
    idr_masks = _idr_masks(cfg, scene)
    render = render_lib.build_render_fn(model, cfg)

    def view_mask(vi):
        if cfg.dataset_type == "dtu" and not cfg.dtu_no_mask_eval:
            if idr_masks is not None and int(vi) in idr_masks:
                return idr_masks[int(vi)]
            if scene.masks is not None:
                return scene.masks[vi]
        return None

    def on_device(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    selected = selected_views(cfg, views)
    g = views_per_call(cfg, device, len(selected))
    n_groups = -(-len(selected) // g)
    save_artifacts = bool(out_dir) and save_images and cfg.eval_save_output
    if save_artifacts:
        os.makedirs(out_dir, exist_ok=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dev_metrics: List[Dict[str, torch.Tensor]] = []
    warm_rays, t_warm = 0, None
    # A group's PNGs are written on a thread while the next group is
    # queued: the renders keep the host busy launching, so writing them
    # in turn would stall the card.
    written = None
    with torch.no_grad(), ThreadPoolExecutor(1) as writer:
        for i, (group, outs) in enumerate(
                render_groups(render, scene, selected, g, device)):
            for (n, vi), view in zip(group, outs):
                mk = view_mask(vi)
                dev_metrics.append(image_metric_values(
                    torch.clamp(view["rgb"], 0, 1), on_device(scene.images[vi]),
                    None if mk is None else on_device(mk), lpips_fn))
            if save_artifacts:
                host = _to_host(outs)
                if written is not None:
                    written.result()
                written = writer.submit(_save_group, out_dir, group, *host)
            if i == 0:
                # The first group, its PNGs too, stays outside the window.
                if written is not None:
                    written.result()
                    written = None
                sync()
                t_warm = time.perf_counter()
            else:
                warm_rays += len(group) * scene.H * scene.W
        if written is not None:
            written.result()
        sync()
        warm_secs = time.perf_counter() - t_warm if n_groups > 1 else 0.0
        flat = (torch.stack([v for m in dev_metrics for v in m.values()])
                .cpu().tolist() if dev_metrics else [])
    per_view, at = [], 0
    for m in dev_metrics:
        per_view.append(dict(zip(m, flat[at: at + len(m)])))
        at += len(m)

    agg = {}
    if per_view:
        for k in sorted(set().union(*per_view)):
            agg[k] = float(np.mean([m[k] for m in per_view if k in m]))
        if warm_secs > 0:
            agg["eval_rays_per_sec"] = float(warm_rays / warm_secs)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        # Per-metric txt dumps (eval.py:286-290 interface).
        for k, v in agg.items():
            with open(os.path.join(out_dir, f"metric_{k}_{step}.txt"),
                      "w") as f:
                f.write(f"{v}\n")
        with open(os.path.join(out_dir, "metrics.txt"), "w") as f:
            for k, v in agg.items():
                f.write(f"{k}: {v}\n")
        if lpips_fn is not None and not lpips_fn.is_calibrated:
            with open(os.path.join(out_dir, "LPIPS_UNCALIBRATED.txt"),
                      "w") as f:
                f.write(
                    "LPIPS computed with randomly initialized VGG weights "
                    "(lpips_weights_path names no file); values are "
                    "relative only. Calibrated weights are the .npz that "
                    "consistentnerf_tpu/cli/export_lpips_weights.py "
                    "writes.\n")
    return agg
