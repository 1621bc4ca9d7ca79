"""Per-scene training and inference of the MVS depth prior (port of
`consistentnerf_tpu/train/mvs.py`).

The plane-sweep network of `models/mvs.py` is fit on the scene's own
train views, supervised by depth only where the scene's depths are ground
truth (`depth_is_gt`: DTU scans, the synthetic scene), photometrically
and with edge-aware smoothness otherwise, and its depth maps then feed
the consistency pipeline (fusion, hard masks, depth loss) as external
PFMs would. A step trains one (reference, sources) triple, round-robin
over the train views, with Adam (optax's `adam`: eps 1e-8 outside the
square root). The image, pose and depth stacks live on the device; a
step gathers its views there.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from consistentnerf_tpu_torch.models import mvs as mvs_lib
from consistentnerf_tpu_torch.ops import fused_mlp as fm


@dataclasses.dataclass
class MVSTrainResult:
    params: dict  # the MVSDepthNet state_dict, in host memory
    final_loss: float
    steps: int


def _edge_aware_smoothness(depth: torch.Tensor, img: torch.Tensor,
                           near: float, far: float) -> torch.Tensor:
    """Mean |d normalized depth| weighted down across image edges."""
    d = (depth - near) / max(far - near, 1e-6)
    dx = torch.abs(d[:, 1:] - d[:, :-1])
    dy = torch.abs(d[1:, :] - d[:-1, :])
    ix = torch.exp(-torch.mean(torch.abs(img[:, 1:] - img[:, :-1]), -1))
    iy = torch.exp(-torch.mean(torch.abs(img[1:, :] - img[:-1, :]), -1))
    return torch.mean(dx * ix) + torch.mean(dy * iy)


def _mvs_loss(cfg, out: Dict, ref_img, src_imgs, c2w_ref, c2w_srcs, K,
              gt_depth: Optional[torch.Tensor], near: float, far: float):
    """Supervised + photometric + smoothness objective of one triple."""
    depth = out["depth"]
    stats = {}
    loss = 0.0

    if gt_depth is not None:
        valid = (gt_depth > 0).float()
        denom = torch.clamp(valid.sum(), min=1.0)
        l1 = torch.sum(torch.abs(depth - gt_depth) * valid) / denom
        # jax.image.resize "nearest" takes half-pixel centres.
        gt_lo = F.interpolate(gt_depth[None, None],
                              size=tuple(out["depth_lo"].shape),
                              mode="nearest-exact")[0, 0]
        valid_lo = (gt_lo > 0).float()
        l1_lo = torch.sum(torch.abs(out["depth_lo"] - gt_lo) * valid_lo) / (
            torch.clamp(valid_lo.sum(), min=1.0))
        loss = loss + l1 + 0.5 * l1_lo
        stats["sup_l1"] = l1

    if cfg.mvs_photo_weight > 0:
        # Every source view in one batched warp; the mean over views.
        warped, valid = mvs_lib.warp_src_to_ref(src_imgs, depth, c2w_ref,
                                                c2w_srcs, K)
        v = valid.float()[..., None]
        err = torch.sum(torch.abs(warped - ref_img * v), (1, 2, 3)) / (
            torch.clamp(torch.sum(v, (1, 2, 3)) * 3.0, min=1.0))
        photo = torch.mean(err)
        loss = loss + cfg.mvs_photo_weight * photo
        stats["photo"] = photo

    if cfg.mvs_smooth_weight > 0:
        smooth = _edge_aware_smoothness(depth, ref_img, near, far)
        loss = loss + cfg.mvs_smooth_weight * smooth
        stats["smooth"] = smooth

    return loss, stats


def _scene_bounds(cfg, scene):
    """The loaders' per-dataset near / far, else the config's."""
    near = float(getattr(scene, "near", None) or cfg.near)
    far = float(getattr(scene, "far", None) or cfg.far)
    return near, far


def make_net(cfg, device="cuda") -> mvs_lib.MVSDepthNet:
    """The configured MVSDepthNet on `device`, seeded as the JAX package
    seeds it (a fixed key, whatever cfg.seed says)."""
    net = mvs_lib.MVSDepthNet(cfg.mvs_num_depths, cfg.mvs_base_ch,
                              cfg.compute_dtype)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net.to(device)


def _scene_tensors(scene, device):
    images = torch.as_tensor(
        np.asarray(scene.images[..., :3], np.float32), device=device)
    poses = torch.as_tensor(
        np.asarray(scene.poses, np.float32)[:, :3, :4], device=device)
    K = torch.as_tensor(np.asarray(scene.K, np.float32), device=device)
    return images, poses, K


def build_mvs_train_step(cfg, scene, use_gt: bool, device="cuda"):
    """Returns (step, net, optimizer).

    step(ref_idx, src_idx) -> (loss, stats) trains the net in place on
    one triple; the image / pose / depth stacks are on `device` and the
    views are gathered there. fp32 runs in full fp32 (no TF32)."""
    device = torch.device(device)
    fm.strict_fp32(device)
    net = make_net(cfg, device)
    images, poses, K = _scene_tensors(scene, device)
    depths = (torch.as_tensor(np.asarray(scene.depths, np.float32),
                              device=device)
              if use_gt and scene.depths is not None else None)
    near, far = _scene_bounds(cfg, scene)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.mvs_lr, eps=1e-8)

    def step(ref_idx, src_idx):
        ref = int(ref_idx)
        src = torch.as_tensor(np.asarray(src_idx), dtype=torch.long,
                              device=device)
        opt.zero_grad(set_to_none=True)
        out = net(images[ref], images[src], poses[ref], poses[src], K,
                  near, far)
        gt = depths[ref] if depths is not None else None
        loss, stats = _mvs_loss(cfg, out, images[ref], images[src],
                                poses[ref], poses[src], K, gt, near, far)
        loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in stats.items()}

    return step, net, opt


def train_mvs_depth(cfg, scene, num_steps: int,
                    log_fn: Callable[[str], None] = print,
                    log_every: int = 100, device="cuda") -> MVSTrainResult:
    """Fit the MVS net on the scene's train views.

    Supervision: GT depth when the scene carries ground truth
    (`depth_is_gt`) and cfg.mvs_supervise_gt is set; photometric
    otherwise, so loaded priors never supervise the net meant to replace
    them. Each step trains one (ref, sources) triple, round-robin over the
    train views."""
    i_train = np.asarray(scene.i_train)
    has_gt = (
        cfg.mvs_supervise_gt
        and getattr(scene, "depth_is_gt", False)
        and scene.depths is not None
        and float(np.max(np.asarray(scene.depths)[i_train])) > 0
    )
    if len(i_train) < cfg.mvs_n_src + 1:
        raise ValueError(
            f"MVS prior needs >= {cfg.mvs_n_src + 1} train views, "
            f"got {len(i_train)}")
    step, net, _ = build_mvs_train_step(cfg, scene, use_gt=has_gt,
                                        device=device)
    srcs = {int(r): mvs_lib.select_source_views(
        np.asarray(scene.poses), i_train, int(r), cfg.mvs_n_src)
        for r in i_train}
    log_fn(f"mvs: training {num_steps} steps on {len(i_train)} views "
           f"({'GT-supervised' if has_gt else 'photometric self-supervised'})")
    loss = torch.tensor(float("nan"))
    for it in range(num_steps):
        ref = int(i_train[it % len(i_train)])
        loss, stats = step(ref, srcs[ref])
        if log_every and (it % log_every == 0 or it == num_steps - 1):
            extras = " ".join(f"{k}={float(v):.4f}" for k, v in stats.items())
            log_fn(f"mvs step {it}/{num_steps} loss={float(loss):.4f} "
                   f"{extras}")
    return MVSTrainResult(
        params={k: v.detach().cpu() for k, v in net.state_dict().items()},
        final_loss=float(loss), steps=num_steps)


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN's deterministic algorithms (and no autotuning) inside, the
    flags as they were after. By default cuDNN may run the cost volume's
    transposed 3D convolutions (cuDNN's backward-data) with atomic adds,
    whose order varies from launch to launch; a conf that moves by an ulp
    across `mvs_conf_thresh` then turns a pixel's whole depth prior on or
    off, so two predicts from the same net would disagree."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def view_predictor(cfg, scene, params, conf_thresh: Optional[float] = None,
                   device="cuda"):
    """predict_depth_priors' set-up (the net from the MVSDepthNet
    state_dict `params`, the scene's stacks on `device`); returns
    predict(ref) -> the depth prior [H, W] of train view `ref` (numpy).

    Pixels under the confidence threshold drop to zero depth, the "no
    prior" convention of the MVS PFMs that the masks and the depth loss
    both honour. The forward runs under `deterministic_cudnn`, so a
    second predict from the same params gives the same bits."""
    conf_thresh = cfg.mvs_conf_thresh if conf_thresh is None else conf_thresh
    device = torch.device(device)
    fm.strict_fp32(device)
    net = make_net(cfg, device)
    net.load_state_dict(params)
    net.eval()
    i_train = np.asarray(scene.i_train)
    images, poses, K = _scene_tensors(scene, device)
    near, far = _scene_bounds(cfg, scene)

    @torch.no_grad()
    def predict(ref: int) -> np.ndarray:
        src = torch.as_tensor(mvs_lib.select_source_views(
            np.asarray(scene.poses), i_train, ref, cfg.mvs_n_src),
            dtype=torch.long, device=device)
        with deterministic_cudnn():
            pred = net(images[ref], images[src], poses[ref], poses[src],
                       K, near, far)
        return (pred["depth"] * (pred["conf"] >= conf_thresh)).cpu().numpy()

    return predict


def predict_depth_priors(cfg, scene, params,
                         conf_thresh: Optional[float] = None,
                         device="cuda") -> np.ndarray:
    """Depth priors [N, H, W] for every train view (zeros elsewhere), from
    the MVSDepthNet state_dict `params` (`view_predictor`)."""
    predict = view_predictor(cfg, scene, params, conf_thresh, device)
    out = np.zeros(scene.images.shape[:3], np.float32)
    for ref in np.asarray(scene.i_train):
        out[int(ref)] = predict(int(ref))
    return out
