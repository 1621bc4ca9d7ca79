"""LPIPS (VGG16) perceptual distance, the JAX package's `train/lpips.py`
on torch: VGG16 conv features at relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3, unit-normalised per channel (eps on the norm, as the `lpips`
package's normalize_tensor), 1x1 linear heads, spatially averaged.

Calibrated weights are not in the repo: `load_weights(path)` reads the
`.npz` that the JAX package's `cli/export_lpips_weights.py` writes (HWIO
convs). Without one, `LPIPS` takes a seeded init of the JAX shapes and
scales, a valid but uncalibrated distance, and says so through
`is_calibrated`. The JAX init draws from threefry, which torch cannot
reproduce, so the two packages' uncalibrated values differ;
`interop.lpips_params_from_jax` carries the JAX params across."""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from consistentnerf_tpu_torch.ops import fused_mlp as fm

# VGG16 feature config: (out_channels, num_convs) per block.
_VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# The least image side with a pixel left for the last block (4 pools).
MIN_SIZE = 16

# The ImageNet normalisation of lpips.LPIPS (its scaling layer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, List]


def init_params(seed: int = 0) -> Params:
    """Seeded random params of the JAX shapes and scales (uncalibrated):
    convs N(0, 2 / (9 c_in)), zero biases, heads |N(0, 1)| * 0.01. Convs
    are torch's OIHW."""
    gen = torch.Generator().manual_seed(seed)
    params: Params = {"convs": [], "lins": []}
    c_in = 3
    for c_out, n_convs in _VGG_BLOCKS:
        block = []
        for _ in range(n_convs):
            w = torch.randn((c_out, c_in, 3, 3), generator=gen) * math.sqrt(
                2.0 / (9 * c_in))
            block.append({"w": w, "b": torch.zeros(c_out)})
            c_in = c_out
        params["convs"].append(block)
        params["lins"].append(torch.randn(c_out, generator=gen).abs() * 0.01)
    return params


def params_from_hwio(convs_hwio, lins) -> Params:
    """Params from HWIO conv kernels (the JAX and `.npz` layout):
    convs_hwio[block][i] = (w [3, 3, Cin, Cout], b [Cout])."""
    return {
        "convs": [[{"w": torch.tensor(np.asarray(w, np.float32)).permute(
                        3, 2, 0, 1).contiguous(),
                    "b": torch.tensor(np.asarray(b, np.float32))}
                   for w, b in block] for block in convs_hwio],
        "lins": [torch.tensor(np.asarray(x, np.float32)) for x in lins],
    }


def load_weights(path: str) -> Params:
    """Params from an `.npz` of converted lpips-vgg weights: conv{b}_{i}_w
    [3, 3, Cin, Cout] (HWIO), conv{b}_{i}_b [Cout], lin{b} [C]."""
    with np.load(path) as data:
        convs = [[(data[f"conv{bi}_{ci}_w"], data[f"conv{bi}_{ci}_b"])
                  for ci in range(n_convs)]
                 for bi, (_, n_convs) in enumerate(_VGG_BLOCKS)]
        lins = [data[f"lin{bi}"] for bi in range(len(_VGG_BLOCKS))]
    return params_from_hwio(convs, lins)


def save_weights(path: str, params: Params) -> None:
    """Write params as the `.npz` that `load_weights` reads (HWIO convs):
    the export format of calibrated weights."""
    arrays = {}
    for bi, block in enumerate(params["convs"]):
        for ci, conv in enumerate(block):
            arrays[f"conv{bi}_{ci}_w"] = conv["w"].detach().cpu().permute(
                2, 3, 1, 0).numpy()
            arrays[f"conv{bi}_{ci}_b"] = conv["b"].detach().cpu().numpy()
        arrays[f"lin{bi}"] = params["lins"][bi].detach().cpu().numpy()
    np.savez(path, **arrays)


def params_to(params: Params, device) -> Params:
    return {"convs": [[{k: v.to(device) for k, v in conv.items()}
                       for conv in block] for block in params["convs"]],
            "lins": [x.to(device) for x in params["lins"]]}


def _features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """VGG16 relu features [N, C, h, w] at the 5 LPIPS taps; x [N, H, W, 3]
    in [-1, 1]."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for bi, block in enumerate(params["convs"]):
        for conv in block:
            x = F.relu(F.conv2d(x, conv["w"], conv["b"], padding=1))
        feats.append(x)
        if bi < len(params["convs"]) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips(params: Params, img0: torch.Tensor,
          img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance of [N, H, W, 3] images in [-1, 1]: [N]."""
    total = 0.0
    eps = 1e-10
    for f0, f1, lin in zip(_features(params, img0), _features(params, img1),
                           params["lins"]):
        n0 = f0 / (torch.sqrt(torch.sum(f0**2, 1, keepdim=True)) + eps)
        n1 = f1 / (torch.sqrt(torch.sum(f1**2, 1, keepdim=True)) + eps)
        per_px = torch.sum((n0 - n1) ** 2 * lin[None, :, None, None], 1)
        total = total + torch.mean(per_px, dim=(-2, -1))
    return total


class LPIPS:
    """The distance with its weights (calibrated from `weights_path`, or
    the seeded init), on `device` (`cuda` unless the caller asks for the
    CPU); its convolutions in full fp32 on a card (cuDNN's TF32 is on by
    default)."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        fm.strict_fp32(torch.device(device))
        if weights_path and os.path.exists(weights_path):
            params = load_weights(weights_path)
            self.is_calibrated = True
        else:
            params = init_params(seed)
            self.is_calibrated = False
        self.params = params_to(params, device)

    @torch.no_grad()
    def __call__(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0 / img1 in [0, 1], [N, H, W, 3] or [H, W, 3]: [N]."""
        if img0.dim() == 3:
            img0, img1 = img0[None], img1[None]
        return lpips(self.params, img0 * 2 - 1, img1 * 2 - 1)
