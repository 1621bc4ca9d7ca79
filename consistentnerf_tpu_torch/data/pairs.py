"""The sparse-view split registry ('pairs'): `{scene}_{train,val,test}`
-> view indices. The port ships its own copy of the registry as
`assets/pairs.npz`; a reference `pairs.th` (a torch pickle) or a
`pairs.npy` / `.npz` loads too."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "pairs.npz")
_cache: Optional[Dict[str, np.ndarray]] = None


def load_pairs(path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The split registry (the bundled one by default)."""
    global _cache
    if path is None:
        if _cache is None:
            with np.load(_ASSET) as data:
                _cache = {k: v for k, v in data.items()}
        return _cache
    if path.endswith(".th"):
        d = torch.load(path, weights_only=False)
        return {
            k: np.asarray(
                v.numpy() if hasattr(v, "numpy") else [int(x) for x in v],
                dtype=np.int64,
            )
            for k, v in d.items()
        }
    if path.endswith((".npy", ".npz")):
        d = np.load(path, allow_pickle=True)
        if hasattr(d, "item") and d.dtype == object:
            d = d.item()
        return {k: np.asarray(v, np.int64) for k, v in dict(d).items()}
    raise ValueError(f"Unknown pairs registry format: {path}")


def get_split(scene: str, split: str, n_views: Optional[int] = None,
              path: Optional[str] = None) -> np.ndarray:
    """View indices of `{scene}_{split}`, the first n_views for train."""
    pairs = load_pairs(path)
    key = f"{scene}_{split}"
    if key not in pairs:
        raise KeyError(
            f"No split {key!r} in pairs registry (have e.g. "
            f"{sorted(pairs)[:6]}...)"
        )
    idx = pairs[key]
    if n_views is not None and split == "train":
        idx = idx[:n_views]
    return np.asarray(idx, np.int64)
