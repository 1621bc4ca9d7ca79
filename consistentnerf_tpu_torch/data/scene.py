"""The common in-memory scene container produced by every loader."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SceneData:
    """Everything a trainer or renderer needs, in host memory.

    Depth/masks/mono_disp may be zero arrays when priors are unavailable.
    """

    images: np.ndarray  # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray  # [N, 3, 4] c2w
    K: np.ndarray  # [3, 3]
    H: int
    W: int
    focal: float
    near: float
    far: float
    i_train: np.ndarray
    i_test: np.ndarray
    i_val: np.ndarray
    depths: Optional[np.ndarray] = None  # [N, H, W] depth prior
    # True only when `depths` are measured/analytic ground truth.
    depth_is_gt: bool = False
    masks: Optional[np.ndarray] = None  # [N, H, W] hard masks
    mono_disp: Optional[np.ndarray] = None  # [N, H, W] monocular disparity
    render_poses: Optional[np.ndarray] = None  # [M, 3, 4] or [M, 4, 4]
    use_ndc: bool = False
    bounds: Optional[np.ndarray] = None  # [N, 2] per-image near/far

    def ensure_priors(self) -> "SceneData":
        """Fill missing priors: zero depths and disparity, all-ones masks."""
        shape = self.images.shape[:3]
        if self.depths is None:
            self.depths = np.zeros(shape, np.float32)
        if self.masks is None:
            self.masks = np.ones(shape, np.float32)
        if self.mono_disp is None:
            self.mono_disp = np.zeros(shape, np.float32)
        return self
