"""Train checkpoints with `torch.save`: step, model `state_dict` and
optimizer state, one file per saved step under
`{basedir}/{expname}/checkpoints/step_{step:08d}.pt`, the newest `keep`
kept. Resume restores the step and continues (the JAX package's orbax
manager, `consistentnerf_tpu/train/checkpoints.py`, has the same model).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

import torch

from consistentnerf_tpu_torch.train.state import TrainState

_NAME = re.compile(r"step_(\d+)\.pt$")


def checkpoint_steps(directory: str) -> List[int]:
    """Saved steps under `directory`, ascending."""
    steps = []
    for path in glob.glob(os.path.join(directory, "step_*.pt")):
        m = _NAME.search(path)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 100):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state: TrainState) -> str:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save({"step": int(step),
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp)
        os.replace(tmp, path)
        for old in checkpoint_steps(self.directory)[:-self.keep]:
            os.remove(self.path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def _load(self, step):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Restore the latest (or given) step into `state`, in place."""
        ckpt = self._load(step)
        if ckpt is None:
            return state
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state

    def restore_for_eval(self, model: torch.nn.Module,
                         step: Optional[int] = None) -> Optional[int]:
        """Load the params only (read-only consumers need no optimizer
        state). Returns the restored step, or None without a checkpoint."""
        ckpt = self._load(step)
        if ckpt is None:
            return None
        model.load_state_dict(ckpt["model"])
        return int(ckpt["step"])
