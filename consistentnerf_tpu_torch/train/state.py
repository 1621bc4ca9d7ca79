"""Train state and optimizer of both trainers.

The JAX package's optax chain (`consistentnerf_tpu/train/state.py`) is
NaN scrub -> value clip (grad_max_val) -> global-norm clip (grad_max_norm,
off by default) -> Adam -> lr schedule -> x(-1). Here the two clips and the
scrub act on the `.grad`s in place and `torch.optim.Adam` takes the
schedule as its lr. The schedule reads the step count BEFORE the
increment, as `optax.scale_by_schedule` does: the first update uses
lr(0). The vanilla schedule is lr * 0.1^(step / (lrate_decay*1000))
(`run_nerf_view.py:329,1982-1993`); the mip schedule is the log-linear
decay from lr_init to lr_final with the sine warmup
(`RegNeRF/train.py:256-275`, `math.py:134`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List

import torch
from torch import nn

from consistentnerf_tpu_torch.core import mathx


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: "Optimizer"


def make_lr_schedule(cfg) -> Callable[[int], float]:
    if cfg.backbone == "vanilla":
        return lambda count: mathx.exp_lr_decay(count, cfg.lrate, 0.1,
                                                cfg.lrate_decay * 1000)
    return lambda count: mathx.learning_rate_decay(
        count, cfg.lr_init, cfg.lr_final, cfg.total_iters,
        cfg.lr_delay_steps, cfg.lr_delay_mult)


class Optimizer:
    """Gradient conditioning + Adam + schedule over a fixed parameter list.

    `step(count)` reads each parameter's `.grad` (a missing one counts as
    zeros, as a zero leaf of the JAX grad tree does) and updates the
    parameters in place with lr = schedule(count)."""

    def __init__(self, params: Iterable[torch.Tensor], cfg):
        self.params: List[torch.Tensor] = list(params)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.adam = torch.optim.Adam(
            self.params, lr=self.schedule(0), betas=(cfg.adam_b1,
                                                     cfg.adam_b2),
            eps=cfg.adam_eps)

    def condition_grads(self) -> List[torch.Tensor]:
        """NaN scrub, value clip and norm clip of the `.grad`s, in the
        chain's order. Returns the conditioned grads."""
        cfg = self.cfg
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if cfg.check_grad_for_nans:
            for g in grads:
                torch.nan_to_num_(g)
        if cfg.grad_max_val > 0:
            for g in grads:
                g.clamp_(-cfg.grad_max_val, cfg.grad_max_val)
        if cfg.grad_max_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < cfg.grad_max_norm,
                                torch.ones_like(norm),
                                cfg.grad_max_norm / norm)
            for g in grads:
                g.mul_(scale)
        return grads

    def step(self, count: int) -> None:
        self.condition_grads()
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(count)
        self.adam.step()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return self.adam.state_dict()

    def load_state_dict(self, sd) -> None:
        self.adam.load_state_dict(sd)


def make_optimizer(cfg, params: Iterable[torch.Tensor]) -> Optimizer:
    return Optimizer(params, cfg)


def create_train_state(cfg, model: nn.Module) -> TrainState:
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model.parameters()))


def sync_coarse_from_fine(model: nn.Module) -> nn.Module:
    """Vanilla trainer quirk: the coarse MLP starts as a copy of the fine
    MLP (`run_nerf_view.py:321`). In place; returns the model."""
    if hasattr(model, "coarse") and hasattr(model, "fine"):
        model.coarse.load_state_dict(model.fine.state_dict())
    return model
