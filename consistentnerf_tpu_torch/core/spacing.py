"""Sample spacing curves and stratified jitter along a ray.

`genspace` generalizes linspace / geomspace / lindisp like
`RegNeRF/internal/spacing.py:21-53`, with explicit (fn, inv_fn) pairs for
the named curves.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

# Named curves: name -> (fn, inv_fn).
_CURVES: dict = {
    "linear": (lambda x: x, lambda x: x),
    "log": (torch.log, torch.exp),
    "reciprocal": (torch.reciprocal, torch.reciprocal),
    "sqrt": (torch.sqrt, torch.square),
}

CurveSpec = Union[None, str, Tuple[Callable, Callable]]


def resolve_curve(fn: CurveSpec) -> Tuple[Callable, Callable]:
    """A curve spec (None, a name or an (fn, inv_fn) pair) -> the pair."""
    if fn is None:
        return _CURVES["linear"]
    if isinstance(fn, str):
        if fn not in _CURVES:
            raise ValueError(f"Unknown spacing curve {fn!r}; have "
                             f"{list(_CURVES)}")
        return _CURVES[fn]
    if callable(fn):
        for f, inv in _CURVES.values():
            if fn is f:
                return f, inv
        raise ValueError("Callable curves must be passed as an explicit "
                         "(fn, inv_fn) tuple.")
    fwd, inv = fn
    return fwd, inv


def genspace(start: torch.Tensor, stop: torch.Tensor, num: int,
             fn: CurveSpec = None) -> torch.Tensor:
    """`num` points from start to stop along the curve `fn`; broadcasts
    over the leading dims of start/stop (samples on the last axis)."""
    fwd, inv = resolve_curve(fn)
    t = torch.linspace(0.0, 1.0, num, device=start.device,
                       dtype=start.dtype)
    s = fwd(start) * (1.0 - t) + fwd(stop) * t
    return torch.clamp(inv(s), torch.minimum(start, stop),
                       torch.maximum(start, stop))


def stratify(t_vals: torch.Tensor,
             t_rand: Optional[torch.Tensor]) -> torch.Tensor:
    """Jitter samples within their mid-point intervals; `t_rand` in [0, 1)
    picks a point in each interval. None returns t_vals unchanged."""
    if t_rand is None:
        return t_vals
    mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
    upper = torch.cat([mids, t_vals[..., -1:]], -1)
    lower = torch.cat([t_vals[..., :1], mids], -1)
    return lower + (upper - lower) * t_rand
