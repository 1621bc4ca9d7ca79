"""Weights across packages.

`params_from_jax` turns the JAX package's vanilla param tree into the
port's `VanillaNeRF` state_dict, `mip_params_from_jax` /
`mip_params_to_jax` carry the mip param tree
(`params["params"]["MipMLP_0"]["Dense_i"]`) into a `MipNeRF` state_dict
and back; `add_flat_grads` / `flat_grads_to_named` map a flat
torch-layout grad list (the order of `ops/fused_mlp.flatten_params`, or
of `ops/fused_mip.flatten_mip_params` for a MipMLP) onto an MLP's
parameters; `load_reference_tar` reads a nerf-pytorch
`{step:06d}.tar` (the layout the JAX package's `cnerf-export-torch-ckpt`
writes, and the reference trainer's own). The name map is the
reference's layer names against the JAX module's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

# Reference (torch) layer name -> JAX (flax) layer name.
LINEAR_NAMES = {
    "alpha_linear": "alpha",
    "feature_linear": "feature",
    "rgb_linear": "rgb",
    "output_linear": "output",
    "views_linears.0": "views_0",
}
SCALARS = ("temp_rgb", "temp_depth", "depth_scale")
# Reference checkpoint key -> the port's level. `network_fn` is the COARSE
# model in the reference (run_nerf_view.py:367-372).
TAR_LEVELS = {"network_fn_state_dict": "coarse",
              "network_fine_state_dict": "fine"}


def mlp_state_from_jax(subtree: Mapping) -> Dict[str, torch.Tensor]:
    """One JAX NeRFMLP subtree -> a NeRFMLP state_dict. Flax [in, out]
    kernels become torch [out, in] weights."""
    names = {f"pts_linears.{i}": f"pts_{i}"
             for i in range(sum(k.startswith("pts_") for k in subtree))}
    names.update(LINEAR_NAMES)
    sd = {}
    for torch_name, jax_name in names.items():
        if jax_name not in subtree:
            continue
        entry = subtree[jax_name]
        sd[f"{torch_name}.weight"] = torch.tensor(
            np.asarray(entry["kernel"], np.float32).T)
        sd[f"{torch_name}.bias"] = torch.tensor(
            np.asarray(entry["bias"], np.float32))
    for name in SCALARS:
        if name in subtree:
            sd[name] = torch.tensor(
                np.asarray(subtree[name], np.float32).reshape(1))
    return sd


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': {'coarse': ..., 'fine': ...}} (numpy leaves) -> the
    port's VanillaNeRF state_dict."""
    tree = tree["params"] if "params" in tree else tree
    sd = {}
    for level, subtree in tree.items():
        for k, v in mlp_state_from_jax(subtree).items():
            sd[f"{level}.{k}"] = v
    return sd


def load_reference_tar(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference `.tar` -> (VanillaNeRF state_dict, global_step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    for key, level in TAR_LEVELS.items():
        for k, v in ckpt.get(key, {}).items():
            sd[f"{level}.{k}"] = v.float().reshape(v.shape or (1,))
    if not sd:
        raise ValueError(f"{path} holds no nerf-pytorch network state")
    return sd, int(ckpt.get("global_step", 0))


def mip_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': {'MipMLP_0': {'Dense_i': ...}}} (numpy leaves) -> the
    port's MipNeRF state_dict (`mlp.dense.i.weight` [out, in])."""
    tree = tree["params"] if "params" in tree else tree
    mlp = tree["MipMLP_0"]
    sd = {}
    for i in range(len(mlp)):
        entry = mlp[f"Dense_{i}"]
        sd[f"mlp.dense.{i}.weight"] = torch.tensor(
            np.asarray(entry["kernel"], np.float32).T)
        sd[f"mlp.dense.{i}.bias"] = torch.tensor(
            np.asarray(entry["bias"], np.float32))
    return sd


def mip_params_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A MipNeRF state_dict -> the JAX param tree (numpy leaves)."""
    mlp = {}
    n = sum(k.endswith(".weight") for k in sd)
    for i in range(n):
        mlp[f"Dense_{i}"] = {
            "kernel": sd[f"mlp.dense.{i}.weight"].detach().cpu().numpy().T,
            "bias": sd[f"mlp.dense.{i}.bias"].detach().cpu().numpy()}
    return {"params": {"MipMLP_0": mlp}}


def flat_param_names(net_depth: int, use_viewdirs: bool = True,
                     mip: bool = False) -> List[str]:
    """Parameter names of a NeRFMLP (or a MipMLP) in the flat order."""
    if mip:
        return [f"dense.{i}.{k}" for i in range(net_depth + 4)
                for k in ("weight", "bias")]
    names = [f"pts_linears.{i}" for i in range(net_depth)]
    names += (["alpha_linear", "feature_linear", "views_linears.0",
               "rgb_linear"] if use_viewdirs else ["output_linear"])
    return [f"{n}.{k}" for n in names for k in ("weight", "bias")]


def flat_grads_to_named(mlp: torch.nn.Module, grads: Sequence[torch.Tensor],
                        net_depth: int) -> Dict[str, torch.Tensor]:
    """Flat torch-layout grads -> {parameter name: grad} for every
    parameter of `mlp` (zeros for those the list does not cover, such as
    the temperature scalars), shaped like the parameters."""
    params = dict(mlp.named_parameters())
    names = flat_param_names(net_depth, getattr(mlp, "use_viewdirs", True),
                             mip=hasattr(mlp, "dense"))
    if len(names) != len(grads):
        raise ValueError(f"{len(grads)} grads for {len(names)} parameters")
    out = {k: torch.zeros_like(p) for k, p in params.items()}
    for name, g in zip(names, grads):
        out[name] = g.reshape(params[name].shape).to(params[name].dtype)
    return out


def add_flat_grads(mlp: torch.nn.Module, grads: Sequence[torch.Tensor],
                   net_depth: int) -> None:
    """Add flat torch-layout grads to the `.grad`s of `mlp`'s parameters."""
    named = flat_grads_to_named(mlp, grads, net_depth)
    for name, p in mlp.named_parameters():
        if p.grad is None:
            p.grad = named[name].clone()
        else:
            p.grad.add_(named[name])
