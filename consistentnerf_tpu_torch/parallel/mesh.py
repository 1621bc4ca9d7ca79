"""Data parallelism over `torch.distributed`: one process per GPU.

The port of `consistentnerf_tpu/parallel/mesh.py`. There, a batch sharded
over a mesh is a layout choice only: jit computes the step on the global
batch. Here every rank holds the same seeded global batch and the same
global draws, computes the rows `data_slice` gives it, and the steps
rebuild every batch-global term from gathered rows
(`all_gather_rows`) or from the global batch itself; `reduce_grads` sums
the parameters' gradients over the data axis before the optimizer. R
ranks therefore compute the single-process step on the global batch,
within the reduction order.

The collectives are `all_reduce` and `broadcast` only: gloo takes CUDA
tensors for those two alone, and two ranks on one card need gloo (NCCL
refuses two ranks on one device). The tiled gather is an all-reduce of a
zero-filled [R*n, ...] buffer into which each rank writes its rows,
which is exact.

A process that is not part of a process group runs the same code on a
mesh of one rank whose collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Batch leaves that are never a ray axis, whatever their leading dim: the
# ss_loss reference view (`data/pipeline.py`), the intrinsics, the scene
# bounds and the pseudo-label scale. `rays_random` (the TV norm's
# random-pose rays) is sharded over its own ray count by the mip steps.
REPLICATED_KEYS = ("ref_image", "ref_depth", "ref_pose", "K", "bounds",
                   "loss_scale", "rays_random")
DATA_AXIS = "data"  # the axis the batch is sharded over
INIT_TIMEOUT = datetime.timedelta(minutes=10)


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device="cuda") -> bool:
    """Join the process group of a multi-process run: only when
    `num_processes > 1`, as the JAX function does; a no-op otherwise.
    `coordinator_address` is "host:port" of rank 0. `backend` defaults to
    NCCL for a `cuda` device and gloo for the CPU (the counterpart of the
    JAX function's gloo switch for CPU runs); naming it lets two ranks
    share one card over gloo. An unreachable coordinator raises (after `INIT_TIMEOUT`);
    nothing carries on as a single process. Returns whether this process
    is in a group of several ranks."""
    if num_processes is None or num_processes <= 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise ValueError(f"already in a group of {dist.get_world_size()}"
                             f" ranks, asked for {num_processes}")
        return True
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address "
                         "and process_id beside num_processes")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not a rank of "
                         f"{num_processes}")
    backend = backend or ("nccl" if torch.device(device).type == "cuda"
                          else "gloo")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs CUDA; pass --device cpu "
                           "for a CPU run over gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=INIT_TIMEOUT)
    return True


def rank_device(device="cuda") -> torch.device:
    """This process's device: `cuda:{rank % device_count}` for a bare
    "cuda" in a process group (one process per GPU), else `device`."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and dist.is_initialized()):
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks laid out row-major on `shape`, named by `axis_names`.
    The batch is sharded over the `DATA_AXIS` axis and replicated over the
    other axes; `group` is this rank's data-axis process group (None: no
    collectives, a single process)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    data_size: int
    data_rank: int
    group: object = None

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    @property
    def active(self) -> bool:
        """Whether the collectives run: in a process group (a 1-rank one
        too, where each is a copy)."""
        return self.group is not None


def create_mesh(mesh_shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,),
                device="cuda") -> Mesh:
    """The mesh of this process's group (of this process alone outside
    one); default: a 1-D data axis over every rank. The product of
    `mesh_shape` must be the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    if mesh_shape is None:
        mesh_shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in mesh_shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh_shape {shape} does not match axis names "
                         f"{axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh_shape {shape} holds {math.prod(shape)} "
                         f"ranks; the group has {world}")
    if DATA_AXIS not in axis_names:
        raise ValueError(f"no {DATA_AXIS!r} axis in {axis_names}")
    ax = axis_names.index(DATA_AXIS)
    coords = np.unravel_index(rank, shape)
    group = None
    if dist.is_initialized():
        # Every rank makes every data-axis group (new_group is collective)
        # and keeps its own.
        grid = np.arange(world).reshape(shape)
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                group = g
    return Mesh(shape=shape, axis_names=axis_names, rank=rank,
                device=torch.device(device), data_size=shape[ax],
                data_rank=int(coords[ax]), group=group)


def batch_sharding(mesh: Mesh) -> Dict[str, object]:
    """The descriptor of a ray-sharded leaf: its rows split over the data
    axis, this rank's part `index` of `parts`."""
    return {"kind": "sharded", "parts": mesh.data_size,
            "index": mesh.data_rank}


def replicated_sharding(mesh: Mesh) -> Dict[str, object]:
    """The descriptor of a replicated leaf: whole on every rank."""
    return {"kind": "replicated"}


def data_slice(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of n global rows; n must divide the data axis."""
    if mesh is None or mesh.data_size == 1:
        return slice(0, n)
    if n % mesh.data_size:
        raise ValueError(f"{n} rays do not divide the {mesh.data_size} "
                         "ranks of the data axis")
    per = n // mesh.data_size
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def local_batch_slice(global_batch_size: int,
                      mesh: Optional[Mesh] = None) -> int:
    """Per-rank ray count of a global batch (of this process's group
    where no mesh is given)."""
    parts = (mesh.data_size if mesh is not None
             else dist.get_world_size() if dist.is_initialized() else 1)
    if global_batch_size % parts:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {parts} ranks")
    return global_batch_size // parts


def _rows(x) -> Optional[int]:
    shape = getattr(getattr(x, "origins", x), "shape", None)
    return int(shape[0]) if shape is not None and len(shape) >= 1 else None


def _take(x, sl):
    return x.map(lambda t: t[sl]) if hasattr(x, "map") else x[sl]


def leaf_sharding(batch: Dict[str, object],
                  mesh: Mesh) -> Dict[str, Dict[str, object]]:
    """Each leaf's descriptor: a leaf whose leading dim is the batch's ray
    count (`rgb`'s) is sharded, the rest, and `REPLICATED_KEYS` whatever
    their size, replicated. The JAX rule shards any leaf whose leading dim
    divides the axis; under its global-view jit that is a layout choice,
    but a slice here is another value (ROADMAP note E)."""
    n = _rows(batch["rgb"])
    return {k: batch_sharding(mesh)
            if k not in REPLICATED_KEYS and _rows(v) == n
            else replicated_sharding(mesh) for k, v in batch.items()}


def shard_batch(batch: Dict[str, object],
                mesh: Optional[Mesh]) -> Dict[str, object]:
    """This rank's part of a global batch: the sharded leaves of
    `leaf_sharding` sliced to `data_slice`, the others whole. Raises where
    the ray count does not divide the data axis."""
    if mesh is None or not mesh.active:
        return dict(batch)
    spec = leaf_sharding(batch, mesh)
    sl = data_slice(_rows(batch["rgb"]), mesh)
    return {k: _take(v, sl) if spec[k]["kind"] == "sharded" else v
            for k, v in batch.items()}


def shard_tree(tree, n: int, sl: slice):
    """The rows `sl` of every tensor of a (nested dict / list) tree whose
    leading dim is n (the global draws of a step); the rest unchanged."""
    return _map_tree(tree, lambda t: _take(t, sl) if torch.is_tensor(t)
                     and _rows(t) == n else t)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the data axis, in place; x on a single rank."""
    if mesh is not None and mesh.active:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


class _GatherRows(torch.autograd.Function):
    """The tiled gather. Every rank computes the same function of the
    gathered rows, so the cotangent of its own rows is its slice of the
    gathered cotangent: no collective in the backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        n = x.shape[0]
        buf = x.new_zeros((mesh.data_size * n,) + tuple(x.shape[1:]))
        buf[mesh.data_rank * n:(mesh.data_rank + 1) * n] = x
        return all_reduce_sum(buf, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        n = g.shape[0] // mesh.data_size
        return g[mesh.data_rank * n:(mesh.data_rank + 1) * n], None


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """[n, ...] rows of each rank -> [R*n, ...] in rank order on every
    rank, differentiable (the caller's loss must be the same on every
    rank). x itself on a single rank."""
    if mesh is None or not mesh.active:
        return x
    return _GatherRows.apply(x, mesh)


class _Slot:
    """A gathered leaf's place in the tree `gather_outputs` rebuilds."""

    def __init__(self, index: int):
        self.index = index


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def gather_outputs(tree, mesh: Optional[Mesh], n: int):
    """Every floating tensor of a (nested dict / list) tree whose leading
    dim is n (this rank's rows) gathered to the global rows, in one
    collective: the columns are packed into one fp32 buffer. The tree
    itself on a single rank."""
    if mesh is None or not mesh.active:
        return tree
    leaves = []

    def collect(t):
        if (torch.is_tensor(t) and t.is_floating_point() and t.ndim >= 1
                and t.shape[0] == n):
            leaves.append(t)
            return _Slot(len(leaves) - 1)
        return t

    skeleton = _map_tree(tree, collect)
    if not leaves:
        return tree
    widths = [math.prod(t.shape[1:]) for t in leaves]
    full = all_gather_rows(
        torch.cat([t.float().reshape(n, w) for t, w in zip(leaves, widths)],
                  1), mesh)
    out = [part.reshape((full.shape[0],) + tuple(t.shape[1:])).to(t.dtype)
           for part, t in zip(torch.split(full, widths, 1), leaves)]
    return _map_tree(skeleton,
                     lambda t: out[t.index] if isinstance(t, _Slot) else t)


def once(tree, mesh: Optional[Mesh]):
    """A term every rank computes whole: kept on data rank 0 and detached
    elsewhere, so that its gradient is added once by `reduce_grads`."""
    if mesh is None or not mesh.active or mesh.data_rank == 0:
        return tree
    return _map_tree(tree, lambda t: t.detach() if torch.is_tensor(t)
                     else t)


def reduce_grads(params: Sequence[torch.Tensor],
                 mesh: Optional[Mesh]) -> None:
    """Sum the parameters' `.grad`s over the data axis, in one collective
    (a missing grad counts as zeros). Called once a step, by
    `train/step.py::finish_step`."""
    if mesh is None or not mesh.active:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1).float() for g in grads]),
                          mesh)
    for p, part in zip(params, torch.split(flat,
                                           [g.numel() for g in grads])):
        p.grad = part.reshape(p.shape).to(p.dtype)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the group (an all-reduce of one element)."""
    if dist.is_initialized() and mesh is not None:
        x = torch.zeros(1, device=mesh.device)
        dist.all_reduce(x)


def broadcast_state(state, mesh: Optional[Mesh]) -> None:
    """Rank 0's step, parameters, buffers and optimizer moments on every
    rank, in place. Raises where the ranks restored different steps (a
    checkpoint directory that is not shared)."""
    if not dist.is_initialized() or mesh is None or mesh.world_size == 1:
        return
    step = torch.tensor([float(state.step)], device=mesh.device)
    mine = step.clone()
    dist.broadcast(step, 0)
    if int(step.item()) != int(mine.item()):
        raise RuntimeError(f"rank {mesh.rank} restored step "
                           f"{int(mine.item())}, rank 0 step "
                           f"{int(step.item())}: the ranks need one shared "
                           "checkpoint directory")
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    adam = state.optimizer.adam
    for p in state.optimizer.params:
        for k in sorted(adam.state.get(p, {})):
            v = adam.state[p][k]
            if torch.is_tensor(v):
                tensors.append(v)
    with torch.no_grad():
        for t in tensors:
            if t.device.type == "cpu" and mesh.device.type == "cuda":
                tmp = t.to(mesh.device)
                dist.broadcast(tmp, 0)
                t.copy_(tmp)
            else:
                dist.broadcast(t, 0)
