"""Process groups over a mesh of ranks, and the batch and state helpers of
data parallelism (counterpart of desed_task_tpu/parallel/mesh.py).

The JAX package lays its devices out in a `jax.sharding.Mesh` and lets XLA
place the collectives. Here every rank is a process (started by torchrun,
or by parallel/launch.spawn_ranks) that drives one card, and a mesh is the
set of process groups of its axes:

  * 'data'  - the batch axis: each rank takes its block of every batch's
              rows (`shard_batch`), the state is replicated (`replicate`),
              and the train step mean-all-reduces gradients, BatchNorm
              statistics and losses over the axis's group
              (training/mean_teacher.make_train_step_sharded);
  * 'model' - the tensor-parallel axis of the frozen BEATs (parallel/tp.py).

Ranks fill the mesh in row-major order, as the JAX package reshapes its
device list: on {"data": 2, "model": 2}, ranks 0 and 1 hold data index 0,
ranks 0 and 2 model index 0. An axis's size is `mesh.shape[axis]`.

Each axis has two groups: one on the process's backend (NCCL on the card)
for the step's collectives, and one on gloo for what goes to the host
anyway (the eval scores' gather, objects such as generator states); on a
gloo process they are the same group. Every group's collectives fail after
the timeout that init_distributed was given (300 s when the process joined
some other way), as the default group's do.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

# the collectives' deadline of the groups make_mesh creates: init_distributed's
_timeout = datetime.timedelta(seconds=300.0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: dict  # axis -> size, in the mesh's axis order
    index: dict  # axis -> this rank's coordinate on it
    groups: dict  # axis -> process group on the process's backend
    cpu_groups: dict  # axis -> process group on gloo

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def root(self, axis: str) -> int:
        """Global rank of the first rank of this rank's group on `axis`."""
        return dist.get_global_rank(self.groups[axis], 0)


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     timeout_s: float = 300.0) -> tuple[int, int, int]:
    """Join the default process group; returns (rank, world size, local rank).

    rank, world_size and the local rank come from torchrun's RANK,
    WORLD_SIZE and LOCAL_RANK where not given (local rank = rank without
    them); init_method defaults to torchrun's env://. backend: NCCL where
    CUDA is available, else gloo; on NCCL the local rank's card becomes the
    current one. Every collective of the group fails after `timeout_s`
    instead of waiting for a rank that is gone, and so do those of the
    groups that make_mesh creates. A process that has joined already gets
    its group's numbers back."""
    global _timeout
    if dist.is_initialized():
        r = dist.get_rank()
        return r, dist.get_world_size(), int(os.environ.get("LOCAL_RANK", r))
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=_timeout)
    return rank, world_size, local_rank


def make_mesh(shape: dict[str, int] | None = None) -> Mesh:
    """The mesh of every rank of the default group; shape defaults to one
    'data' axis over all of them. Collective: every rank calls it, with the
    same shape. Its groups' collectives fail after init_distributed's
    timeout."""
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = {"data": world} if shape is None else dict(shape)
    sizes = list(shape.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(sizes)} ranks, the group has {world}")
    grid = np.arange(world).reshape(sizes)
    coord = [int(c) for c in np.argwhere(grid == rank)[0]]
    on_gloo = dist.get_backend() == "gloo"
    groups, cpu_groups = {}, {}
    for i, axis in enumerate(shape):
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist()
        groups[axis], _ = dist.new_subgroups_by_enumeration(lines, timeout=_timeout)
        cpu_groups[axis] = (groups[axis] if on_gloo else dist.new_subgroups_by_enumeration(
            lines, timeout=_timeout, backend="gloo")[0])
    return Mesh(shape=shape, index=dict(zip(shape, coord)), groups=groups,
                cpu_groups=cpu_groups)


def _rows(leaf, n: int, r: int, batch_axis: int):
    size = leaf.shape[batch_axis]
    if size % n:
        raise ValueError(f"a batch axis of {size} rows does not split into {n} equal blocks")
    block = size // n
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(batch_axis, r * block, block)
    return leaf[(slice(None),) * batch_axis + (slice(r * block, (r + 1) * block),)]


def shard_batch(batch, mesh: Mesh, axis: str = "data", batch_axis: int = 0):
    """This rank's rows of a (nested dict) batch: on dim `batch_axis` (0, or
    1 under a leading micro-batch axis) the contiguous block [r n / k,
    (r + 1) n / k) for data index r of k, the rows that the JAX package's
    NamedSharding(P(axis)) places on that device. Leaves with no such dim
    (scalars) and non-array leaves are kept whole; numpy leaves come back
    as views, tensors as narrowed views."""
    n, r = mesh.shape[axis], mesh.index[axis]

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > batch_axis:
            return _rows(x, n, r, batch_axis)
        return x

    return take(batch)


def replicate(module_or_tensors, mesh: Mesh):
    """Broadcast parameters and buffers (of modules) or tensors, in place,
    from the mesh's first rank (rank 0) to every rank. Returns what it was
    given."""
    items = (module_or_tensors if isinstance(module_or_tensors, (list, tuple))
             else [module_or_tensors])
    tensors = []
    for it in items:
        if isinstance(it, torch.nn.Module):
            tensors += [*it.parameters(), *it.buffers()]
        else:
            tensors.append(it)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return module_or_tensors


def all_reduce_mean(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """The mean over `group` of each tensor, by one all-reduce of their
    concatenation in the order given (so every rank gets the same bits),
    sum then divide, as JAX's pmean. Returns new tensors of the inputs'
    shapes; all must share one dtype and device."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def rank_seed(seed: int, rank: int, world_size: int) -> int:
    """A rank's seed: `seed` itself in a world of one, else one drawn from
    (seed, rank), so that ranks' random draws differ (JAX folds the axis
    index into the key, mean_teacher.py:373-375)."""
    if world_size == 1:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
