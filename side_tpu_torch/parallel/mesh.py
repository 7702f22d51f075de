"""Data parallelism over `torch.distributed` (port of
side_tpu/parallel/mesh.py).

The JAX package shards the batch over a 1-D device mesh axis "data" and
lets XLA partition the step: BatchNorm statistics and every loss
normaliser are then over the global batch, and the gradient all-reduce is
inserted for it.  Here each rank is one process on one device, and the
same global semantics are written out:

- `init_distributed` joins the process group (nccl for CUDA ranks, gloo
  for CPU ranks; gloo also carries CUDA tensors, which is how one card runs
  two ranks: nccl refuses two ranks on one GPU);
- `make_mesh` returns a `Mesh` (world, rank, group, device).  Without a
  process group it is world 1 with no group, and nothing below issues a
  collective;
- `shard_batch` gives the rank its contiguous slice of the leading axis,
  as `P("data")` splits it; `ShardedLoader` applies it to every batch of a
  loader that yields the global batch;
- `replicate` broadcasts a module's parameters and buffers from rank 0;
- `all_reduce_sum` is differentiable: its backward all-reduces the
  incoming gradient, so that a statistic shared by all ranks sends each
  rank the gradient of the summed objective;
- within `data_parallel(mesh)` the BatchNorms (models/dla.py) and the
  stereo loss (ops/losses.py) read `active_mesh()` and take their
  statistics and normalisers over the global batch.

Only `all_reduce` and `broadcast` are used: they are the collectives gloo
supports on CUDA tensors.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn as nn


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group this process belongs to.  `group` None:
    a single process, no collectives."""

    world: int = 1
    rank: int = 0
    group: Optional[Any] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def active(self) -> bool:
        return self.group is not None


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: Optional[str] = None) -> None:
    """Join a process group of `num_processes` ranks as rank `process_id`.

    `coordinator_address` is `host:port` (rank 0 listens there) or a URL
    `torch.distributed` takes as is (`tcp://...`, `file://...`).  The
    backend defaults to nccl where CUDA is available, else gloo; a CUDA rank
    sets its device (`torch.cuda.set_device`) before joining."""
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} of {num_processes} "
                         "processes: give both (--num_processes, "
                         "--process_id)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(num_devices: int = 0, device=None) -> Mesh:
    """The mesh over every rank of the process group (`num_devices` 0 or
    the group's size), or world 1 without collectives when this process
    joined none.  `device` is this rank's device (cpu by default)."""
    device = torch.device(device if device is not None else "cpu")
    if not dist.is_initialized():
        if num_devices > 1:
            raise RuntimeError(f"a mesh of {num_devices} ranks needs a "
                               "process group: call init_distributed first")
        return Mesh(device=device)
    world = dist.get_world_size()
    if num_devices not in (0, world):
        raise ValueError(f"num_devices {num_devices} != world size {world}")
    return Mesh(world, dist.get_rank(), dist.group.WORLD, device)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The rank's contiguous slice of every array's leading axis (arrays or
    tensors; `meta` dropped).  The leading axis must divide by the world
    size, as the JAX package's sharding requires."""
    out = {}
    for k, v in batch.items():
        if k == "meta":
            continue
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"{k}: batch {n} does not split over "
                             f"{mesh.world} ranks")
        m = n // mesh.world
        out[k] = v[mesh.rank * m:(mesh.rank + 1) * m]
    return out


class ShardedLoader:
    """A loader of global batches seen by one rank: each batch is its
    `shard_batch` slice.  Every rank iterates the same loader (same seed),
    so the ranks together see the global batch of a one-process run."""

    def __init__(self, loader, mesh: Mesh):
        self.loader, self.mesh = loader, mesh

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for batch in self.loader:
            yield shard_batch(batch, self.mesh)


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> None:
    """Overwrite the module's parameters and buffers with rank 0's."""
    if not mesh.active:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.group)


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place sum over the ranks, outside autograd; returns `t`."""
    if mesh.active:
        dist.all_reduce(t, group=mesh.group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the ranks, differentiable: the gradient of each rank's
    input is the sum of the ranks' gradients of the output."""
    if not mesh.active:
        return x
    return _AllReduceSum.apply(x, mesh.group)


_active: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within the block the BatchNorms and the stereo loss reduce over
    `mesh` (when it is active).  The trainer holds it around the forward
    and the backward: `--remat` recomputes BatchNorms in the backward, and
    they must reduce there too."""
    global _active
    prev = _active
    _active = mesh if mesh is not None and mesh.active else None
    try:
        yield
    finally:
        _active = prev


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing `data_parallel` block, or None."""
    return _active
