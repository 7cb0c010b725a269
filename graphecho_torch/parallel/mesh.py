"""Data parallelism over `torch.distributed`, port of
`graphecho_tpu/parallel/mesh.py`.

One process per GPU (NCCL on CUDA, gloo on the CPU). The JAX package shards
the batch's leading axis over a 1-D `data` mesh and lets GSPMD give one step
on the sharded global batch exactly what one device computes on that batch:
global BatchNorm statistics, a GModule that sees every node, global loss
means. The port keeps those semantics by hand (`train/steps.py`):

  * each rank runs the FPN on its rows, its BatchNorms reducing their
    statistics over the group (`models/backbones.py::BatchNorm2d`);
  * `all_gather_nodes` gathers the FPN's outputs with autograd, and every
    rank runs the rest of the step (sampling, GModule, discriminators, TGCN,
    losses) on the global batch, drawing the same random numbers;
  * the FPN's gradients are summed over the ranks; the replicated
    components' gradients, and the state every rank updates alike (their
    running statistics, the seed banks, the queues), equal on every rank up
    to the rounding of the card's non-deterministic kernels (atomics), are
    averaged in the same all-reduce, which keeps the replicas equal to the
    bit.

Multi-process launch: `initialize_distributed` wraps `init_process_group`,
with the rank, world size and coordinator from the arguments or from the
launcher's environment (`utils/tools.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from graphecho_torch.utils import tools


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group: `coordinator` is process 0's `host:port`.
    Unset arguments come from the environment (`utils/tools.py`). A no-op
    for one process, and when the group exists already. NCCL when CUDA is
    there (each process on the card of its local rank), else gloo."""
    if num_processes is None:
        num_processes = tools.get_world_size()
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = tools.get_global_rank()
    if coordinator is None:
        coordinator = f"{tools.get_master_ip()}:{tools.get_master_port()}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(tools.get_local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data mesh: the process group's ranks. `group` is None for a
    single process without a group, where every collective is the identity."""

    group: Optional[Any]
    size: int
    rank: int

    @property
    def device(self) -> Optional[torch.device]:
        """The device NCCL's collectives take their tensors on; None for gloo."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return None


def create_mesh(data: Optional[int] = None) -> Mesh:
    """The mesh over the process group's world (one process without a group:
    a mesh of one). `data`, the JAX package's `mesh_data`, must equal the
    world size: one process drives one device."""
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank())
    else:
        mesh = Mesh(None, 1, 0)
    if data is not None and data != mesh.size:
        raise ValueError(f"mesh_data={data} but the process group has {mesh.size} "
                         "process(es); the port runs one process per device")
    return mesh


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's row block of a global batch (the same on every rank).
    Entries whose leading dimension does not divide over the mesh are
    refused, as the JAX package refuses them across hosts: replicating them
    would give the ranks different values for one logical array."""
    out = {}
    for k, v in batch.items():
        shape = tuple(np.shape(v))
        if not shape or shape[0] % mesh.size:
            raise ValueError(f"shard_batch: entry {k!r} (shape {shape}) cannot be sharded "
                             f"over {mesh.size} ranks")
        rows = shape[0] // mesh.size
        out[k] = v[mesh.rank * rows:(mesh.rank + 1) * rows]
    return out


def _on_collective_device(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dev = mesh.device
    return t if dev is None or t.device == dev else t.to(dev)


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast `tensors` from rank 0 in place, so that every rank holds
    rank 0's values."""
    if mesh.group is None:
        return
    with torch.no_grad():
        for t in tensors:
            buf = _on_collective_device(t, mesh)
            dist.broadcast(buf, 0, group=mesh.group)
            if buf is not t:
                t.copy_(buf)


def replicate_generator(mesh: Mesh, gen: torch.Generator) -> None:
    """Give `gen` rank 0's state."""
    if mesh.group is None:
        return
    state = gen.get_state()
    replicate(mesh, [state])
    gen.set_state(state)


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows concatenated in rank order. The backward keeps this
    rank's rows of the gradient: the consumer is replicated (the same
    function of the same global tensor on every rank), so every rank holds
    the whole gradient and the slice is this rank's share, with no
    communication."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.rank
        # the input's memory format (channels-last maps stay so), which the
        # consumers' kernels, and with them the result's rounding, depend on
        if not (x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last)):
            x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_nodes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(rows, ...) on each rank -> (size * rows, ...) on every rank, rank 0's
    rows first, with autograd (the JAX package's tiled `all_gather`). Every
    rank must pass the same number of rows. The identity on a mesh without
    a group."""
    if mesh.group is None:
        return x
    return _AllGatherRows.apply(x, mesh)


def all_reduce_grads(mesh: Mesh, summed: Iterable[torch.nn.Parameter],
                     averaged: Iterable[torch.nn.Parameter] = (),
                     replicated: Iterable[torch.Tensor] = ()) -> None:
    """Sum the gradients of `summed` and average those of `averaged` over the
    ranks, and average the f32 tensors of `replicated` in place (state that
    every rank computes alike: running statistics, seed banks, queues), in
    one flat buffer. A parameter with no gradient gets a zero one first, so
    that the buffers line up."""
    if mesh.group is None:
        return
    summed, averaged, replicated = list(summed), list(averaged), list(replicated)
    params = summed + averaged
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    targets = [p.grad for p in params] + replicated
    flat = torch.cat([p.grad.reshape(-1) for p in summed]
                     + [t.reshape(-1) / mesh.size for t in targets[len(summed):]])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for t in targets:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def max_abs_spread(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> float:
    """The largest elementwise difference between the ranks' values of
    `tensors` (0 where they agree): the check that replicated state stayed
    replicated."""
    if mesh.group is None:
        return 0.0
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = _on_collective_device(flat, mesh)
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    return float((hi - lo).abs().max()) if flat.numel() else 0.0


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """True on every rank if `flag` is true on any rank (a stop signal that
    one rank received)."""
    if mesh.group is None:
        return flag
    t = torch.tensor([1.0 if flag else 0.0])
    t = _on_collective_device(t, mesh)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item() > 0)
