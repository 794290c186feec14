"""Device-mesh helpers over ``torch.distributed``.

The multi-device layer of the port, the counterpart of the JAX package's
``Mesh`` + ``NamedSharding``: one process a rank, a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the axes
the framework uses,

- "data": independent sequences / circuit instances (data parallelism; the
  gradient is all-reduced over it),
- "time": time-block sharding of long signals (``parallel.time_block``),

and "sharding" as the rank's contiguous block: rank r of an axis of size D
holds rows (or samples) ``[r n / D, (r + 1) n / D)`` of an n-long axis, the
order of JAX's ``P(axis)``; n must be divisible by D.

The collectives below act on one mesh axis (``mesh.get_group(axis)``).  A
CUDA tensor on a gloo group (the backend that lets two ranks share one
card) goes through a host copy, since gloo takes CPU tensors for every
collective used here; NCCL and CPU tensors go as they are.  None of them is
recorded by autograd: callers reduce sums and gradients after
differentiating, never inside it.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.elements import Device
from ..training.circuit_train import _leaves, _map


def rank_device(device: Device = "cuda") -> torch.device:
    """The device this rank computes on: its card (``cuda`` with the index
    ``torch.cuda.set_device`` chose) or the CPU.  Asked for CUDA without a
    card it raises: there is no fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "time"),
              devices: Optional[Sequence[int]] = None, *,
              device: Device = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` over the ranks ``devices`` (default: every rank of
    the process group; a single process with none gets a one-rank group
    of its own), reshaped to ``shape`` (default: all on
    the first axis, "data").  Every rank of the group calls it, also a rank
    outside ``devices`` (the mesh's groups are made collectively).  The
    mesh's device type is ``device``'s: "cuda" unless the caller asks for
    the CPU."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("make_mesh: initialise the process group first "
                               "(parallel.distributed.initialize)")
        # one process: a group of its own, as a JAX mesh needs no initialisation
        dist.init_process_group("nccl" if rank_device(device).type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} over axes {tuple(axis_names)} does not hold "
                         f"{len(ranks)} ranks")
    return DeviceMesh(rank_device(device).type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.shape[_dim(mesh, axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    return mesh.get_local_rank(_dim(mesh, axis))


def has_axis(mesh: DeviceMesh, axis: str) -> bool:
    return axis in (mesh.mesh_dim_names or ())


def _dim(mesh: DeviceMesh, axis: str) -> int:
    if not has_axis(mesh, axis):
        raise ValueError(f"mesh has no axis {axis!r}; axes: {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names.index(axis)


def _group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def block_bounds(n: int, mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """[start, stop) of this rank's block of an n-long dimension split over
    ``axis``; raises unless the axis divides n."""
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} rows do not split evenly over the {d} ranks of axis {axis!r}")
    r = axis_index(mesh, axis)
    return r * n // d, (r + 1) * n // d


def shard_batches(batches, mesh: DeviceMesh, *, device: Device = "cuda"):
    """This rank's block of every leaf of a {name: tensor[n_seq, ...]} batch
    (the sequence axis split over "data": JAX's ``data_sharding``), on the
    rank's device."""
    dev = rank_device(device)
    out = {}
    for k, v in batches.items():
        v = torch.as_tensor(v)
        lo, hi = block_bounds(v.shape[0], mesh, "data")
        out[k] = v[lo:hi].to(dev).contiguous()
    return out


def replicate_params(params, mesh: DeviceMesh, *, device: Device = "cuda"):
    """A copy of the params tree on the rank's device holding the mesh's
    first rank's values on every rank, so replicas start bit-identical
    (JAX's ``replicated`` sharding): each leaf broadcast along each mesh
    axis in turn from the axis's first rank."""
    dev = rank_device(device)
    out = _map(lambda x: torch.as_tensor(x).detach().to(dev).clone(), params)
    for axis in mesh.mesh_dim_names:
        group = _group(mesh, axis)
        for x in _leaves(out):
            broadcast_(x, dist.get_global_rank(group, 0), group)
    return out


# ---------------------------------------------------------------------------
# Collectives on one axis (outside autograd; host copies for CUDA on gloo)
# ---------------------------------------------------------------------------


def _host_copy(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


@torch.no_grad()
def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` in place, from global rank ``src`` to every rank of ``group``."""
    if _host_copy(x, group):
        h = x.cpu()
        dist.broadcast(h, src, group=group)
        x.copy_(h)
    else:
        dist.broadcast(x, src, group=group)
    return x


@torch.no_grad()
def reduce_group_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` in place, reduced with ``op`` over every rank of ``group``."""
    if _host_copy(x, group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


@torch.no_grad()
def all_reduce_(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` in place, reduced with ``op`` over every axis of ``axes`` in
    turn (a sum over (data, time) is a sum over time, then over data).
    Every rank ends with the same bits."""
    for axis in axes:
        reduce_group_(x, _group(mesh, axis), op)
    return x


@torch.no_grad()
def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The blocks of every rank along ``axis``, concatenated in rank order
    along the leading dimension (the inverse of taking this rank's block);
    same shape on every rank."""
    group = _group(mesh, axis)
    host = _host_copy(x, group)
    src = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


@torch.no_grad()
def send_next(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> None:
    """Send ``x`` to the next rank along ``axis``."""
    group = _group(mesh, axis)
    dst = dist.get_global_rank(group, axis_index(mesh, axis) + 1)
    dist.send(x.cpu() if _host_copy(x, group) else x.contiguous(), dst, group=group)


@torch.no_grad()
def recv_prev(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``x`` in place, received from the previous rank along ``axis``."""
    group = _group(mesh, axis)
    src = dist.get_global_rank(group, axis_index(mesh, axis) - 1)
    if _host_copy(x, group):
        h = x.cpu()
        dist.recv(h, src, group=group)
        x.copy_(h)
    else:
        dist.recv(x, src, group=group)
    return x

