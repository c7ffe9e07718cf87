"""Device-mesh helpers: ray-batch sharding over `torch.distributed`.

Port of `optiland_tpu/parallel/mesh.py`. The JAX package is
single-controller: one process places a jitted step's inputs on a
`jax.sharding.Mesh` and XLA inserts a psum at every reduction. The port
runs one process per device (a rank of a `torch.distributed` process
group) and makes each of those collectives explicit:

  - a mesh is a `torch.distributed.device_mesh.DeviceMesh` whose
    dimensions are named `("rays",)` or `("hosts", "chips")`; its device
    type follows the group's backend (cuda under NCCL, cpu under gloo,
    whose collectives also take CUDA tensors);
  - every trace quantity is elementwise in the ray axis, so each rank
    traces its own contiguous slice of the batch (`shard_rays`) with no
    communication, and the lens parameters are replicated;
  - a reduction over rays is a local sum and one `all_sum` of it, a
    single all-reduce over every rank of the mesh (JAX's psum over both
    axes of a 2-D mesh is one collective too).

Gradient convention (`all_sum`, `average_gradients`). `all_sum` is the
all-reduce whose backward all-reduces the cotangent: the transpose of a
sum that every rank holds (`torch.distributed.nn.functional.all_reduce`
is the same autograd function, deprecated in torch 2.13 with a warning
on every call). Every rank computes the same loss from the reduced sums,
so the cotangent that reaches a rank's local sums, and its local
gradient of a replicated parameter, carry a factor W, the mesh size.
`average_gradients` all-reduces those gradients and divides by W, which
gives the unsharded step's gradients. The all-reduced backward keeps a
merit whose replicated intermediates feed back into local sums (the
flagship merit's centroid) right: each rank's cotangent of the centroid
is summed before it reaches any rank's data. For W a power of two the
factor and its division are exact; one rank makes both identities.

NCCL takes one rank per GPU. Several ranks on one card (a rehearsal of a
multi-GPU run) use gloo with CUDA tensors (`init_distributed(...,
backend="gloo")`).
"""

from __future__ import annotations

from collections import namedtuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_map

from optiland_tpu_torch import config

RAY_AXIS = "rays"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"

# a layout: a mesh and one placement per mesh dimension, as
# `torch.distributed.tensor.distribute_tensor(t, *sharding)` takes them
Sharding = namedtuple("Sharding", "mesh placements")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None) -> None:
    """Join this process to the process group, one rank per device; a
    no-op when a group exists (JAX's `init_distributed`, `mesh.py:79`).

    `coordinator_address` is a rendezvous URL (`tcp://host:port`,
    `file:///path`) or `host:port`; without it, and with one process, the
    group is this process alone (the JAX package's single-process run on
    its local device). `device` is this rank's device (None: the CUDA
    card, RuntimeError without one); `backend` defaults to NCCL on the
    card and gloo on the CPU."""
    if dist.is_initialized():
        return
    dev = config.resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if dev.index is None:   # "cuda": the current card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if coordinator_address is None:
        if world != 1:
            raise ValueError(
                f"init_distributed: {world} processes need a "
                "coordinator_address to meet at")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world)


def _ranks(n: int | None, devices, device) -> list[int]:
    """The first `n` of `devices` (ranks; default every rank of the group,
    which a one-rank group is made for when none exists)."""
    if not dist.is_initialized():
        init_distributed(device=device)
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if n is not None:
        if n > len(ranks):
            raise ValueError(
                f"a mesh of {n} devices was asked for, but the process "
                f"group has {len(ranks)} ranks")
        ranks = ranks[:n]
    return ranks


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, devices=None,
              device=None) -> DeviceMesh:
    """A 1-D mesh over the ray-batch axis, `("rays",)`, of the first
    `n_devices` ranks (`devices`, a list of ranks, default all of them).
    Without a process group, a one-rank group on `device` (None: the CUDA
    card) is made first. Every rank of the group must call it."""
    ranks = _ranks(n_devices, devices, device)
    return DeviceMesh(_device_type(), torch.tensor(ranks),
                      mesh_dim_names=(RAY_AXIS,))


def make_mesh_2d(n_hosts: int | None = None,
                 chips_per_host: int | None = None, devices=None,
                 device=None) -> DeviceMesh:
    """A `("hosts", "chips")` mesh (JAX's `make_mesh_2d`, `mesh.py:103`):
    rays are sharded over both axes (the trace is elementwise in rays, so
    the factorization is free). `n_hosts` defaults to 1, `chips_per_host`
    to the ranks left per host. Every rank of the group must call it: it
    also makes the group of every rank of the mesh, which `all_sum` and
    `average_gradients` reduce over (`mesh_group`)."""
    n_hosts = 1 if n_hosts is None else int(n_hosts)
    if chips_per_host is None:
        chips_per_host = len(_ranks(None, devices, device)) // n_hosts
    ranks = _ranks(n_hosts * chips_per_host, devices, device)
    mesh = DeviceMesh(_device_type(),
                      torch.tensor(ranks).reshape(n_hosts, chips_per_host),
                      mesh_dim_names=(HOST_AXIS, CHIP_AXIS))
    mesh._all_ranks_group = dist.new_group(ranks)
    return mesh


def mesh_group(mesh: DeviceMesh):
    """The process group of every rank of `mesh`: its one dimension's, or
    the one `make_mesh_2d` made beside a 2-D mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    group = getattr(mesh, "_all_ranks_group", None)
    if group is None:
        raise ValueError("a mesh of more than one dimension reduces over the "
                         "group make_mesh_2d makes beside it; build it there")
    return group


def ray_sharding(mesh: DeviceMesh) -> Sharding:
    """The layout of (num_rays, ...) tensors on a 1-D mesh: split."""
    return Sharding(mesh, (Shard(0),))


def ray_sharding_2d(mesh: DeviceMesh) -> Sharding:
    """(num_rays, ...) tensors split over hosts x chips jointly."""
    return Sharding(mesh, (Shard(0), Shard(0)))


def replicated_sharding(mesh: DeviceMesh) -> Sharding:
    """The layout of lens parameters: replicated on every device."""
    return Sharding(mesh, (Replicate(),) * mesh.ndim)


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's index in the mesh, its coordinates row-major."""
    index = 0
    for dim, coord in enumerate(mesh.get_coordinate()):
        index = index * mesh.size(dim) + coord
    return index


def shard_rays(mesh: DeviceMesh, tree):
    """This rank's contiguous slice of every (num_rays, ...) tensor of
    `tree` (JAX's `shard_rays`, `mesh.py:53`, which places the whole batch
    split over the mesh). The ray count must be a multiple of the mesh
    size (`pad_to_multiple`; pad with intensity-0 rays, which every
    reduction ignores)."""
    w, r = mesh.size(), mesh_rank(mesh)

    def shard(a):
        n = a.shape[0]
        if n % w:
            raise ValueError(f"{n} rays do not split over a mesh of {w}; "
                             "pad them to a multiple (pad_to_multiple)")
        return a[r * (n // w):(r + 1) * (n // w)]

    return tree_map(shard, tree)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


class _AllReduceSum(torch.autograd.Function):
    """The sum of `t` over the ranks of `group`; its backward is the same
    sum of the cotangents."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, g


def all_sum(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """`t` summed over every rank of the mesh in one all-reduce,
    differentiable; its backward sums the cotangents the same way (module
    docstring: the factor W)."""
    return _AllReduceSum.apply(mesh_group(mesh), t)


def average_gradients(mesh: DeviceMesh, tensors) -> None:
    """All-reduce the `.grad` of the tensors and divide it by the mesh
    size, in place: the unsharded step's gradient of a replicated
    parameter whose loss went through `all_sum` (module docstring). The
    gradients travel as one flat buffer, in one all-reduce."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh_group(mesh))
    flat.div_(mesh.size())
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
