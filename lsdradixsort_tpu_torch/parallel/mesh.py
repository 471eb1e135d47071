"""The device mesh as a process group, and the shard helpers — the port of
lsdradixsort_tpu/parallel/mesh.py.

JAX runs one program over a `Mesh` of devices and shards arrays over its
axis; torch.distributed runs one process a device. So the mesh here is a
process group: its size is the JAX mesh's `mesh.shape[axis]`, a process's
rank in it is `jax.lax.axis_index(axis)`, and each process holds its own
shard of every sharded array (`shard_1d`).

`make_mesh` initialises the default process group when there is none:
from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR/MASTER_PORT)
when it is set, otherwise as a world of one over an in-memory store. An
initialised group is reused, so a caller may set up the world itself
(parallel/launch.py does). The default is the card, NCCL on
cuda:LOCAL_RANK; tests ask for the CPU with backend="gloo",
device="cpu". Without a card and without those arguments it raises: it
never falls back to the CPU.

The collective helpers carry counts as int64 and 32-bit columns as their
int32 bits: NCCL and gloo refuse torch.uint32.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from lsdradixsort_tpu_torch.core.convert import from_numpy

DATA_AXIS = "x"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: `size` processes in `group` (None: the default
    group), this process at `rank`, its shards on `device`. A process
    outside the group has member=False and rank -1, and takes no part."""
    group: object
    size: int
    rank: int
    device: torch.device
    member: bool
    axis: str = DATA_AXIS


def _init_world(backend: str, device: torch.device) -> None:
    """The default process group: torchrun's, or a world of one."""
    kwargs = {"device_id": device} if backend == "nccl" else {}
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS,
              backend: str = "nccl", device=None) -> Mesh:
    """1-D data mesh over the first n_devices processes of the world
    (default: all). Every process of the world must call it, also those
    left out (a new group is made by all of them)."""
    if device is None:
        if backend != "nccl":
            raise ValueError(f"backend {backend!r} needs a device")
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "backend='gloo', device='cpu' for the CPU")
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: no CUDA device for {device}")
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        _init_world(backend, device)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world = dist.get_world_size()
    me = dist.get_rank()
    if n_devices is None or n_devices == world:
        return Mesh(None, world, me, device, True, axis)
    if not 0 < n_devices <= world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    group = dist.new_group(list(range(n_devices)))
    member = me < n_devices
    return Mesh(group, n_devices, me if member else -1, device, member, axis)


def shard_1d(x, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """This process's contiguous shard of the full 1-D array x (a tensor,
    or a 32-bit numpy array), on the mesh's device."""
    _check_member(mesh)
    if isinstance(x, np.ndarray):
        x = from_numpy(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"n={n} must be divisible by mesh size {mesh.size}")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def replicated(x, mesh: Mesh) -> torch.Tensor:
    """The whole array x on the mesh's device, as every process holds it."""
    if isinstance(x, np.ndarray):
        x = from_numpy(x)
    return x.to(mesh.device)


def _check_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError("this process is not in the mesh")


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of t over the mesh (int64 counts), on every process, in a
    new tensor. An empty t has nothing to sum and makes no collective
    call."""
    t = t.clone(memory_format=torch.contiguous_format)
    if t.numel():
        dist.all_reduce(t, group=mesh.group)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(mesh.size, *t.shape): every process's t, in rank order. Every
    process passes the same shape; 32-bit tensors travel as int32 bits."""
    t = t.contiguous()
    dtype = t.dtype
    if t.element_size() == 4:
        t = t.view(torch.int32)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    if t.numel():
        dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).view(dtype)
