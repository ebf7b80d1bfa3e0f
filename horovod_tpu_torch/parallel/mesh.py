"""The port's device mesh: named parallelism axes over the
``torch.distributed`` world.

Counterpart of horovod_tpu/parallel/mesh.py (``AXIS_ORDER``,
``MeshConfig``, ``create_mesh``), with its own copy of both. JAX lays a
``Mesh`` over devices and lets ``shard_map`` hand each device its block
of a global array; the port has one process per device, so a mesh here
is this rank's place in the grid: its coordinate on each axis, one
process group per axis (the ranks that differ only along it), and one
group of the whole mesh. Ranks are laid out as
``np.arange(world).reshape(shape)`` in ``AXIS_ORDER``, as JAX's CPU mesh
lays out its devices, so rank r holds the shard JAX's device r holds.

Groups are NCCL on the card (the default) and gloo when the caller asks
for ``device="cpu"``; a CUDA mesh never drops to gloo. Only the ``data``
and ``seq`` axes are ported; ``fsdp``, ``tensor`` and ``expert`` larger
than 1 raise naming ROADMAP.md A8, ``pipe`` naming A10.
"""

import dataclasses
import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch._device import resolve_device

# Canonical axis order, outermost to innermost (the JAX package's).
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")
_QUEUED = {"fsdp": "A8", "tensor": "A8", "expert": "A8", "pipe": "A10"}
_TIMEOUT = timedelta(seconds=120)


@dataclasses.dataclass
class MeshConfig:
    """Sizes for each parallelism axis; -1 on one axis = use all
    remaining ranks (like a numpy reshape -1)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1

    def resolved(self, n_devices):
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices")
        return sizes


class Mesh:
    """This rank's place in the mesh. ``shape`` maps every axis of
    ``AXIS_ORDER`` to its size (as JAX's ``mesh.shape``), ``coords`` to
    this rank's index along it; ``group`` spans the whole mesh;
    ``device`` is where this rank's tensors live."""

    def __init__(self, shape, rank, device, axis_groups, group):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        grid = np.arange(math.prod(shape.values())).reshape(
            tuple(shape[a] for a in AXIS_ORDER))
        self.coords = dict(zip(AXIS_ORDER, (
            int(i) for i in np.unravel_index(rank, grid.shape))))
        self._axis_groups = axis_groups
        self.group = group

    @property
    def size(self):
        return math.prod(self.shape.values())

    def axis_size(self, axis):
        return self.shape[axis]

    def axis_index(self, axis):
        return self.coords[axis]

    def axis_group(self, axis):
        """The process group of the ranks that differ from this one only
        along ``axis`` (None for an axis of size 1)."""
        return self._axis_groups.get(axis)

    def shard(self, x):
        """This rank's block of a global [B, T, ...] tensor: the batch
        split over ``data`` (JAX's ``("data", "fsdp")``, fsdp being 1),
        the sequence over ``seq``."""
        out = x
        for dim, axis in ((0, "data"), (1, "seq")):
            n = self.shape[axis]
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} ({out.shape[dim]}) does not "
                                 f"divide over the {axis!r} axis ({n})")
            step = out.shape[dim] // n
            out = out.narrow(dim, self.coords[axis] * step, step)
        return out

    def shard_batch(self, batch):
        """:meth:`shard` of every entry of a dict of [B, T] tensors."""
        return {k: self.shard(torch.as_tensor(v)) for k, v in batch.items()}


def _env_int(name, default):
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def _init_world(device):
    """Join the torch.distributed world if this process has not: rank
    and size from ``HOROVOD_RANK``/``HOROVOD_SIZE``, a TCPStore at
    ``HOROVOD_CONTROLLER_ADDR:HOROVOD_CONTROLLER_PORT`` (the eager lane's
    rendezvous), an in-process store for a world of one. The default
    group is gloo; the mesh opens its own groups."""
    if dist.is_initialized():
        return
    rank = _env_int("HOROVOD_RANK", 0)
    size = _env_int("HOROVOD_SIZE", 1)
    if size == 1:
        store = dist.HashStore()
    else:
        store = dist.TCPStore(
            os.environ.get("HOROVOD_CONTROLLER_ADDR") or "127.0.0.1",
            _env_int("HOROVOD_CONTROLLER_PORT", 29500), size,
            is_master=rank == 0, timeout=_TIMEOUT)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=size,
                            timeout=_TIMEOUT)


def create_mesh(config=None, *, device=None, **axis_sizes):
    """The mesh over the torch.distributed world (joined here from the
    ``HOROVOD_*`` rendezvous if this process has not joined yet):
    ``create_mesh(data=2, seq=2)`` or ``create_mesh(MeshConfig(...))``.
    ``device`` follows the entry-point rule (None means cuda: this
    rank's card, ``HOROVOD_LOCAL_RANK``, and NCCL groups; "cpu": gloo
    groups). Every rank must call it, with the same sizes."""
    if config is None:
        config = MeshConfig(**{**{"data": -1}, **axis_sizes}) \
            if axis_sizes else MeshConfig()
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev}")
    _init_world(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = config.resolved(world)
    for axis, item in _QUEUED.items():
        if sizes[axis] > 1:
            raise NotImplementedError(
                f"the {axis!r} mesh axis is not ported yet (ROADMAP.md "
                f"{item}); the port shards over 'data' and 'seq' only")
    if dev.type == "cuda":
        dev = torch.device("cuda", _env_int("HOROVOD_LOCAL_RANK", rank)
                           % torch.cuda.device_count()) \
            if dev.index is None else dev
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    grid = np.arange(world).reshape(tuple(sizes[a] for a in AXIS_ORDER))
    axis_groups = {}
    # Every rank creates every group, in one order (new_group is
    # collective over the world).
    for i, axis in enumerate(AXIS_ORDER):
        if sizes[axis] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line], timeout=_TIMEOUT,
                               backend=backend)
            if rank in line:
                axis_groups[axis] = g
    group = dist.new_group(list(range(world)), timeout=_TIMEOUT,
                           backend=backend)
    return Mesh(sizes, rank, dev, axis_groups, group)
