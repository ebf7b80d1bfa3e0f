"""The port's device mesh: named parallelism axes over the
``torch.distributed`` world.

Counterpart of horovod_tpu/parallel/mesh.py (``AXIS_ORDER``,
``MeshConfig``, ``create_mesh``), with its own copy of both. JAX lays a
``Mesh`` over devices and lets ``shard_map`` hand each device its block
of a global array; the port has one process per device, so a mesh here
is this rank's place in the grid: its coordinate on each axis, one
process group for every set of axes larger than 1 (the ranks that
differ only along those axes: one axis for a gather or a ring, several
for a gradient's or an activation's sum), and one group of the whole
mesh. Ranks are laid out as ``np.arange(world).reshape(shape)`` in
``AXIS_ORDER``, as JAX's CPU mesh lays out its devices, so rank r holds
the shard JAX's device r holds.

The batch is split over ``data`` and ``fsdp`` jointly (data major) and
the sequence over ``seq``, as JAX's activation spec
``P(("data", "fsdp"), "seq")``; activations are replicated over
``expert`` and ``tensor``, and over ``pipe``, whose ranks hold the
stages of the layer stack (``parallel/pipeline.py``): it is not a batch
axis. Groups are NCCL on the card (the default) and gloo when the caller
asks for ``device="cpu"``; a CUDA mesh never drops to gloo.
"""

import contextlib
import dataclasses
import itertools
import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch._device import resolve_device

# Canonical axis order, outermost to innermost (the JAX package's).
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")
# The axes a batch is split over: a parameter's gradient is summed over
# those its spec leaves replicated.
BATCH_AXES = ("data", "fsdp", "seq")
# The axes a batch's rows are split over. A model whose activations are
# split over these alone (BERT, the ResNet: JAX's ``P(("data",
# "fsdp"))``) runs the same work on every rank along the other axes, so
# its gradients and loss are summed over these.
ROW_AXES = ("data", "fsdp")
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
    ``device`` is where this rank's tensors live. ``axis_groups`` maps an
    axis, or a tuple of axes in ``AXIS_ORDER``, to its process group."""

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
        self._deferred = ()

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

    def axes_group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (those of size 1 ignored; None when none is left;
        the whole mesh's group when every axis larger than 1 is named)."""
        live = tuple(a for a in AXIS_ORDER if a in axes and self.shape[a] > 1)
        if not live:
            return None
        if len(live) == 1:
            return self._axis_groups.get(live[0])
        if len(live) == sum(n > 1 for n in self.shape.values()):
            return self.group
        return self._axis_groups[live]

    def axes_size(self, axes):
        """The number of ranks in :meth:`axes_group`'s group."""
        return math.prod(self.shape[a] for a in set(axes))

    @contextlib.contextmanager
    def defer_grad_sum(self, *axes):
        """Within the block, :meth:`grad_group` leaves out ``axes``: a
        ZeRO step whose reduce-scatter sums the gradients over them
        (``parallel/zero.py``) so they are reduced once."""
        before = self._deferred
        self._deferred = before + tuple(axes)
        try:
            yield
        finally:
            self._deferred = before

    def grad_group(self, sharded=(), batch_axes=BATCH_AXES):
        """The group a parameter's gradient is summed over: the
        ``batch_axes`` (by default ``data``, ``fsdp``, ``seq``; ``ROW_AXES``
        for a model that splits rows alone) outside ``sharded`` (the axes
        its spec splits it over), less the axes :meth:`defer_grad_sum`
        defers; None when none larger than 1 is left. ``tensor`` and
        ``expert`` never: every rank along them runs the same tokens, so
        each already holds the whole gradient of what it computes."""
        return self.axes_group([a for a in batch_axes if a not in sharded
                                and a not in self._deferred])

    def batch_group(self, batch_axes=BATCH_AXES):
        """The group of the ranks holding different tokens (``data``,
        ``fsdp``, ``seq``, or ``batch_axes``): a loss's sum over the
        batch."""
        return self.axes_group(batch_axes)

    def shard(self, x, seq_dim=1):
        """This rank's block of a global [B, T, ...] tensor: the batch
        split over ``("data", "fsdp")`` (data major), dim ``seq_dim``
        over ``seq`` (None: the rows alone, as BERT and the ResNet take
        their batch)."""
        out = x
        n_fsdp = self.shape["fsdp"]
        batch = (self.coords["data"] * n_fsdp + self.coords["fsdp"],
                 self.shape["data"] * n_fsdp)
        splits = [(0, batch, "('data', 'fsdp')")]
        if seq_dim is not None:
            splits.append((seq_dim, (self.coords["seq"], self.shape["seq"]),
                           "'seq'"))
        for dim, (i, n), axis in splits:
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} ({out.shape[dim]}) does not "
                                 f"divide over the {axis} axes ({n})")
            step = out.shape[dim] // n
            out = out.narrow(dim, i * step, step)
        return out

    def shard_batch(self, batch, seq_dim=1):
        """:meth:`shard` of every entry of a dict of [B, T] tensors."""
        return {k: self.shard(torch.as_tensor(v), seq_dim)
                for k, v in batch.items()}


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
    if dev.type == "cuda":
        dev = torch.device("cuda", _env_int("HOROVOD_LOCAL_RANK", rank)
                           % torch.cuda.device_count()) \
            if dev.index is None else dev
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    axis_groups, group = open_groups(AXIS_ORDER, sizes, rank,
                                     timeout=_TIMEOUT, backend=backend)
    return Mesh(sizes, rank, dev, axis_groups, group)


def open_groups(order, sizes, rank, **group_kw):
    """The groups of a mesh of axes ``order`` (sizes ``sizes``, ranks
    laid out row-major) over the current world: ``(axis_groups, whole)``,
    ``axis_groups`` mapping each axis larger than 1, and each set of them
    short of all (a tuple in ``order``), to ``rank``'s group, ``whole``
    the whole mesh's. Every rank creates every group, in one order
    (``new_group`` is collective over the world): the single axes, the
    larger sets, then the whole mesh; ``group_kw`` goes to each
    ``new_group``."""
    world = math.prod(sizes[a] for a in order)
    grid = np.arange(world).reshape(tuple(sizes[a] for a in order))
    live = [a for a in order if sizes[a] > 1]
    axis_groups = {}
    for k in range(1, max(len(live), 2)):
        for axes in itertools.combinations(live, k):
            dims = [order.index(a) for a in axes]
            n = math.prod(sizes[a] for a in axes)
            lines = np.moveaxis(grid, dims, range(-k, 0)).reshape(-1, n)
            for line in lines:
                g = dist.new_group([int(r) for r in line], **group_kw)
                if rank in line:
                    axis_groups[axes[0] if k == 1 else axes] = g
    return axis_groups, dist.new_group(list(range(world)), **group_kw)
