"""ZeRO-1: the optimizer state sharded over the data ranks.

Counterpart of horovod_tpu/parallel/zero.py, with its own copy of the
layout math (``ring_owned_segment``, ``zero_bucket_layout``): the
gradient leaves are packed into dtype-homogeneous buckets, each padded
to a multiple of the shard count; every bucket is **reduce-scattered**
over the zero axis, so rank r receives the flat segment
``[r*s, (r+1)*s)`` it owns; the single-pass Adam of
``parallel.precision`` runs on that 1/N shard of the (params, mu, nu
[, f32 master]); the updated shards are **allgathered** back into the
replicated params. Per rank the optimizer state drops N-fold.

JAX runs the N ranks as one SPMD program (``shard_map``, or a
``vmap(axis_name=...)`` emulation) whose state is the global view, every
leaf split N ways on its leading dim. The port has one process per rank:
a rank's carry holds only its own block (``count`` is ``(1,)``, each
``mu``/``nu``/``master`` entry the rank's shard of its bucket), and the
collectives are ``dist.reduce_scatter_tensor`` and
``dist.all_gather_into_tensor`` over the zero axis's process group.
``models/convert.py`` moves a state between the two views.

Which gradients come in (the one reduction over the data ranks happens
here, in the reduce-scatter):

- without ``ZeroConfig.mesh`` each rank's gradient is of the mean loss
  over its own batch shard, and the scattered shard is multiplied by
  ``1/size`` (JAX's ``zero.py:395``): the mean gradient of the whole
  batch when the shards are equal;
- with a mesh the loss is the mesh's global one (``llama_loss(mesh=)``),
  and the train step defers the model's ``data``-axis gradient sum to
  the reduce-scatter (``Mesh.defer_grad_sum``), which sums; the model
  still sums over ``seq``.

A zero axis of size 1 is the identity: no collective runs, and the step
is bit-identical to the replicated one.

Memory at Llama-3-8B scale (single-leaf buckets of up to 1.9 B
elements): buckets are packed, scattered, updated and gathered one at a
time; a bucket of one unpadded leaf is a view of it, and its gathered
shards are written straight into the parameter; the Adam update runs in
chunks of the shard (elementwise, so the same bits as one pass).
``inter_axis`` (the cross-plane split of the pair) waits for ROADMAP.md
A9b.
"""

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.adam import adam_update
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from horovod_tpu_torch.parallel.precision import _bias_corrections

_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

#: default fused-bucket size (unpadded payload bytes), the JAX package's.
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

#: shard elements the Adam update takes at a time: bounds its f32
#: temporaries (about five of this size) at ~1.3 GB.
ADAM_CHUNK = 1 << 26


def ring_owned_segment(rank, size, rot=0):
    """Which ring segment ``rank`` holds fully reduced after the N-1
    reduce steps at rotation ``rot`` (``csrc/ring_ops.h
    RingOwnedSegment``): ``rot=0`` (allreduce) gives ``(r+1) % size``,
    ``rot=-1`` (reduce-scatter) gives ``r`` itself, which is why rank r
    owns flat segment r of every bucket here."""
    if size <= 0 or not 0 <= rank < size:
        raise ValueError(f"rank {rank} not in [0, {size})")
    return (rank + 1 + rot) % size


@dataclasses.dataclass(frozen=True)
class ZeroConfig:
    """How to shard the optimizer.

    ``axis`` names the mesh axis the shards live on (default ``"data"``);
    ``size`` is the shard count, by default ``mesh.shape[axis]``.
    Without ``mesh`` the shards live on the ranks of the
    ``torch.distributed`` world, whose size must be ``size`` (a ``size``
    of 1 needs no world), over a group ``init`` opens. ``bucket_bytes``
    is the fused-bucket granularity. ``inter_axis``/``inter_size``
    (JAX's cross-plane split) raise: ROADMAP.md A9b."""

    axis: str = "data"
    size: int = None
    mesh: Any = None
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    inter_axis: str = None
    inter_size: int = 1

    def resolved_size(self):
        if self.size is not None:
            return int(self.size)
        if self.mesh is not None:
            return int(self.mesh.shape[self.axis])
        raise ValueError("ZeroConfig needs size= or mesh=")


class ZeroAxis(NamedTuple):
    """This rank on the zero axis: its ``group`` (None at size 1),
    ``rank`` and ``size``, and ``scale``, the factor on the scattered
    gradient (``1/size``, or 1 under a mesh's global loss)."""
    group: Any
    rank: int
    size: int
    scale: float


def zero_axis(zero, device):
    """Resolve ``zero`` to this rank's :class:`ZeroAxis` for params on
    ``device``. Without a mesh every rank must call it (a group over the
    world is opened: NCCL for a CUDA ``device``, else gloo)."""
    size = zero.resolved_size()
    if zero.mesh is not None:
        mesh = zero.mesh
        if mesh.shape[zero.axis] != size:
            raise ValueError(f"ZeroConfig size {size} but the mesh's "
                             f"{zero.axis!r} axis has {mesh.shape[zero.axis]}")
        return ZeroAxis(mesh.axis_group(zero.axis),
                        mesh.axis_index(zero.axis), size, 1.0)
    if size == 1:
        return ZeroAxis(None, 0, 1, 1.0)
    if not dist.is_initialized() or dist.get_world_size() != size:
        raise ValueError(
            f"ZeroConfig(size={size}) without a mesh shards over the "
            "torch.distributed world, which must be joined at that size")
    group = dist.new_group(list(range(size)), backend=(
        "nccl" if torch.device(device).type == "cuda" else "gloo"))
    return ZeroAxis(group, dist.get_rank(), size, 1.0 / size)


# ---- bucket layout ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    indices: tuple   # leaf positions (into the flattened tree)
    sizes: tuple     # flat element count per leaf
    offsets: tuple   # leaf offsets within the unpadded concat
    dtype: Any
    nelems: int      # unpadded total elements
    padded: int      # padded to a multiple of n_shards

    def shard_elems(self, n_shards):
        return self.padded // n_shards

    @property
    def is_view(self):
        """One leaf and no padding: the packed bucket is the leaf."""
        return len(self.indices) == 1 and self.padded == self.nelems


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Partition of a flat leaf list into dtype-homogeneous buckets, each
    padded to a multiple of ``n_shards`` so every shard boundary is an
    offset inside a bucket."""

    buckets: tuple
    n_shards: int
    shapes: tuple    # per-leaf shapes (for unpack)
    dtypes: tuple    # per-leaf dtypes

    @property
    def padded_elems(self):
        return sum(b.padded for b in self.buckets)

    def pack_bucket(self, leaves, index, dtype=None):
        """Bucket ``index`` as one flat padded tensor (``dtype``, default
        the bucket's): a view of the leaf when the bucket is one
        unpadded leaf of that dtype, else a new tensor."""
        b = self.buckets[index]
        dtype = dtype or b.dtype
        first = leaves[b.indices[0]]
        if b.is_view and first.dtype == dtype:
            return first.reshape(-1)
        flat = torch.zeros(b.padded, dtype=dtype, device=first.device)
        for i, size, off in zip(b.indices, b.sizes, b.offsets):
            flat[off:off + size].copy_(leaves[i].reshape(-1))
        return flat

    def pack(self, leaves):
        """leaves -> list of flat padded 1-D tensors, one per bucket."""
        return [self.pack_bucket(leaves, i)
                for i in range(len(self.buckets))]

    def unpack(self, flat_buckets):
        """Inverse of :meth:`pack` (padding dropped); views of the flat
        buckets."""
        leaves = [None] * len(self.shapes)
        for b, flat in zip(self.buckets, flat_buckets):
            for i, size, off in zip(b.indices, b.sizes, b.offsets):
                leaves[i] = flat[off:off + size].reshape(self.shapes[i])
        return leaves

    def unpack_into(self, index, flat, leaves):
        """Copy bucket ``index``'s flat values into its leaves, in
        place."""
        b = self.buckets[index]
        for i, size, off in zip(b.indices, b.sizes, b.offsets):
            dst = leaves[i]
            src = flat[off:off + size].view(dst.shape)
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

    def pack_shard(self, leaves, bucket_index, rank, dtype=None):
        """Rank ``rank``'s shard of bucket ``bucket_index`` without the
        full packed bucket: only the leaf slices that overlap ``[rank*s,
        (rank+1)*s)`` are copied (a view when the bucket is one unpadded
        leaf of ``dtype``). The values of
        ``pack(leaves)[bucket_index][rank*s:(rank+1)*s]``."""
        b = self.buckets[bucket_index]
        dtype = dtype or b.dtype
        s = b.shard_elems(self.n_shards)
        lo, hi = rank * s, (rank + 1) * s
        first = leaves[b.indices[0]]
        if b.is_view and first.dtype == dtype:
            return first.reshape(-1)[lo:hi]
        shard = torch.zeros(s, dtype=dtype, device=first.device)
        for i, size, off in zip(b.indices, b.sizes, b.offsets):
            a, z = max(off, lo), min(off + size, hi)
            if a < z:
                shard[a - lo:z - lo].copy_(
                    leaves[i].reshape(-1)[a - off:z - off])
        return shard


def zero_bucket_layout(leaves, n_shards, bucket_bytes=DEFAULT_BUCKET_BYTES):
    """The fused-bucket partition of ``leaves`` (anything with ``shape``
    and a torch ``dtype``): grouped by dtype in tree order, a bucket
    closed when the next leaf would take it past ``bucket_bytes`` (a
    single over-sized leaf still gets exactly one bucket), each padded to
    a multiple of ``n_shards`` (and to at least ``n_shards``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    by_dtype = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buckets = []
    for dtype, idxs in by_dtype.items():
        cur, cur_bytes = [], 0
        itemsize = dtype.itemsize
        for i in idxs:
            n = int(math.prod(leaves[i].shape)) if leaves[i].shape else 1
            if cur and cur_bytes + n * itemsize > bucket_bytes:
                buckets.append((dtype, cur))
                cur, cur_bytes = [], 0
            cur.append((i, n))
            cur_bytes += n * itemsize
        if cur:
            buckets.append((dtype, cur))
    built = []
    for dtype, members in buckets:
        sizes = tuple(n for _, n in members)
        offsets, off = [], 0
        for n in sizes:
            offsets.append(off)
            off += n
        padded = -(-off // n_shards) * n_shards
        built.append(Bucket(indices=tuple(i for i, _ in members),
                            sizes=sizes, offsets=tuple(offsets),
                            dtype=dtype, nelems=off,
                            padded=max(padded, n_shards)))
    return BucketLayout(buckets=tuple(built), n_shards=n_shards,
                        shapes=tuple(tuple(l.shape) for l in leaves),
                        dtypes=tuple(l.dtype for l in leaves))


def optimizer_state_bytes(state):
    """Total bytes of the tensors of an optimizer state (namedtuples,
    tuples, lists and dicts of tensors)."""
    if torch.is_tensor(state):
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(optimizer_state_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(optimizer_state_bytes(v) for v in state)
    return 0


# ---- sharded optimizer state ----------------------------------------

class ZeroAdamState(NamedTuple):
    """This rank's block of the sharded fused-Adam state: ``count`` the
    ``(1,)`` int32 step counter, ``mu``/``nu`` tuples of this rank's
    shard of each bucket, in the bucket's dtype."""

    count: Any
    mu: Any
    nu: Any


class ZeroMasterAdamState(NamedTuple):
    """This rank's block of the sharded fused-master-Adam state: the
    master-dtype (f32) ``master`` shards and the f32 moments."""

    count: Any
    master: Any
    mu: Any
    nu: Any


def _optimizer_hyper(optimizer):
    hyper = getattr(optimizer, "hyper", None)
    if not hyper or hyper.get("kind") not in ("adam", "master_adam"):
        raise ValueError(
            "zero= needs a fused optimizer carrying its hyperparameters "
            "(parallel.precision.fused_adam / fused_master_adam); got "
            f"{optimizer!r}. It has no single-pass shard apply.")
    return hyper


class LeafSpec(NamedTuple):
    """A leaf's shape and dtype, for :func:`zero_bucket_layout`."""
    shape: tuple
    dtype: Any


def layout_leaves(hyper, params):
    """What the bucket layout is built from: the params' shapes and
    dtypes, the compute dtype for the master variant (the gradients'
    dtype: the reduce-scatter runs at their width, as in JAX's fused
    step)."""
    leaves = tree_leaves(params)
    if hyper["kind"] == "master_adam":
        return [LeafSpec(tuple(l.shape), hyper["compute_dtype"])
                for l in leaves]
    return leaves


def zero_state_init(hyper, layout, params, axis):
    """The ZeRO-1 carry ``(params, opt)``: this rank's shards of the
    state (the master packed from the params in the master dtype), and
    the params (their compute cast for the master variant)."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    count = torch.zeros((1,), dtype=torch.int32, device=device)
    n = len(layout.buckets)
    if hyper["kind"] == "master_adam":
        m_dtype = hyper.get("master_dtype", torch.float32)
        master = tuple(layout.pack_shard(leaves, i, axis.rank, m_dtype)
                       .clone() for i in range(n))
        opt = ZeroMasterAdamState(
            count=count, master=master,
            mu=tuple(torch.zeros_like(m) for m in master),
            nu=tuple(torch.zeros_like(m) for m in master))
        cd = hyper["compute_dtype"]
        params = tree_unflatten(params, [l.to(cd, copy=True)
                                         for l in leaves])
    else:
        opt = ZeroAdamState(
            count=count,
            mu=tuple(torch.zeros(b.shard_elems(layout.n_shards),
                                 dtype=b.dtype, device=device)
                     for b in layout.buckets),
            nu=tuple(torch.zeros(b.shard_elems(layout.n_shards),
                                 dtype=b.dtype, device=device)
                     for b in layout.buckets))
    return params, opt


# ---- the per-bucket apply -------------------------------------------

@torch.no_grad()
def shard_adam(hyper, p_shard, g_shard, mu, nu, count, out_dtype,
               master=False):
    """Adam on one flat shard, one ``adam_update`` (one kernel launch on
    the card) per ``ADAM_CHUNK`` elements: writes ``mu`` and ``nu`` (and,
    with ``master``, ``p_shard``) in place and returns the updated shard
    in ``out_dtype``. The chunks bound the plain version's temporaries on
    the CPU."""
    lr, b1, b2, eps = (hyper[k] for k in ("learning_rate", "b1", "b2",
                                          "eps"))
    bc1, bc2 = _bias_corrections(count, b1, b2)
    out = torch.empty(p_shard.shape, dtype=out_dtype, device=p_shard.device)
    for lo in range(0, p_shard.numel(), ADAM_CHUNK):
        sl = slice(lo, lo + ADAM_CHUNK)
        if master:
            adam_update(p_shard[sl], g_shard[sl], mu[sl], nu[sl], lr, b1, b2,
                        eps, bc1, bc2, cast=out[sl])
        else:
            adam_update(p_shard[sl], g_shard[sl], mu[sl], nu[sl], lr, b1, b2,
                        eps, bc1, bc2, out=out[sl])
    return out


class ZeroApply:
    """The apply's pieces for one layout on one rank, each per bucket:
    :meth:`reduce_scatter` (async), :meth:`update` (the shard's Adam
    step, the state written in place) and :meth:`all_gather` (the
    updated shards into the params, in place). ``apply`` strings them
    together one bucket at a time; the fused train step issues the
    reduce-scatters from autograd hooks instead."""

    def __init__(self, hyper, layout, axis):
        self.hyper = hyper
        self.layout = layout
        self.axis = axis
        self.master = hyper["kind"] == "master_adam"

    def reduce_scatter(self, index, flat):
        """Start bucket ``index``'s reduce-scatter of the packed gradient
        ``flat``: returns ``(shard, work)``; ``work`` is None at size 1
        (the shard is ``flat`` itself)."""
        ax = self.axis
        if ax.group is None:
            return flat, None
        s = self.layout.buckets[index].shard_elems(ax.size)
        out = torch.empty(s, dtype=flat.dtype, device=flat.device)
        work = _reduce_scatter_flat(out, flat, op=dist.ReduceOp.SUM,
                                    group=ax.group, async_op=True)
        return out, work

    def update(self, index, g_shard, p_leaves, opt, count):
        """Adam on this rank's shard of bucket ``index``; writes
        mu/nu (and the master) in place and returns the updated shard in
        the params' dtype."""
        if self.axis.scale != 1.0:
            g_shard = g_shard * self.axis.scale
        if self.master:
            return shard_adam(self.hyper, opt.master[index], g_shard,
                              opt.mu[index], opt.nu[index], count[0],
                              self.hyper["compute_dtype"], master=True)
        p_shard = self.layout.pack_shard(p_leaves, index, self.axis.rank)
        return shard_adam(self.hyper, p_shard, g_shard, opt.mu[index],
                          opt.nu[index], count[0], p_shard.dtype)

    def all_gather(self, index, out_shard, p_leaves):
        """Start the allgather of bucket ``index``'s updated shards into
        its params; returns ``finish()``, which waits and writes them."""
        b = self.layout.buckets[index]
        ax = self.axis
        direct = b.is_view and p_leaves[b.indices[0]].dtype == \
            out_shard.dtype
        if ax.group is None:
            flat, work = out_shard, None
        else:
            flat = p_leaves[b.indices[0]].view(-1) if direct else \
                torch.empty(b.padded, dtype=out_shard.dtype,
                            device=out_shard.device)
            work = _all_gather_flat(flat, out_shard, group=ax.group,
                                    async_op=True)

        def finish():
            if work is not None:
                work.wait()
            self.layout.unpack_into(index, flat, p_leaves)

        return finish

    @torch.no_grad()
    def apply(self, grad_leaves, p_leaves, opt):
        """The unfused apply, one bucket at a time: pack, reduce-scatter,
        update, allgather into the params. Returns the new state."""
        count = opt.count + 1
        for i in range(len(self.layout.buckets)):
            flat = self.layout.pack_bucket(grad_leaves, i)
            g_shard, work = self.reduce_scatter(i, flat)
            if work is not None:
                work.wait()
            del flat
            self.all_gather(i, self.update(i, g_shard, p_leaves, opt,
                                           count), p_leaves)()
        return opt._replace(count=count)


def make_zero_apply(optimizer, zero):
    """The ZeRO apply for ``make_split_train_step``: returns ``(apply_fn,
    init)``. ``init(params) -> (params, opt)`` builds the layout and this
    rank's carry; ``apply_fn(grads, params, opt) -> (params, opt)``
    updates the params in place (the port's counterpart of JAX's
    donation) and returns them with the new state. ``apply_fn.program``
    is the :class:`ZeroApply` after ``init``."""
    hyper = _optimizer_hyper(optimizer)
    if zero.inter_axis is not None or int(zero.inter_size) > 1:
        raise NotImplementedError(
            "ZeroConfig.inter_axis (the cross-plane reduce-scatter/"
            "allgather split) is not ported yet (ROADMAP.md A9b)")
    programs = []

    def init(params):
        axis = zero_axis(zero, tree_leaves(params)[0].device)
        layout = zero_bucket_layout(layout_leaves(hyper, params),
                                    axis.size, zero.bucket_bytes)
        programs[:] = [ZeroApply(hyper, layout, axis)]
        apply_fn.program = programs[0]
        return zero_state_init(hyper, layout, params, axis)

    def apply_fn(grads, params, opt):
        if not programs:
            raise RuntimeError("call init(params) before the ZeRO apply")
        opt = programs[0].apply(tree_leaves(grads), tree_leaves(params),
                                opt)
        return params, opt

    apply_fn.program = None
    return apply_fn, init
