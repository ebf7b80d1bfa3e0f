"""Differentiable collectives over a mesh axis's process group.

Counterpart of horovod_tpu/parallel/ops.py's ``psum``, ``all_gather``,
``reduce_scatter`` and ``all_to_all``, and of the ring shift that
sequence parallelism uses (``ppermute_ring``; an axis's index and size
are ``Mesh.axis_index`` and ``Mesh.axis_size``). Under JAX's
``shard_map`` these are XLA collectives with transposes; here each is a
``torch.autograd.Function`` over ``torch.distributed`` with the same
transpose as its backward:

- :func:`psum`: all-reduce Sum; its output is replicated over the group,
  so its cotangent is taken as replicated too and passes through
  unchanged (JAX's psum of a device-varying value).
- :func:`replicate`: identity; the backward all-reduces each gradient
  (Sum). It marks replicated parameters entering per-rank work: the
  reduction JAX's GSPMD inserts for a replicated weight.
- :func:`all_gather`: the tiled all-gather along an axis; its backward
  is the reduce-scatter sum (each member's cotangent is its own
  contribution to the gathered tensor).
- :func:`reduce_scatter`: the tiled sum-then-scatter; its backward is
  the all-gather.
- :func:`all_gather_invariant`: the same all-gather for a result every
  member then uses alike (``lax.all_gather_invariant``): its cotangent
  is the same on every member, so the backward keeps this member's
  block of it and sums nothing.
- :func:`all_to_all`: the tiled all-to-all; its backward is the inverse
  all-to-all.
- :func:`hier_allreduce`: the cross-plane allreduce (reduce-scatter over
  the intra group, all-reduce of the shard over the inter group,
  all-gather over intra), made of the three above, whose backwards it
  takes.

``psum`` and ``replicate`` are Megatron's g and f: a tensor-parallel
block enters through ``replicate`` and leaves through ``psum``.
- :func:`ppermute_ring`: rank i's tensors to rank i + shift of the
  group; its backward is the inverse shift. One
  ``dist.batch_isend_irecv`` per call, so gloo never deadlocks on the
  order of sends and receives.

:func:`predicted_hier_collectives` and :func:`predicted_zero_collectives`
are the host-side predictions hvdlint's C5 holds the recorded
``hier_allreduce`` and ZeRO apply to (``analysis/``).

A ``None`` group is a mesh axis of size 1 (``Mesh.axis_group``): each op
is then the identity, as JAX's collectives over a size-1 axis are.
``None`` never stands for the default group here.
"""

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x, group):
    """Sum of ``x`` over ``group``, replicated on every member."""
    if group is None:
        return x
    return _Psum.apply(x, group)


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # Autograd materialises an absent gradient as zeros: every g is a
        # tensor, summed in a copy of its own.
        gs = [g.clone(memory_format=torch.contiguous_format) for g in gs]
        for w in [dist.all_reduce(g, group=ctx.group, async_op=True)
                  for g in gs]:
            w.wait()
        return (None, *gs)


def replicate(xs, group):
    """The tensors ``xs`` unchanged; in the backward each gradient is
    summed over ``group``."""
    if group is None:
        return tuple(xs)
    return _Replicate.apply(group, *xs)


_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# The tiled collectives return contiguous tensors, as JAX's arrays are:
# a gathered weight feeds kernels that take contiguous operands (K5), and
# a scattered gradient the Adam kernel.
def _gather(x, group, axis):
    n = dist.get_world_size(group)
    xt = x.movedim(axis, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    _all_gather_flat(out, xt, group=group)
    return out.movedim(0, axis).contiguous()


def _scatter_sum(x, group, axis):
    n = dist.get_world_size(group)
    xt = x.movedim(axis, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
    _reduce_scatter_flat(out, xt, group=group)
    return out.movedim(0, axis).contiguous()


def _own_block(x, group, axis):
    n = dist.get_world_size(group)
    step = x.shape[axis] // n
    return x.narrow(axis, dist.get_rank(group) * step, step).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = group, axis
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = group, axis
        return _scatter_sum(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = group, axis
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _own_block(g, *ctx.args), None, None


def _tiled(fn, x, group, axis, what):
    if group is None:
        return x
    axis = axis % x.dim()
    if what == "reduce_scatter" and x.shape[axis] % dist.get_world_size(
            group):
        raise ValueError(f"reduce_scatter: dim {axis} ({tuple(x.shape)}) "
                         "does not divide over the group")
    return fn.apply(x, group, axis)


def all_gather(x, group, axis=0):
    """The members' ``x`` joined along ``axis`` in member order (JAX's
    tiled ``all_gather``). The backward reduce-scatters the cotangent:
    member i gets the sum over the group of block i."""
    return _tiled(_AllGather, x, group, axis, "all_gather")


def reduce_scatter(x, group, axis=0):
    """The sum over ``group`` of ``x``, cut into group-size blocks along
    ``axis``; member i keeps block i (JAX's tiled ``psum_scatter``). The
    backward all-gathers the cotangent."""
    return _tiled(_ReduceScatter, x, group, axis, "reduce_scatter")


def all_gather_invariant(x, group, axis=0):
    """:func:`all_gather` for a result that every member uses alike (a
    tensor-parallel rank's copy of a replicated computation): the
    backward keeps this member's block of the cotangent."""
    return _tiled(_AllGatherInvariant, x, group, axis, "all_gather")


def hier_allreduce(x, intra, inter, axis=0):
    """The sum of ``x`` over the ranks of the ``intra`` and ``inter``
    groups, cross-plane (JAX's ``hier_allreduce``): reduce-scattered
    along ``axis`` over ``intra``, the 1/L shard summed over ``inter``
    (only it crosses that plane), all-gathered back over ``intra``.
    Equal to ``psum`` over both up to the order of the f32 sums."""
    return all_gather(psum(reduce_scatter(x, intra, axis), inter), intra,
                      axis)


def _all_to_all(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    inp = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, \
            None


def all_to_all(x, group, split_axis, concat_axis):
    """JAX's tiled ``all_to_all``: ``x`` cut into ``group``-size chunks
    along ``split_axis``, chunk j sent to member j, the chunks received
    joined along ``concat_axis`` in member order."""
    if group is None:
        return x
    if x.shape[split_axis] % dist.get_world_size(group):
        raise ValueError(f"all_to_all: dim {split_axis} ({x.shape}) does "
                         "not divide over the group")
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _shift(xs, group, shift):
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    ops = [op for x, out in zip(xs, outs) for op in (
        dist.P2POp(dist.isend, x, dst, group),
        dist.P2POp(dist.irecv, out, src, group))]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *xs):
        ctx.args = group, shift
        return tuple(_shift(xs, group, shift))

    @staticmethod
    def backward(ctx, *gs):
        group, shift = ctx.args
        return (None, None, *_shift(gs, group, -shift))


def ppermute_ring(xs, group, shift=1):
    """The tensors ``xs`` of member i sent to member i + ``shift`` of
    ``group`` (mod its size); returns those received from member
    i - ``shift``."""
    if group is None:
        return tuple(xs)
    return _Ppermute.apply(group, shift, *xs)


def predicted_hier_collectives(intra_axis, inter_axis):
    """The host-side collective prediction for :func:`hier_allreduce`
    (JAX's): fed to hvdlint's C5, so the composed-plane program and this
    table cannot silently diverge."""
    return [("psum_scatter", (intra_axis,)),
            ("psum", (inter_axis,)),
            ("all_gather", (intra_axis,))]


def predicted_zero_collectives(n_buckets, axis, inter_axis=None):
    """The host-side collective prediction for the unfused ZeRO-1 apply
    (``parallel.zero.ZeroApply.apply``, JAX's): per bucket, a
    reduce-scatter over the zero ``axis``, the optional cross-plane psum
    of the shard over ``inter_axis``, and the all-gather of the updated
    shard back over ``axis``. The fused step issues the same collectives
    scatters first (each from the backward), so this is the unfused
    schedule's contract (``HOROVOD_JIT_FUSION=0``)."""
    out = []
    for _ in range(int(n_buckets)):
        out.append(("psum_scatter", (axis,)))
        if inter_axis is not None:
            out.append(("psum", (inter_axis,)))
        out.append(("all_gather", (axis,)))
    return out
