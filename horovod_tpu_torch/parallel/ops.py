"""Differentiable collectives over a mesh axis's process group.

Counterpart of the parts of horovod_tpu/parallel/ops.py that sequence
parallelism uses (``psum``, ``all_to_all``, ``ppermute_ring``; an
axis's index and size are ``Mesh.axis_index`` and ``Mesh.axis_size``).
Under JAX's ``shard_map`` these are
XLA collectives with transposes; here each is a
``torch.autograd.Function`` over ``torch.distributed`` with the same
transpose as its backward:

- :func:`psum`: all-reduce Sum; its output is replicated over the group,
  so its cotangent is taken as replicated too and passes through
  unchanged (JAX's psum of a device-varying value).
- :func:`replicate`: identity; the backward all-reduces each gradient
  (Sum). It marks replicated parameters entering per-rank work: the
  reduction JAX's GSPMD inserts for a replicated weight.
- :func:`all_to_all`: the tiled all-to-all; its backward is the inverse
  all-to-all.
- :func:`ppermute_ring`: rank i's tensors to rank i + shift of the
  group; its backward is the inverse shift. One
  ``dist.batch_isend_irecv`` per call, so gloo never deadlocks on the
  order of sends and receives.

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
