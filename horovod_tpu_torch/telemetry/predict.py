"""Collective-byte predictors: what a step should move, for the
measured-against-predicted reconciliation of :class:`StepTimer`.

The port's own copy of ``horovod_tpu/telemetry/predict.py``.
:func:`collective_bytes` sums the signature hvdlint's recorder takes of
any program (``analysis/extract.py``: the program run once, for one rank
of a ``fake`` world), as the JAX package's sums its jaxpr walker's: one
extractor, so the analyzer and the byte counters cannot disagree about
what a program moves. The eager lane's steps have their own predictors,
built from what the step executes: one allreduce a gradient leaf
(:func:`eager_allreduce_bytes`), or one reduce-scatter and one allgather
a padded bucket of ``parallel.zero.zero_bucket_layout``
(:func:`eager_zero_bytes`), each a :class:`Collective` summed by
:func:`signature_bytes` / :func:`zero_signature_bytes`, which also take
the recorder's signatures. The gradients are those of one backward of
``loss_fn`` on ``params`` and ``batch``.
"""

import collections

import torch

from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten

#: One collective of a signature: its primitive ("psum",
#: "psum_scatter", "all_gather"), its operand's elements and dtype name.
Collective = collections.namedtuple("Collective", "prim nelems dtype")


def _dtype_bytes(name):
    """Bytes an element of a dtype name (a mixed-dtype record's names
    are comma-joined; the repo's collectives are homogeneous)."""
    return getattr(torch, name.split(",")[0] or "float32").itemsize


def signature_bytes(signature):
    """Payload bytes summed over a signature (a list of
    :class:`Collective`, or of the recorder's
    ``analysis.extract.Collective``)."""
    return sum(c.nelems * _dtype_bytes(c.dtype) for c in signature)


def collective_bytes(fn, *args, mesh=None, axis_env=None):
    """Predicted per-call collective payload bytes of ``fn(*args)`` on
    rank 0 (operands' bytes, loops as the run took them).

    ``mesh`` (a port mesh, for its shape) or ``axis_env`` (``[(name,
    size), ...]``) sizes the fake world the program runs in, as
    ``analysis.lint``'s; a single callable argument is ``args(mesh) ->
    tuple``, the rank's inputs built in its world."""
    from horovod_tpu_torch.analysis.api import _axis_env_from_mesh
    from horovod_tpu_torch.analysis.extract import extract

    env = list(axis_env) if axis_env is not None \
        else _axis_env_from_mesh(mesh)
    a = args[0] if len(args) == 1 and callable(args[0]) else args
    ex = extract(fn, a, axis_env=env, ranks=(0,))
    return signature_bytes(ex.signature)


def _grads(loss_fn, params, batch):
    """The gradient leaves of ``loss_fn(params, batch)`` w.r.t. every
    leaf of ``params`` (zeros for an unused leaf, as ``jax.grad``)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        return torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def eager_allreduce_bytes(loss_fn, params, batch, size=2):
    """Predicted payload bytes a step of the eager data-parallel step:
    one allreduce a gradient leaf (grouped or not, the payload is the
    same; ``size`` does not change it, as in the JAX package)."""
    del size
    return signature_bytes([
        Collective("psum", g.numel(), _dtype_name(g.dtype))
        for g in _grads(loss_fn, params, batch)])


def zero_signature_bytes(signature, size):
    """Payload bytes as the lane's counters book the ZeRO mix: a
    reduce-scatter at its full input width, an allgather at its gathered
    width (``size`` x the operand), one convention on both sides."""
    total = 0
    for c in signature:
        n = c.nelems * _dtype_bytes(c.dtype)
        if c.prim == "all_gather":
            n *= size
        total += n
    return total


def eager_zero_bytes(loss_fn, params, batch, size=2, bucket_bytes=None):
    """Predicted payload bytes a step of the eager ZeRO-1 step
    (``hvd.DistributedFusedAdam(zero=True)``): a reduce-scatter a padded
    gradient bucket down, an allgather of its updated shard up, from the
    same ``zero_bucket_layout`` the optimizer runs."""
    from horovod_tpu_torch.parallel.zero import (
        DEFAULT_BUCKET_BYTES,
        zero_bucket_layout,
    )

    layout = zero_bucket_layout(list(_grads(loss_fn, params, batch)), size,
                                bucket_bytes or DEFAULT_BUCKET_BYTES)
    signature = []
    for b in layout.buckets:
        name = _dtype_name(b.dtype)
        signature += [Collective("psum_scatter", b.padded, name),
                      Collective("all_gather", b.padded // size, name)]
    return zero_signature_bytes(signature, size)


def zero_layout_bytes(layout):
    """The cross-check of :func:`eager_zero_bytes` from a layout alone:
    every padded bucket crosses once as a reduce-scatter input and once
    as a gathered allgather output."""
    return sum(2 * b.padded * b.dtype.itemsize for b in layout.buckets)


def hier_allreduce_wire_bytes(count, itemsize, size, local_size, rank,
                              compress_cross=False, compressed=False):
    """Per-rank, per-plane wire tx bytes of one hierarchical allreduce,
    ``{"intra": ..., "cross": ...}`` (``parallel.reshard``'s segment
    math, the planner's)."""
    from horovod_tpu_torch.parallel.reshard import hier_wire_bytes

    return hier_wire_bytes(count, itemsize, size, local_size, rank,
                           compress_cross=compress_cross,
                           compressed=compressed)


def flat_ring_wire_bytes(count, itemsize, size, rank, compressed=False):
    """Per-rank wire tx bytes of one flat ring allreduce."""
    from horovod_tpu_torch.parallel.reshard import flat_allreduce_wire_bytes

    return flat_allreduce_wire_bytes(count, itemsize, size, rank,
                                     compressed=compressed)


def redistribute_bytes(plan, rank=None):
    """Predicted wire tx bytes of a ``ReshardPlan`` (this rank, or the
    world)."""
    return plan.wire_tx_bytes(rank)


def grad_tree_bytes(loss_fn, params, batch):
    """The gradient tree's bytes from the params alone (a torch
    gradient has its leaf's shape and dtype): the cross-check of
    :func:`eager_allreduce_bytes`."""
    del loss_fn, batch
    return sum(p.numel() * p.element_size() for p in tree_leaves(params))
