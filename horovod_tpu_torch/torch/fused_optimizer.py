"""The functional optimizer lane: gradient trees through the lane, the
fused single-pass Adam, and its ZeRO-1 form.

Counterpart of horovod_tpu/jax/optimizer.py (``allreduce_gradients``:51,
``DistributedFusedAdam``:131, ``_zero_fused_adam``:218,
``make_fused_train_step``:320), on the port's lane
(``torch/mpi_ops.py``): NCCL for CUDA tensors, gloo for CPU tensors.
Params, gradients and states are nested dicts of tensors
(``parallel/_tree.py``); an apply updates the params and the state in
place and returns them, as ``parallel.precision``'s do (the port's
counterpart of JAX's donation).

Each completed apply marks a step boundary on the lane's step marks
(``telemetry.core.step_mark`` with ``owner="optimizer"``): window k runs
from apply k to apply k + 1, one whole train step. It defers to a window
another driver opened, by the window's owner first (a ``StepTimer``'s
explicit scope) and then by its id (a caller that did not say who it
is), as JAX's ``_mark_optimizer_step`` does: an id alone cannot tell the
optimizer's own last window from a timer's window that carries the same
id, and taking the timer's window mid-step would split the step's
overlap ledger in two.
``DistributedGradientTransformation`` (an optax wrapper) is not ported:
the port has no optax.
"""

import functools

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel import fusion
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from horovod_tpu_torch.parallel.precision import FusedOptimizer, fused_adam
from horovod_tpu_torch.parallel.train_step import _value_and_grad
from horovod_tpu_torch.parallel.zero import (
    DEFAULT_BUCKET_BYTES,
    carry_layout,
    check_blocks,
    shard_adam,
    zero_bucket_layout,
)
from horovod_tpu_torch.telemetry import core as tcore
from horovod_tpu_torch.torch import mpi_ops
from horovod_tpu_torch.torch.compression import Compression

_last_boundary_id = None


def _mark_optimizer_step():
    """Close the step an earlier apply opened and open the next, unless
    another driver's window is open."""
    global _last_boundary_id
    if tcore.window_owner() not in (None, "optimizer"):
        return   # an explicit scope (a StepTimer) owns the window
    open_id = tcore.step_id()
    if open_id >= 0 and open_id != _last_boundary_id:
        return   # a driver that did not say who it is opened it
    _last_boundary_id = tcore.step_mark(True, owner="optimizer")


def _boundary_marked(apply_fn):
    @functools.wraps(apply_fn)
    def apply(params, grads, state):
        out = apply_fn(params, grads, state)
        _mark_optimizer_step()
        return out

    return apply


def allreduce_gradients(grads, op=mpi_ops.Average,
                        compression=Compression.none, prefix="grad",
                        donate=False):
    """Allreduce a gradient tree across the ranks: one grouped allreduce
    per dtype (an atomic group the lane fuses), leaf i named
    ``{prefix}.{i}``. ``donate=True`` reduces in place: the caller's
    (compressed) gradient tensors receive the result."""
    leaves = tree_leaves(grads)
    compressed, ctxs = [], []
    for leaf in leaves:
        c, ctx = compression.compress(leaf)
        compressed.append(c)
        ctxs.append(ctx)
    by_dtype = {}
    for i, c in enumerate(compressed):
        by_dtype.setdefault(c.dtype, []).append(i)
    grouped = mpi_ops.grouped_allreduce_async_ if donate else \
        mpi_ops.grouped_allreduce_async
    handles = [None] * len(leaves)
    for idxs in by_dtype.values():
        for i, h in zip(idxs, grouped([compressed[i] for i in idxs],
                                      names=[f"{prefix}.{i}" for i in idxs],
                                      op=op)):
            handles[i] = h
    return tree_unflatten(grads, [
        compression.decompress(h.synchronize(), ctx)
        for h, ctx in zip(handles, ctxs)])


def DistributedFusedAdam(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                         op=mpi_ops.Average, compression=Compression.none,
                         zero=False, bucket_bytes=None, overlap=True):
    """The lane's counterpart of ``parallel.precision.fused_adam``:
    ``init(params) -> state``, ``apply(params, grads, state) -> (params,
    state)``. ``apply`` allreduces the gradient tree (in place: the
    caller's gradients receive the reduced values), then runs the
    single-pass Adam.

    ``zero=True`` is ZeRO-1 on the lane: the gradients packed into
    shard-aligned buckets (``bucket_bytes``, ``parallel/zero.py``'s
    layout), each bucket reduce-scattered (``zero.rs.i``), Adam on this
    rank's 1/N shard, the updated shards allgathered (``zero.ag.i``) into
    the params. With ``overlap`` (default) every reduce-scatter is in
    flight before the first shard update, and each bucket's allgather
    starts as soon as its update is done; ``overlap=False`` runs the
    phases one after another, with the same bits. ``compression``
    applies to the allgathered params there (every rank, the shard's
    owner too, takes the decompressed bits); the reduce-scatter rides
    ``HOROVOD_WIRE_COMPRESSION``."""
    if zero:
        zopt = _zero_fused_adam(learning_rate, b1, b2, eps, op, compression,
                                bucket_bytes, overlap)
        return FusedOptimizer(init=zopt.init,
                              apply=_boundary_marked(zopt.apply),
                              hyper=zopt.hyper)
    inner = fused_adam(learning_rate, b1=b1, b2=b2, eps=eps)

    def apply(params, grads, state):
        grads = allreduce_gradients(grads, op=op, compression=compression,
                                    donate=True)
        return inner.apply(params, grads, state)

    return FusedOptimizer(init=inner.init, apply=_boundary_marked(apply),
                          hyper=inner.hyper)


def _zero_state(layout, device):
    """This rank's zeroed block of each bucket's moments, with the
    carry's ``zero_layout`` (``parallel.zero.ZeroCarryLayout``: what
    ``hvd.elastic.TreeState`` re-lays the blocks out by)."""
    n = layout.n_shards

    def shard(b):
        return torch.zeros(b.shard_elems(n), dtype=b.dtype, device=device)

    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": [shard(b) for b in layout.buckets],
            "nu": [shard(b) for b in layout.buckets],
            "zero_layout": carry_layout(layout, mpi_ops.rank())}


class _Layouts:
    """The bucket layout of each tree structure (leaf shapes and
    dtypes) this rank has seen, over ``mpi_ops.size()`` shards, keyed by
    the world's size and epoch as well: after an elastic re-formation
    the buckets pad to the new shard count."""

    def __init__(self, bucket_bytes):
        self.bucket_bytes = bucket_bytes or DEFAULT_BUCKET_BYTES
        self._cache = {}

    def __call__(self, leaves):
        key = (mpi_ops.size(), basics.epoch(),
               tuple((tuple(l.shape), l.dtype) for l in leaves))
        if key not in self._cache:
            self._cache[key] = zero_bucket_layout(leaves, mpi_ops.size(),
                                                  self.bucket_bytes)
        return self._cache[key]


def _gathered(handles, ctxs, compression, layout, p_leaves):
    """Wait for each bucket's allgather and write it into the params."""
    with torch.no_grad():
        for i, (h, ctx) in enumerate(zip(handles, ctxs)):
            flat = compression.decompress(h.synchronize(), ctx)
            layout.unpack_into(i, flat, p_leaves)


def _updated_shards(hyper, layout, p_leaves, state, count, scattered,
                    compression):
    """Adam on this rank's shard of each bucket, in the order of
    ``scattered`` (bucket -> its reduced gradient shard, or the handle of
    its reduce-scatter in flight; emptied as it goes); yields ``(bucket,
    compressed updated shard, ctx)`` for the bucket's allgather."""
    rank = mpi_ops.rank()
    for i in list(scattered):
        g_shard = scattered.pop(i)
        if isinstance(g_shard, mpi_ops.Handle):
            g_shard = g_shard.synchronize()
        p_shard = layout.pack_shard(p_leaves, i, rank)
        yield (i, *compression.compress(shard_adam(
            hyper, p_shard, g_shard, state["mu"][i], state["nu"][i], count,
            p_shard.dtype)))


def _zero_fused_adam(learning_rate, b1, b2, eps, op, compression,
                     bucket_bytes, overlap):
    """``DistributedFusedAdam(zero=True)``: one negotiation name per
    bucket per phase, so the response cache stays hot."""
    hyper = {"kind": "adam", "zero1": True, "learning_rate": learning_rate,
             "b1": b1, "b2": b2, "eps": eps}
    layouts = _Layouts(bucket_bytes)

    def init(params):
        leaves = tree_leaves(params)
        return _zero_state(layouts(leaves), leaves[0].device)

    def apply(params, grads, state):
        g_leaves = tree_leaves(grads)
        layout = layouts(g_leaves)
        check_blocks(state, layout.n_shards, mpi_ops.rank())
        p_leaves = tree_leaves(params)
        count = state["count"] + 1
        n = len(layout.buckets)
        rs = {}
        for i in range(n):
            h = mpi_ops.reducescatter_async(
                layout.pack_bucket(g_leaves, i), name=f"zero.rs.{i}", op=op)
            rs[i] = h if overlap else h.synchronize()
        del g_leaves
        ag, ctxs = [None] * n, [None] * n
        for i, c, ctxs[i] in _updated_shards(hyper, layout, p_leaves, state,
                                             count, rs, compression):
            ag[i] = mpi_ops.allgather_async(c, name=f"zero.ag.{i}") \
                if overlap else c
        if not overlap:
            ag = mpi_ops.grouped_allgather_async(
                ag, names=[f"zero.ag.{i}" for i in range(n)])
        _gathered(ag, ctxs, compression, layout, p_leaves)
        return params, dict(state, count=count)

    return FusedOptimizer(init=init, apply=apply, hyper=hyper)


def make_fused_train_step(loss_fn, learning_rate, b1=0.9, b2=0.999,
                          eps=1e-8, op=mpi_ops.Average,
                          compression=Compression.none, bucket_bytes=None):
    """The lane's fused ZeRO-1 train step: each bucket's reduce-scatter
    (``fusion.rs.i``) starts from an autograd hook as the backward
    completes the bucket (``parallel/fusion.py``), so the wire drains
    under the rest of the backward; each bucket's shard update and
    allgather (``fusion.ag.i``) then follow in the order the buckets
    completed, and the allgathers stay in flight into the next ``step``,
    which drains them before its forward reads the params.

    ``HOROVOD_JIT_FUSION=0`` (or ``hvd.init(jit_fusion=False)``), read at
    every step, runs the same step bulk-synchronously: the whole
    backward, every reduce-scatter drained, then the updates, and the
    params complete before ``step`` returns. Same collectives, same
    operands: the same bits.

    Returns ``(init, step, finish)``: ``init(params) -> carry``,
    ``step(carry, batch) -> (loss, carry)`` (the params may lag one step
    behind their allgathers), ``finish(carry) -> (params, carry)`` drains
    them; call it before reading the params."""
    hyper = {"kind": "adam", "zero1": True, "learning_rate": learning_rate,
             "b1": b1, "b2": b2, "eps": eps}
    layouts = _Layouts(bucket_bytes)

    def init(params):
        leaves = tree_leaves(params)
        return (params, _zero_state(layouts(leaves), leaves[0].device),
                None)

    def _drain(params, pending):
        if pending is not None:
            handles, ctxs, layout = pending
            _gathered(handles, ctxs, compression, layout,
                      tree_leaves(params))
        return params

    def step(carry, batch):
        params, state, pending = carry
        params = _drain(params, pending)
        p_leaves = tree_leaves(params)
        layout = layouts(p_leaves)
        check_blocks(state, layout.n_shards, mpi_ops.rank())
        count = state["count"] + 1
        rs = {}

        def start(i, leaves):
            rs[i] = mpi_ops.reducescatter_async(
                layout.pack_bucket(leaves, i), name=f"fusion.rs.{i}", op=op)

        fused = fusion.jit_fusion_enabled()
        if fused:
            loss, _ = fusion.value_and_grad_bucketed(
                loss_fn, params, batch, 1, layout, start)
        else:
            loss, grads = _value_and_grad(loss_fn, params, batch, 1)
            g_leaves = tree_leaves(grads)
            for i in range(len(layout.buckets)):
                start(i, g_leaves)
            del grads, g_leaves
            for i in rs:
                rs[i] = rs[i].synchronize()
        ag, ctxs = [None] * len(rs), [None] * len(rs)
        for i, c, ctxs[i] in _updated_shards(hyper, layout, p_leaves, state,
                                             count, rs, compression):
            ag[i] = mpi_ops.allgather_async(c, name=f"fusion.ag.{i}")
        state = dict(state, count=count)
        pending = (ag, ctxs, layout)
        if not fused:
            params = _drain(params, pending)
            pending = None
        _mark_optimizer_step()
        return loss, (params, state, pending)

    def finish(carry):
        params, state, pending = carry
        params = _drain(params, pending)
        return params, (params, state, None)

    return init, step, finish
