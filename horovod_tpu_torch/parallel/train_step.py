"""The split train step: gradient calls per microbatch, then one fused
optimizer apply.

Counterpart of horovod_tpu/parallel/train_step.py's
``make_split_train_step`` with a fused optimizer (``precision``). JAX
compiles the grad and apply as two jits joined by donated buffers;
PyTorch runs eagerly, so the same structure is a gradient call per
microbatch (``torch.autograd.grad``) accumulating into the first call's
gradient tensors, then the optimizer's in-place apply.

Semantics as in the JAX package: with N microbatches the loss is scaled
by 1/N inside each gradient call, so the accumulated gradients are the
full-batch mean-loss gradients and the accumulated loss is the
full-batch mean loss; gradients accumulate in the params' dtype (a bf16
add rounds as ``jnp.add`` does). The step follows the params' device
and never moves them.

``zero=`` (a ``parallel.zero.ZeroConfig``) makes the apply ZeRO-1's:
the gradient buckets reduce-scattered over the zero axis, Adam on this
rank's 1/N shard of the state, the params allgathered back. Its two
layouts, chosen by ``HOROVOD_JIT_FUSION`` (``parallel.fusion``) when the
step is built: unfused, the gradient calls and then the apply one bucket
at a time; fused (the default), each bucket's reduce-scatter starts from
an autograd hook as the backward of the last microbatch completes the
bucket (after its gradient is added into the accumulator), so it
overlaps the rest of the backward. Both give the same bits. Under
``ZeroConfig.mesh`` the gradient calls run inside
``mesh.defer_grad_sum(zero.axis, zero.inter_axis)``, so the model sums
its gradients over the other mesh axes and the reduce-scatter (and the
cross-plane sum) alone over those;
without a mesh each rank's loss is the mean over its own batch and the
reduce-scatter averages (``parallel/zero.py``). The loss returned is this
rank's. Step telemetry (``telemetry=``, ROADMAP.md A12) and optax
transformations (no optax in the port) are not ported; the master-weights
wrapper over a torch optimizer (``precision.master_weights``) is a
standalone optimizer, as the JAX package's, and is refused here.
"""

import contextlib
from typing import Any, NamedTuple

import torch

from horovod_tpu_torch.parallel import fusion, precision
from horovod_tpu_torch.parallel._tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from horovod_tpu_torch.parallel.zero import check_blocks, make_zero_apply


class TrainStep(NamedTuple):
    init: Any   # init(params) -> carry
    step: Any   # step(carry, batch) -> (loss, carry)


def _split_microbatches(batch, n):
    """Split every entry of the dict ``batch`` into ``n`` equal chunks
    along the leading (batch) axis (views, no copies)."""
    if not batch:
        raise ValueError("empty batch")
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch size {b} must divide into "
                         f"{n} microbatches")
    mb = b // n
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(n)]


def _value_and_grad(loss_fn, params, batch, n):
    """(loss / n, grads of it w.r.t. every leaf of ``params``)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(live, batch)
        if n != 1:
            loss = loss / n
        grads = torch.autograd.grad(loss, tree_leaves(live),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def _accumulate(loss_fn, params, mbs, n, grad_call):
    """The plain gradient calls of microbatches ``mbs``: the first one's
    gradients become the accumulator, the others add into it."""
    with grad_call():
        loss, grads = _value_and_grad(loss_fn, params, mbs[0], n)
        for mb in mbs[1:]:
            mb_loss, mb_grads = _value_and_grad(loss_fn, params, mb, n)
            loss = loss + mb_loss
            for acc, g in zip(tree_leaves(grads), tree_leaves(mb_grads)):
                acc.add_(g)
    return loss, grads


def _fused_zero_step(loss_fn, zero_apply, n, grad_call):
    """The fused ZeRO-1 step: microbatches ``0..n-2`` run the plain
    gradient calls; the last one's backward starts each bucket's
    reduce-scatter from a hook; then, bucket by bucket in the order they
    completed, the shard update and an async allgather, all drained
    before the step returns."""

    def step(carry, batch):
        params, opt = carry
        program = zero_apply.resolve()
        check_blocks(opt, program.layout.n_shards, program.axis.rank)
        layout = program.layout
        mbs = _split_microbatches(batch, n) if n > 1 else [batch]
        loss, acc = None, None
        if n > 1:
            loss, acc = _accumulate(loss_fn, params, mbs[:-1], n, grad_call)
            acc = tree_leaves(acc)
        scattered = {}

        def on_ready(i, leaves):
            flat = layout.pack_bucket(leaves, i)
            scattered[i] = (flat, *program.reduce_scatter(i, flat))

        with grad_call():
            # Only the scattered buckets keep the gradients: each is freed
            # once its reduce-scatter is done.
            last = fusion.value_and_grad_bucketed(
                loss_fn, params, mbs[-1], n, layout, on_ready, acc)[0]
        del acc
        loss = last if loss is None else loss + last
        p_leaves = tree_leaves(params)
        count = opt.count + 1
        gathers = []
        with torch.no_grad():
            for i in list(scattered):
                flat, shard, work = scattered.pop(i)
                if work is not None:
                    work.wait()
                del flat
                gathers.append(program.all_gather(
                    i, program.update(i, shard, p_leaves, opt, count),
                    p_leaves))
                del shard
            for finish in gathers:
                finish()
        return loss, (params, opt._replace(count=count))

    return step


def make_split_train_step(loss_fn, optimizer, *, microbatches=1,
                          telemetry=None, zero=None):
    """Build the split step for ``loss_fn(params, batch) -> scalar``.

    ``optimizer`` is a fused optimizer from ``parallel.precision``
    (``fused_adam`` or ``fused_master_adam``: ``init``/``apply``). For
    the master variant the carry's params are the compute-dtype cast
    built by ``init``; the f32 master lives in the optimizer state.
    ``zero`` (a ``parallel.zero.ZeroConfig``) shards that state over the
    zero axis: the carry's state is then this rank's block
    (``ZeroAdamState`` / ``ZeroMasterAdamState``).

    Returns ``TrainStep(init, step)`` with ``init(params) -> carry`` and
    ``step(carry, batch) -> (loss, carry)``; ``batch`` is a dict of
    tensors on the params' device (this rank's share of the batch under
    ``zero``), split along its leading axis into ``microbatches``
    gradient calls.
    """
    if telemetry is not None:
        raise NotImplementedError(
            "telemetry= (StepTimer) is not ported yet (ROADMAP.md A12)")
    if isinstance(optimizer, precision.MasterWeights):
        raise TypeError(
            "master_weights is a standalone optimizer, as the JAX "
            "package's: the split step takes a fused one "
            "(parallel.precision.fused_master_adam is its master recipe)")
    if not hasattr(optimizer, "apply"):
        raise TypeError(
            f"{type(optimizer).__name__} has no .apply: the port's split "
            "step takes a fused optimizer (parallel.precision.fused_adam "
            "or fused_master_adam); optax transformations are not ported")
    n = int(microbatches)
    if n < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    grad_call = contextlib.nullcontext
    if zero is not None:
        zero_apply, init = make_zero_apply(optimizer, zero)
        if zero.mesh is not None:
            deferred = [a for a in (zero.axis, zero.inter_axis) if a]

            def grad_call():
                return zero.mesh.defer_grad_sum(*deferred)
        if fusion.jit_fusion_enabled():
            return TrainStep(init=init, step=_fused_zero_step(
                loss_fn, zero_apply, n, grad_call))

        def apply(params, grads, opt):
            return zero_apply(grads, params, opt)
    else:
        apply = optimizer.apply

        def init(params):
            opt = optimizer.init(params)
            if hasattr(optimizer, "compute_params"):
                params = optimizer.compute_params(opt)
            return (params, opt)

    def step(carry, batch):
        params, opt = carry
        mbs = _split_microbatches(batch, n) if n > 1 else [batch]
        loss, grads = _accumulate(loss_fn, params, mbs, n, grad_call)
        params, opt = apply(params, grads, opt)
        return loss, (params, opt)

    return TrainStep(init=init, step=step)
