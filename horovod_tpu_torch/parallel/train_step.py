"""The split train step: gradient calls per microbatch, then one fused
optimizer apply.

Counterpart of horovod_tpu/parallel/train_step.py's non-ZeRO path of
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
and never moves them. ZeRO-1 (``zero=``, ROADMAP.md A9), step telemetry
(``telemetry=``, A12) and optax transformations (no optax in the port)
are not ported.
"""

from typing import Any, NamedTuple

import torch

from horovod_tpu_torch.parallel._tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


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


def make_split_train_step(loss_fn, optimizer, *, microbatches=1,
                          telemetry=None, zero=None):
    """Build the split step for ``loss_fn(params, batch) -> scalar``.

    ``optimizer`` is a fused optimizer from ``parallel.precision``
    (``fused_adam`` or ``fused_master_adam``: ``init``/``apply``). For
    the master variant the carry's params are the compute-dtype cast
    built by ``init``; the f32 master lives in the optimizer state.

    Returns ``TrainStep(init, step)`` with ``init(params) -> carry`` and
    ``step(carry, batch) -> (loss, carry)``; ``batch`` is a dict of
    tensors on the params' device, split along its leading axis into
    ``microbatches`` gradient calls.
    """
    if zero is not None:
        raise NotImplementedError(
            "zero= (the ZeRO-1 sharded apply) is not ported yet "
            "(ROADMAP.md A9)")
    if telemetry is not None:
        raise NotImplementedError(
            "telemetry= (StepTimer) is not ported yet (ROADMAP.md A12)")
    if not hasattr(optimizer, "apply"):
        raise TypeError(
            f"{type(optimizer).__name__} has no .apply: the port's split "
            "step takes a fused optimizer (parallel.precision.fused_adam "
            "or fused_master_adam); optax transformations are not ported")
    n = int(microbatches)
    if n < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def step(carry, batch):
        params, opt = carry
        mbs = _split_microbatches(batch, n) if n > 1 else [batch]
        loss, grads = _value_and_grad(loss_fn, params, mbs[0], n)
        for mb in mbs[1:]:
            mb_loss, mb_grads = _value_and_grad(loss_fn, params, mb, n)
            loss = loss + mb_loss
            for acc, g in zip(tree_leaves(grads), tree_leaves(mb_grads)):
                acc.add_(g)
        params, opt = optimizer.apply(params, grads, opt)
        return loss, (params, opt)

    def init(params):
        opt = optimizer.init(params)
        if hasattr(optimizer, "compute_params"):
            params = optimizer.compute_params(opt)
        return (params, opt)

    return TrainStep(init=init, step=step)
