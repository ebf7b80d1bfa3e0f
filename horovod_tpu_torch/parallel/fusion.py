"""Compute/collective fusion of the ZeRO-1 step: each gradient bucket's
reduce-scatter issued from the backward, the moment the bucket is
complete.

Counterpart of horovod_tpu/parallel/fusion.py's knob
(``set_jit_fusion``, ``jit_fusion_enabled``; ``HOROVOD_JIT_FUSION``,
default on) and of what its ``grad_bucket_cuts`` and
``make_fused_zero_programs`` do for a jitted step: JAX traces the
backward, finds where each bucket's last gradient leaf is produced and
reorders the program so each reduce-scatter is emitted there. PyTorch
runs the backward eagerly, so the same schedule comes from autograd
hooks: a hook on every parameter counts the bucket's leaves as their
gradients arrive, and the last one packs the bucket and starts its
reduce-scatter, which then overlaps the rest of the backward. A leaf
that gets no gradient fires no hook: its bucket completes after the
backward, with the zeros ``torch.autograd.grad`` materialises.

The knob changes the schedule, never the numbers: the fused and the
unfused step pack the same gradients into the same buckets and run the
same collectives and the same Adam, so they give the same bits. JAX's
``interleave_collectives`` and ``segment_closed_jaxpr`` reorder and cut
jaxprs; the eager backward has no program to reorder (ROADMAP.md, "Not
queued, and why").
"""

import functools
import os

import torch

from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

_ENV = "HOROVOD_JIT_FUSION"
_override = None  # tri-state: None = follow the env


def set_jit_fusion(enabled):
    """Override ``HOROVOD_JIT_FUSION`` (``hvd.init(jit_fusion=...)`` lands
    here); ``None`` follows the environment again."""
    global _override
    _override = None if enabled is None else bool(enabled)


def jit_fusion_enabled():
    """Whether the fused schedule is on (default: yes;
    ``HOROVOD_JIT_FUSION=0`` turns it off)."""
    if _override is not None:
        return _override
    return os.environ.get(_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no")


def value_and_grad_bucketed(loss_fn, params, batch, n, layout, on_ready,
                            acc=None):
    """``(loss / n, gradient leaves)`` of ``loss_fn(params, batch)``,
    calling ``on_ready(i, leaves)`` once for every bucket ``i`` of
    ``layout`` the moment its last gradient leaf is produced (``leaves``:
    the gradient leaves in tree order, filled in so far). With ``acc``
    (the accumulator's leaves, the earlier microbatches' gradients) each
    gradient is first added into its accumulator leaf, and the leaves
    handed on are the accumulator's. Buckets whose leaves did not all
    get a gradient are handed on, in bucket order, after the
    backward."""
    bucket_of = {}
    for i, b in enumerate(layout.buckets):
        for j in b.indices:
            bucket_of[j] = i
    left = [len(b.indices) for b in layout.buckets]
    got = [None] * len(bucket_of)

    def arrive(j, g):
        with torch.no_grad():
            if acc is not None:
                acc[j].add_(g)
                g = acc[j]
            got[j] = g
            i = bucket_of[j]
            left[i] -= 1
            if left[i] == 0:
                on_ready(i, got)

    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        hooks = [leaf.register_hook(functools.partial(arrive, j))
                 for j, leaf in enumerate(leaves)]
        try:
            loss = loss_fn(live, batch)
            if n != 1:
                loss = loss / n
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for h in hooks:
                h.remove()
    with torch.no_grad():
        for j, g in enumerate(grads):
            if got[j] is None:
                if acc is not None:
                    acc[j].add_(g)
                    g = acc[j]
                got[j] = g
    for i, b in enumerate(layout.buckets):
        if left[i]:
            left[i] = 0
            on_ready(i, got)
    return loss.detach(), got
