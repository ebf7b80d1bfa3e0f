"""Fused Adam optimizers.

Counterpart of the fused half of horovod_tpu/parallel/precision.py:
``fused_adam`` (moments in the parameter dtype) and
``fused_master_adam`` (f32 master weights and moments, the compute cast
written in the same pass). The JAX package leaves each leaf's update to
one XLA fusion; here each leaf is one call of ``ops.adam.adam_update``:
one pass of the Hopper kernel ``csrc/adam.cu`` on the card, the plain
PyTorch chain ``_adam_leaf`` on the CPU, the same bits. Every update is
computed in f32 and only the STORED moments and params are rounded to
their dtype — the recipe ``fused_adam``'s JAX docstring pins for bf16
params.

Both ``apply`` functions run under ``torch.no_grad()`` and update the
params, moments and master IN PLACE, returning the same tensors: the
port's counterpart of JAX's buffer donation (one params tree and one
state tree live per step). A caller that needs the old values keeps a
copy. ``master_weights`` (which wraps an optax transformation) is not
ported: the port has no optax (ROADMAP.md A3).

The trees are nested dicts of tensors (``_tree``); ``count`` is an int32
0-d tensor on the params' device, so an apply never waits on the host.
"""

from typing import Any, NamedTuple

import torch

from horovod_tpu_torch.ops.adam import adam_update
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map


class FusedAdamState(NamedTuple):
    count: Any    # int32 0-d tensor: the step counter
    mu: Any       # first-moment tree, in the params' dtype
    nu: Any       # second-moment tree, in the params' dtype


class FusedOptimizer(NamedTuple):
    """The fused-optimizer protocol of ``make_split_train_step``:
    ``apply(params, grads, state) -> (new_params, new_state)`` writes
    the updated params directly. ``hyper`` carries the constructor's
    hyperparameters, as in the JAX package."""
    init: Any
    apply: Any
    hyper: Any = None


def _bias_corrections(count, b1, b2):
    cf = count.float()
    return 1.0 - b1 ** cf, 1.0 - b2 ** cf


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def fused_adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with moments in the parameter dtype, all update arithmetic in
    f32 (for f32 params the same optimizer as ``optax.adam``; for bf16
    params it rounds only what it stores). Each leaf's update is one
    ``adam_update``: one kernel launch on the card (``csrc/adam.cu``),
    the plain ``_adam_leaf`` chain on the CPU."""

    def init(params):
        leaf = tree_leaves(params)[0]
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=_zeros(params), nu=_zeros(params))

    @torch.no_grad()
    def apply(params, grads, state):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.mu),
                                tree_leaves(state.nu)):
            adam_update(p, g, mu, nu, learning_rate, b1, b2, eps, bc1, bc2)
        return params, FusedAdamState(count=count, mu=state.mu,
                                      nu=state.nu)

    return FusedOptimizer(init=init, apply=apply,
                          hyper={"kind": "adam",
                                 "learning_rate": learning_rate,
                                 "b1": b1, "b2": b2, "eps": eps})


class FusedMasterState(NamedTuple):
    master: Any   # master-dtype (f32) parameter tree
    count: Any
    mu: Any       # f32 moments
    nu: Any


class FusedMasterOptimizer(NamedTuple):
    """The fused protocol plus ``compute_params(state)``: the step
    carry holds the COMPUTE-dtype params, built from the master."""
    init: Any
    apply: Any
    compute_params: Any
    hyper: Any = None


def fused_master_adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                      compute_dtype=torch.bfloat16,
                      master_dtype=torch.float32):
    """Adam on an f32 master, with the master's compute cast written in
    the same pass. ``apply(params, grads, state)`` takes the previous
    compute cast as ``params`` (its storage receives the new cast; its
    values do not enter the math) and returns ``(params, state)``."""

    def init(params):
        # A copy even when params are already master_dtype: the apply
        # updates the master in place and must not write the caller's
        # params.
        master = tree_map(lambda p: p.to(master_dtype, copy=True), params)
        leaf = tree_leaves(master)[0]
        return FusedMasterState(
            master=master,
            count=torch.zeros((), dtype=torch.int32, device=leaf.device),
            mu=_zeros(master), nu=_zeros(master))

    def compute_params(state):
        return tree_map(lambda m: m.to(compute_dtype, copy=True),
                        state.master)

    @torch.no_grad()
    def apply(params, grads, state):
        count = state.count + 1
        bc1, bc2 = _bias_corrections(count, b1, b2)
        for p, g, m, mu, nu in zip(
                tree_leaves(params), tree_leaves(grads),
                tree_leaves(state.master), tree_leaves(state.mu),
                tree_leaves(state.nu)):
            adam_update(m, g, mu, nu, learning_rate, b1, b2, eps, bc1, bc2,
                        cast=p)
        return params, FusedMasterState(master=state.master, count=count,
                                        mu=state.mu, nu=state.nu)

    return FusedMasterOptimizer(init=init, apply=apply,
                                compute_params=compute_params,
                                hyper={"kind": "master_adam",
                                       "learning_rate": learning_rate,
                                       "b1": b1, "b2": b2, "eps": eps,
                                       "compute_dtype": compute_dtype,
                                       "master_dtype": master_dtype})
