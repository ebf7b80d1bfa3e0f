"""Mixed precision: the f32 master-weights wrapper and the fused Adam
optimizers.

Counterpart of horovod_tpu/parallel/precision.py: ``master_weights``
(an f32 master copy under any torch optimizer, the forward and backward
on its compute cast), ``fused_adam`` (moments in the parameter dtype)
and ``fused_master_adam`` (f32 master weights and moments, the compute
cast written in the same pass). The JAX package leaves each leaf's update to
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
copy.

``master_weights`` wraps a torch optimizer where JAX's wraps an optax
transformation: ``make_optimizer`` builds it over the master leaves
(``lambda ps: torch.optim.Adam(ps, lr=1e-2)``), and ``apply`` sets the
gradients, cast to the master dtype, as the leaves' ``.grad`` and steps
it, in place. As in the JAX package it is a standalone optimizer, not a
fused one: ``make_split_train_step`` refuses it (JAX's would send it
down the fused path, whose ``apply`` signature it does not have), and
``fused_master_adam`` is the split step's master recipe.

The trees are nested dicts of tensors (``_tree``); ``count`` is an int32
0-d tensor on the params' device, so an apply never waits on the host.
"""

from typing import Any, NamedTuple

import torch

from horovod_tpu_torch.ops.adam import adam_update
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map


class MasterWeightsState(NamedTuple):
    master: Any   # master-dtype (f32) parameter tree
    inner: Any    # the wrapped torch optimizer, over the master leaves


class MasterWeights(NamedTuple):
    init: Any
    compute_params: Any
    apply: Any


def master_weights(make_optimizer, compute_dtype=torch.bfloat16,
                   master_dtype=torch.float32):
    """Wrap a torch optimizer with an f32 master-parameter loop:
    ``init(params)`` copies the params to ``master_dtype`` and builds
    ``make_optimizer(master leaves)``; ``compute_params(state)`` is a
    fresh ``compute_dtype`` cast of the master, for the forward and
    backward; ``apply(state, grads)`` steps the optimizer on the master
    with the gradients cast to ``master_dtype`` and returns the state."""

    def init(params):
        # A copy even when params are already master_dtype: the
        # optimizer updates the master in place.
        master = tree_map(lambda p: p.detach().to(master_dtype, copy=True),
                          params)
        return MasterWeightsState(master=master,
                                  inner=make_optimizer(tree_leaves(master)))

    def compute_params(state):
        return tree_map(lambda m: m.to(compute_dtype, copy=True),
                        state.master)

    def apply(state, grads):
        leaves = tree_leaves(state.master)
        for m, g in zip(leaves, tree_leaves(grads)):
            m.grad = g.detach().to(master_dtype)
        state.inner.step()
        for m in leaves:
            m.grad = None
        return state

    return MasterWeights(init=init, compute_params=compute_params,
                         apply=apply)


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
