"""JAX parameter trees and fused-optimizer states -> the port's, and a
ZeRO-1 state both ways.

Under a mesh that shards the params, ``from_jax_params`` then
``parallel.sharding.shard_params(params, mesh, llama_partition_rules())``
gives each rank its blocks (what JAX's device of the same index holds),
and ``gather_params`` joins the ranks' blocks back into the global tree.

The tree arrives as numpy arrays (``np.asarray`` of each JAX leaf) or
anything ``np.asarray`` takes; this module imports neither jax nor
ml_dtypes. Trap: a JAX bfloat16 array converts to numpy with dtype
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Such a leaf
is recognised by its dtype name and moved bit for bit through a uint16
view.
"""

import numpy as np
import torch

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.parallel.precision import (
    FusedAdamState,
    FusedMasterState,
)
from horovod_tpu_torch.parallel.zero import (
    ZeroAdamState,
    ZeroMasterAdamState,
)


def _leaf_to_torch(a, device):
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree, device=None):
    """Convert a JAX parameter tree (nested dicts and lists, e.g. the
    ResNet's params or its batch-norm state) leaf for leaf, keeping keys,
    list order, shapes and dtypes; leaves land on ``device`` (default
    cuda)."""
    return _tree_to_torch(tree, resolve_device(device))


def _tree_to_torch(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to_torch(v, dev) for v in tree]
    return _leaf_to_torch(tree, dev)


def from_jax_opt_state(state, device=None):
    """Convert a JAX ``FusedAdamState`` (count, mu, nu) or
    ``FusedMasterState`` (master, count, mu, nu) — the namedtuple with
    numpy leaves, e.g. ``jax.tree.map(np.asarray, state)`` — into the
    port's state of the same name, leaf for leaf and bf16 bit for bit,
    so a run started in JAX continues in the port."""
    dev = resolve_device(device)
    fields = {k: _tree_to_torch(v, dev)
              for k, v in zip(state._fields, state)}
    if set(fields) == set(FusedMasterState._fields):
        return FusedMasterState(**fields)
    if set(fields) == set(FusedAdamState._fields):
        return FusedAdamState(**fields)
    raise ValueError(f"not a fused Adam state: fields {state._fields}")


def _zero_class(fields):
    for cls in (ZeroMasterAdamState, ZeroAdamState):
        if tuple(fields) == cls._fields:
            return cls
    raise ValueError(f"not a ZeRO-1 Adam state: fields {tuple(fields)}")


def _block(a, rank, size):
    a = np.asarray(a)
    if a.shape[0] % size:
        raise ValueError(f"a leaf of {a.shape[0]} rows does not split "
                         f"{size} ways")
    step = a.shape[0] // size
    return a[rank * step:(rank + 1) * step]


def from_jax_zero_state(state, rank, size, device=None):
    """Rank ``rank``'s block of a JAX ``ZeroAdamState`` /
    ``ZeroMasterAdamState`` (the global view, every leaf split ``size``
    ways on its leading dim; numpy leaves): the port's state of the same
    name, ``count`` as ``(1,)``, each bucket's shard bf16 bit for bit."""
    dev = resolve_device(device)
    cls = _zero_class(state._fields)

    def conv(v):
        if isinstance(v, (tuple, list)):
            return tuple(_leaf_to_torch(_block(a, rank, size), dev)
                         for a in v)
        return _leaf_to_torch(_block(v, rank, size), dev)

    return cls(**{k: conv(v) for k, v in zip(state._fields, state)})


def _leaf_to_numpy(t, bfloat16):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bfloat16 is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bfloat16)
    return t.numpy()


def to_jax_zero_state(states, bfloat16=None):
    """The JAX global view of the ``N`` ranks' ZeRO-1 states (``states``
    in rank order): the port's state class with numpy leaves, each the
    ranks' blocks joined on the leading dim, for JAX's class of the same
    name (``ZeroAdamState(*state)``). bf16 leaves come back viewed as
    ``bfloat16`` (the numpy dtype JAX uses, e.g. ``ml_dtypes.bfloat16``)
    or, without it, as f32 (exact)."""
    cls = _zero_class(states[0]._fields)

    def join(parts):
        if isinstance(parts[0], (tuple, list)):
            return tuple(join([p[i] for p in parts])
                         for i in range(len(parts[0])))
        return np.concatenate([_leaf_to_numpy(p, bfloat16) for p in parts])

    return cls(**{k: join([getattr(s, k) for s in states])
                  for k in cls._fields})
