"""JAX parameter trees and fused-optimizer states -> the port's.

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


def _leaf_to_torch(a, device):
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree, device=None):
    """Convert a (nested dict) JAX parameter tree leaf for leaf, keeping
    keys, shapes and dtypes; leaves land on ``device`` (default cuda)."""
    return _tree_to_torch(tree, resolve_device(device))


def _tree_to_torch(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
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
