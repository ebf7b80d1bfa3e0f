"""JAX parameter trees and fused-optimizer states -> the port's, and a
ZeRO-1 state both ways.

Under a mesh that shards the params, ``from_jax_params`` then
``parallel.sharding.shard_params(params, mesh, llama_partition_rules())``
gives each rank its blocks (what JAX's device of the same index holds),
and ``gather_params`` joins the ranks' blocks back into the global tree.
A ZeRO-1 state of such blocks (``ZeroBlocks``) is laid out over each
rank's blocks, where JAX's is over the global leaves: the converters
move it through the leaves, each rank's block of each.

The tree arrives as numpy arrays (``np.asarray`` of each JAX leaf) or
anything ``np.asarray`` takes; this module imports neither jax nor
ml_dtypes. Trap: a JAX bfloat16 array converts to numpy with dtype
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses. Such a leaf
is recognised by its dtype name and moved bit for bit through a uint16
view.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.parallel.mesh import Mesh
from horovod_tpu_torch.parallel.precision import (
    FusedAdamState,
    FusedMasterState,
)
from horovod_tpu_torch.parallel.sharding import leaf_block
from horovod_tpu_torch.parallel.zero import (
    DEFAULT_BUCKET_BYTES,
    LeafSpec,
    ZeroAdamState,
    ZeroMasterAdamState,
    zero_bucket_layout,
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


class ZeroBlocks(NamedTuple):
    """A ZeRO-1 state over sharded blocks: ``leaves`` the global leaves
    the layouts are built from (anything with ``shape`` and a torch
    ``dtype``, tree order: what ``parallel.zero.layout_leaves`` gives for
    the global tree), ``specs`` their specs (tree order), ``shape`` the
    mesh's axis sizes (``dict(mesh.shape)``), ``axis`` the zero axis,
    ``bucket_bytes`` the config's, ``jax_leaves`` the leaves JAX's
    layout was built from where their dtypes differ (JAX's master
    variant lays out the f32 params it was initialised from). A rank's
    layout is built over its blocks of ``leaves``."""
    leaves: Any
    specs: Any
    shape: Any
    axis: str = "data"
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    jax_leaves: Any = None

    def mesh(self, rank):
        """Rank ``rank``'s place in the mesh (no groups)."""
        return Mesh(self.shape, rank, torch.device("cpu"), {}, None)

    def layouts(self, rank):
        """(JAX's global layout, rank ``rank``'s layout of its blocks)."""
        n = self.shape[self.axis]
        mesh = self.mesh(rank)
        local = [LeafSpec(tuple(leaf_block(torch.empty(l.shape, device="meta"),
                                           s, mesh).shape), l.dtype)
                 for l, s in zip(self.leaves, self.specs)]
        return (zero_bucket_layout(self.jax_leaves or self.leaves, n,
                                   self.bucket_bytes),
                zero_bucket_layout(local, n, self.bucket_bytes))


def _is_buckets(v):
    return isinstance(v, (tuple, list))


def from_jax_zero_state(state, rank, size, device=None, blocks=None):
    """Rank ``rank``'s block of a JAX ``ZeroAdamState`` /
    ``ZeroMasterAdamState`` (the global view, every leaf split ``size``
    ways on its leading dim; numpy leaves): the port's state of the same
    name, ``count`` as ``(1,)``, each bucket's shard bf16 bit for bit.
    With ``blocks`` (:class:`ZeroBlocks`; ``size`` its zero axis's) the
    params are sharded: each of JAX's buckets is unpacked into the global
    leaves, this rank's block of each taken, and its shard of its own
    layout's buckets packed from them."""
    dev = resolve_device(device)
    cls = _zero_class(state._fields)
    if blocks is None:
        def conv(v):
            if _is_buckets(v):
                return tuple(_leaf_to_torch(_block(a, rank, size), dev)
                             for a in v)
            return _leaf_to_torch(_block(v, rank, size), dev)

        return cls(**{k: conv(v) for k, v in zip(state._fields, state)})
    if blocks.shape[blocks.axis] != size:
        raise ValueError(f"size {size} but the {blocks.axis!r} axis has "
                         f"{blocks.shape[blocks.axis]}")
    mesh = blocks.mesh(rank)
    zrank = mesh.coords[blocks.axis]
    jax_layout, layout = blocks.layouts(rank)

    def conv(v):
        if not _is_buckets(v):
            return _leaf_to_torch(_block(v, zrank, size), dev)
        flats = [_leaf_to_torch(a, "cpu") for a in v]
        mine = [leaf_block(x, s, mesh) for x, s in
                zip(jax_layout.unpack(flats), blocks.specs)]
        return tuple(layout.pack_shard(mine, j, zrank, flats[0].dtype)
                     .clone().to(dev) for j in range(len(layout.buckets)))

    return cls(**{k: conv(v) for k, v in zip(state._fields, state)})


def _leaf_to_numpy(t, bfloat16):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bfloat16 is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bfloat16)
    return t.numpy()


def to_jax_zero_state(states, bfloat16=None, blocks=None):
    """The JAX global view of the ``N`` ranks' ZeRO-1 states (``states``
    in rank order): the port's state class with numpy leaves, each the
    ranks' blocks joined on the leading dim, for JAX's class of the same
    name (``ZeroAdamState(*state)``). bf16 leaves come back viewed as
    ``bfloat16`` (the numpy dtype JAX uses, e.g. ``ml_dtypes.bfloat16``)
    or, without it, as f32 (exact). With ``blocks`` (:class:`ZeroBlocks`,
    ``states`` every rank of the mesh's) each rank's buckets are unpacked
    into its blocks, the blocks joined into the global leaves and those
    packed into JAX's buckets (padding 0)."""
    cls = _zero_class(states[0]._fields)
    if blocks is None:
        def join(parts):
            if _is_buckets(parts[0]):
                return tuple(join([p[i] for p in parts])
                             for i in range(len(parts[0])))
            return np.concatenate([_leaf_to_numpy(p, bfloat16)
                                   for p in parts])

        return cls(**{k: join([getattr(s, k) for s in states])
                      for k in cls._fields})
    # The ranks that hold the same blocks, by their coordinates off the
    # zero axis, each line in zero-axis order.
    lines = {}
    for r in range(len(states)):
        coords = blocks.mesh(r).coords
        key = tuple(v for a, v in coords.items() if a != blocks.axis)
        lines.setdefault(key, []).append((coords[blocks.axis], r))
    lines = [[r for _, r in sorted(line)] for line in lines.values()]
    jax_layout, _ = blocks.layouts(0)

    def join(field):
        first = getattr(states[0], field)
        if not _is_buckets(first):
            return np.concatenate([_leaf_to_numpy(getattr(states[r], field),
                                                  bfloat16)
                                   for r in lines[0]])
        dtype = first[0].dtype
        full = [torch.zeros(tuple(l.shape), dtype=dtype)
                for l in blocks.leaves]
        for line in lines:
            mesh = blocks.mesh(line[0])
            _, layout = blocks.layouts(line[0])
            buckets = [torch.cat([getattr(states[r], field)[j].detach().cpu()
                                  for r in line])
                       for j in range(len(layout.buckets))]
            for x, s, block in zip(full, blocks.specs,
                                   layout.unpack(buckets)):
                leaf_block(x, s, mesh).copy_(block)
        return tuple(_leaf_to_numpy(f, bfloat16)
                     for f in jax_layout.pack(full))

    return cls(**{k: join(k) for k in cls._fields})


def resize_zero_states(states, leaves, size, bucket_bytes=DEFAULT_BUCKET_BYTES):
    """The blocks of a ZeRO state over ``size`` ranks from its blocks over
    ``len(states)`` (``states`` by shard rank: the split step's
    ``ZeroAdamState``/``ZeroMasterAdamState`` or the eager lane's dict),
    through the leaves: each field's buckets joined, unpacked into the
    global leaves by the old layout of ``leaves`` (what the layout was
    built from: ``parallel.zero.layout_leaves``' or the gradients'
    shapes and dtypes) and packed into each new rank's shard (padding
    0). ``count`` is the first state's. The oracle for re-laying a carry
    out (``torch/elastic.py TreeState``); on the CPU."""
    from horovod_tpu_torch.parallel.zero import SHARD_FIELDS

    old = zero_bucket_layout(leaves, len(states), bucket_bytes)
    new = zero_bucket_layout(leaves, size, bucket_bytes)
    first = states[0]
    get = (lambda s, f: s[f]) if isinstance(first, dict) else getattr
    fields = [f for f in SHARD_FIELDS
              if (f in first if isinstance(first, dict)
                  else f in first._fields)]
    out = [{} for _ in range(size)]
    for f in fields:
        full = [torch.cat([get(s, f)[i].detach().cpu() for s in states])
                for i in range(len(old.buckets))]
        glob = old.unpack(full)
        for r in range(size):
            out[r][f] = [new.pack_shard(glob, i, r, full[i].dtype).clone()
                         for i in range(len(new.buckets))]
    count = get(first, "count").detach().cpu().clone()
    if isinstance(first, dict):
        return [dict(o, count=count.clone()) for o in out]
    return [type(first)(count=count.clone(),
                        **{f: tuple(v) for f, v in o.items()}) for o in out]
