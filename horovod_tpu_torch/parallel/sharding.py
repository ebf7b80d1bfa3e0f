"""Sharding rules: map a parameter tree onto the mesh, rank by rank.

Counterpart of horovod_tpu/parallel/sharding.py. JAX attaches a
``NamedSharding`` to each leaf by the first regex rule that matches its
'/'-joined path, and GSPMD inserts the gathers and sums that the layout
needs. The port runs eagerly, one process a device: :func:`shard_params`
takes the same rules and hands this rank the block of every leaf that
JAX's device of the same index holds (its ``addressable_shards``), and
the model inserts the collectives GSPMD would insert, leaf by leaf
(``models/llama.py``). So ``named_sharding``, ``with_constraint`` and
``apply_sharding`` have no counterpart here: there is no compiler to
hint. :func:`gather_params` is the inverse, for tests and checkpoints.

A spec is :class:`P`, the port's ``PartitionSpec``: one entry a dim
(trailing dims unnamed are replicated), each None, an axis name, or a
tuple of axis names split jointly, the first the major one. An
:class:`Interleaved` entry (the interleaved pipeline's layer axis)
names one axis and hands each rank its chunks in device-major order;
:func:`gather_params` puts them back, so the global tree is always in
canonical order.
"""

import math
import re

import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel._tree import tree_map


class P(tuple):
    """``P(None, "fsdp", ("tensor", "fsdp"))``: a spec entry a dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # Unpickled as P(*entries), not P(entries).
        return tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def entry(self, dim):
        """The axes dim ``dim`` is split over, major first (a tuple)."""
        if dim >= len(self) or self[dim] is None:
            return ()
        e = self[dim]
        return (e,) if isinstance(e, str) else tuple(e)

    def axes(self):
        """Every axis the spec splits over."""
        return tuple(a for d in range(len(self)) for a in self.entry(d))


class Interleaved(str):
    """A spec entry for the interleaved 1F1B schedule's layer axis: the
    dim split over ``axis`` (size S) into ``S * virtual`` chunks, rank
    ``s`` holding chunks ``v * S + s`` for each v, in that order, as one
    block (``parallel.pipeline._chunk_permutation``'s device-major
    order; JAX's engine permutes the stack so inside every step). It is
    the axis name everywhere else."""

    def __new__(cls, axis, virtual):
        entry = super().__new__(cls, axis)
        entry.virtual = virtual
        return entry

    def __getnewargs__(self):
        return str(self), self.virtual

    def __repr__(self):
        return f"Interleaved({str(self)!r}, {self.virtual})"


def _virtual(spec, dim):
    """The chunks a rank holds along ``dim`` (1 unless interleaved)."""
    return getattr(spec[dim], "virtual", 1) if dim < len(spec) else 1


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its '/'-joined path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


def param_specs(params, rules, default=P()):
    """The spec of every leaf: the first of the ``(pattern, P)`` rules
    whose pattern matches (``re.search``) the leaf's '/'-joined path,
    else ``default`` (replicated)."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(path):
        for pat, spec in compiled:
            if pat.search(path):
                return spec
        return default

    return tree_map(spec_for, _paths(params))


def block_index(mesh, axes):
    """(index, count) of this rank's block along a dim split over
    ``axes`` (the first the major one)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i, math.prod(mesh.shape[a] for a in axes)


def block_specs(blocks, rules, shapes, mesh):
    """The spec tree of this rank's ``blocks`` under ``rules``, each
    block's shape checked against its leaf's global shape (``shapes``, a
    tree of tuples): a model under a mesh takes the blocks
    :func:`shard_params` gives it."""
    def check(x, spec, shape):
        want = []
        for dim, n in enumerate(shape):
            _, ways = block_index(mesh, spec.entry(dim))
            if n % ways:
                raise ValueError(f"a {shape} leaf does not split {ways} "
                                 f"ways over {spec.entry(dim)}")
            want.append(n // ways)
        if tuple(x.shape) != tuple(want):
            raise ValueError(
                f"under this mesh a {shape} leaf's block is {tuple(want)}, "
                f"got {tuple(x.shape)}: pass this rank's blocks, "
                "shard_params(params, mesh, <the model's partition rules>)")
        return spec

    return tree_map(check, blocks, param_specs(blocks, rules), shapes)


def leaf_block(x, spec, mesh):
    """This rank's block of the global tensor ``x`` under ``spec``."""
    for dim in range(x.dim()):
        i, n = block_index(mesh, spec.entry(dim))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does "
                             f"not split {n} ways over {spec.entry(dim)}")
        V = _virtual(spec, dim)
        if V > 1:
            if x.shape[dim] % (n * V):
                raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf "
                                 f"does not split into {n * V} chunks")
            lb = x.shape[dim] // (n * V)
            x = torch.cat([x.narrow(dim, (v * n + i) * lb, lb)
                           for v in range(V)], dim)
            continue
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def shard_params(params, mesh, rules, default=P()):
    """This rank's block of every leaf of ``params`` (a fresh tensor, so
    the global tree can be dropped) and the spec tree: ``(blocks,
    specs)``. Rank r's blocks are what JAX's device r holds under
    ``shard_params(params, mesh, rules)`` of the JAX package."""
    specs = param_specs(params, rules, default)
    blocks = tree_map(lambda x, s: leaf_block(x, s, mesh).clone(), params,
                      specs)
    return blocks, specs


def gather_params(blocks, mesh, specs):
    """The global tree back from every rank's blocks (collective: every
    rank calls it and gets the whole tree), an interleaved dim's chunks
    in canonical order."""

    def gather(x, spec):
        with torch.no_grad():
            for dim in range(x.dim()):
                # The minor axis first: its blocks are contiguous within
                # the major axis's block.
                for a in reversed(spec.entry(dim)):
                    group = mesh.axis_group(a)
                    if group is None:
                        continue
                    parts = [torch.empty_like(x)
                             for _ in range(mesh.shape[a])]
                    dist.all_gather(parts, x.contiguous(), group=group)
                    x = torch.cat(parts, dim)
                V = _virtual(spec, dim)
                if V > 1:
                    # [S * V * lb] rank-major -> chunk v * S + s in place.
                    n = mesh.shape[spec[dim]]
                    x = x.unflatten(dim, (n, V, -1)).transpose(
                        dim, dim + 1).flatten(dim, dim + 2)
        return x

    return tree_map(gather, blocks, specs)
