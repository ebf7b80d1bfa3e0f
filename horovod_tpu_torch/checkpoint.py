"""Checkpoints: one-shot ``save``/``restore`` (each rank its own blocks
under a mesh), the tree codec, and step-numbered checkpoints with async
saves.

The port's own copy of ``horovod_tpu/checkpoint.py``, which builds on
orbax. One-shot::

    from horovod_tpu_torch import checkpoint as ckpt
    ckpt.save(path, {"params": params, "opt": opt_state})
    state = ckpt.restore(path, target=like_state)

Step-managed::

    mgr = ckpt.CheckpointManager(dir, max_to_keep=3)
    mgr.save(step, state)          # async: returns once state is on the host
    state = mgr.restore(target=like_state)   # latest step
    mgr.wait(); mgr.close()

A tree is nested dicts, lists and tuples (NamedTuples kept) whose leaves
are tensors, numpy arrays, numbers or any picklable object:
:func:`encode_pytree` turns a leaf that is not numeric (a string, a
dict of settings...) into a pickled ``uint8`` tensor marked for
:func:`decode_pytree`. Tensors keep their dtype, bf16 included: no path
goes through numpy.

Rank policy, as the reference's: only rank 0 of a Horovod job writes
(replicas hold the same state), decided at each call since an elastic
reset renumbers the ranks; outside a job this process writes. Under a
mesh (``save(..., mesh=, specs=)``) every rank writes its own blocks of
each sharded leaf, as orbax has every process write its shards: a leaf
is stored as boxes of its global shape, each written once, by the rank
with coordinate 0 along every axis its spec leaves replicated.
:func:`restore` reads, for each rank, the rows its target needs, onto
any layout: the whole leaf in one process, the same blocks, or other
blocks (``restore(..., mesh=, specs=)``). The boxes come from the
port's block math (``parallel/sharding.py block_index``, what
``shard_params`` hands each rank, an interleaved pipeline's chunks
included), not from ``torch.distributed.checkpoint``: the port's blocks
are plain local tensors with a spec, not DTensors, and the reshard
planner's row layouts (``parallel/reshard.py``) describe axis 0 only,
where a ``P("fsdp", "tensor")`` leaf is split along two dims. Block
files are read memory-mapped, so a rank touches only the bytes of its
rows, and a CUDA target is filled box by box, never staged through a
second whole copy on the card.

``CheckpointManager`` writes one ``torch.save`` file a step,
``<directory>/<step>.pt``, under a temporary name and renamed, so a
reader never sees half a file. With ``async_save`` (the default, as
orbax's) ``save`` copies every tensor to host memory (pinned for a
card's tensors), waits for the copies, and writes on a thread: the
caller may update the state in place at once (the port's optimizers
do, ``parallel/precision.py``) and the file holds the state as it was.
The next ``save`` or ``wait`` joins the write in flight; a save's
pinned buffers take the next save's snapshot once its write has
ended, so only the first save pins memory. A rank's own
block of a sharded state (a ZeRO carry's, for the elastic states) is a
file of its own, ``<step>.<key>.pt``, written at once
(:meth:`CheckpointManager.save_block`).
"""

import itertools
import os
import pickle
import re
import shutil
import copy
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from horovod_tpu_torch.common import basics

_STEP = re.compile(r"(\d+)\.pt\Z")
_PICKLE_KEY = "__hvd_pickle__"
_TREE = "tree.pt"
_BLOCKS = re.compile(r"blocks\.(\d+)\.pt\Z")


def _i_write():
    """Whether this rank writes a replicated state (module docstring)."""
    return not basics.is_initialized() or basics.rank() == 0


# ---- trees -------------------------------------------------------------

def _map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``rest`` (None where a rest tree has no such entry). Dicts (and
    OrderedDicts), lists, tuples and NamedTuples are nodes; any other
    object, a tuple subclass such as a spec or a ``torch.Size``
    included, is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)

    def sub(r, k):
        if isinstance(r, dict):
            return r.get(k)
        if isinstance(r, (list, tuple)) and isinstance(k, int) and \
                k < len(r):
            return r[k]
        return None

    kind = type(tree)
    if kind in (dict, OrderedDict):
        return kind((k, _map(fn, v, *(sub(r, k) for r in rest),
                             is_leaf=is_leaf)) for k, v in tree.items())
    if kind in (list, tuple) or (isinstance(tree, tuple) and
                                 hasattr(tree, "_fields")):
        return _rebuild(tree, [_map(fn, v, *(sub(r, i) for r in rest),
                                    is_leaf=is_leaf)
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def _numeric(x):
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, (bool, int, float, complex)):
        return True
    if isinstance(x, (np.ndarray, np.generic)):
        return x.dtype.kind in "biufc?"
    return False


def _is_marker(x):
    return isinstance(x, dict) and set(x) == {_PICKLE_KEY}


def encode_pytree(tree):
    """Replace the leaves that are not numeric (strings, arbitrary
    objects) with pickled ``uint8`` tensors, marked for
    :func:`decode_pytree`. Tensors, numpy arrays of numbers, Python
    numbers and None stay as they are."""

    def enc(x):
        if x is None or _numeric(x):  # None: an empty subtree, as in JAX
            return x
        return {_PICKLE_KEY: torch.frombuffer(bytearray(pickle.dumps(x)),
                                              dtype=torch.uint8)}

    return _map(enc, tree)


def decode_pytree(tree):
    """Inverse of :func:`encode_pytree`."""

    def dec(x):
        if _is_marker(x):
            return pickle.loads(x[_PICKLE_KEY].contiguous().numpy()
                                .tobytes())
        return x

    return _map(dec, tree, is_leaf=_is_marker)


# ---- one-shot save and restore -----------------------------------------

class _Leaf:
    """A tensor leaf's place in the saved tree: its key in the block
    files, global shape and dtype."""

    def __init__(self, key, shape, dtype):
        self.key, self.shape, self.dtype = key, tuple(shape), dtype


def _boxes(shape, spec, mesh):
    """This rank's block of a ``shape`` leaf under ``spec`` as boxes:
    ``(global start, local start, size)`` tuples a dim. One box, or V a
    dim the interleaved pipeline splits into V chunks."""
    from horovod_tpu_torch.parallel.sharding import _virtual, block_index

    dims = []
    for d, n in enumerate(shape):
        i, ways = block_index(mesh, spec.entry(d)) if spec else (0, 1)
        V = _virtual(spec, d) if spec else 1
        if n % (ways * V):
            raise ValueError(f"dim {d} of a {tuple(shape)} leaf does not "
                             f"split into {ways * V} blocks")
        lb = n // (ways * V)
        dims.append([((v * ways + i) * lb, v * lb, lb) for v in range(V)])
    if not dims:
        return _whole(shape)
    return [tuple(zip(*segs)) for segs in itertools.product(*dims)]


def _writes(spec, mesh):
    """Whether this rank writes its block of a leaf under ``spec``: it
    sits at 0 along every axis the spec leaves replicated."""
    split = set(spec.axes()) if spec else set()
    return all(c == 0 for a, c in mesh.coords.items() if a not in split)


def _whole(shape):
    return [((0,) * len(shape), (0,) * len(shape), tuple(shape))]


def _region(x, start, size):
    return x[tuple(slice(s, s + n) for s, n in zip(start, size))]


def _write_file(obj, path):
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _barrier(mesh):
    import torch.distributed as dist

    dist.barrier(group=mesh.group)


def save(path, state, force=True, sync=False, mesh=None, specs=None):
    """Save ``state`` (a tree, see the module docstring) under the
    directory ``path``.

    Without ``mesh``: rank 0 of a replicated job writes and the other
    ranks return at once, so a rank that restores right after must
    synchronize first: ``sync=True`` takes a barrier on the lane (then
    every rank must call save), or the caller takes one. With ``mesh``
    and ``specs`` (the spec tree of ``shard_params``, matching
    ``state``'s sharded subtrees; a leaf with no spec is replicated)
    every rank of the mesh calls save and writes its blocks; it returns
    when every rank's are on disk. ``force`` overwrites a checkpoint at
    ``path``; without it an existing one raises ``FileExistsError``."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path) and not force:
        raise FileExistsError(f"a checkpoint exists at {path}")
    lead = mesh.rank == 0 if mesh is not None else _i_write()
    if mesh is None and not lead:
        if sync:
            _lane_barrier()
        return
    if mesh is not None:
        _barrier(mesh)   # every rank has looked before rank 0 clears it
    if lead:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
    if mesh is not None:
        _barrier(mesh)
    blocks, keys = {}, itertools.count()

    def leaf(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        key = str(next(keys))
        if mesh is None:
            shape = tuple(x.shape)
            blocks[key] = [((0,) * x.dim(), x.detach().cpu())]
        else:
            shape = _global_shape(x.shape, spec, mesh)
            if _writes(spec, mesh):
                blocks[key] = [(g, _region(x, lo, n).detach().cpu())
                               for g, lo, n in _boxes(shape, spec, mesh)]
        return _Leaf(key, shape, x.dtype)

    tree = _map(leaf, encode_pytree(state), specs)
    rank = mesh.rank if mesh is not None else 0
    _write_file(blocks, os.path.join(path, f"blocks.{rank}.pt"))
    if mesh is not None:
        _barrier(mesh)
    if lead:
        _write_file(tree, os.path.join(path, _TREE))
    if mesh is not None:
        _barrier(mesh)
    elif sync:
        _lane_barrier()


def _global_shape(shape, spec, mesh):
    from horovod_tpu_torch.parallel.sharding import block_index

    if not spec:
        return tuple(shape)
    return tuple(n * block_index(mesh, spec.entry(d))[1]
                 for d, n in enumerate(shape))


def _lane_barrier():
    if basics.is_initialized() and basics.size() > 1:
        from horovod_tpu_torch.torch.mpi_ops import barrier

        barrier()


def _fill(out, boxes, stored):
    """Copy into ``out`` (this rank's block, laid out by ``boxes``) every
    part of the ``stored`` boxes ``[(global start, tensor)]`` that falls
    in it; returns how many elements were filled."""
    filled = 0
    for g, lo, n in boxes:
        for s_start, t in stored:
            a = [max(g[d], s_start[d]) for d in range(len(g))]
            b = [min(g[d] + n[d], s_start[d] + t.shape[d])
                 for d in range(len(g))]
            if any(hi <= la for la, hi in zip(a, b)):
                continue
            size = [hi - la for la, hi in zip(a, b)]
            src = _region(t, [la - s for la, s in zip(a, s_start)], size)
            dst = _region(out, [lo[d] + a[d] - g[d] for d in range(len(g))],
                          size)
            if src.dtype != dst.dtype:
                src = src.to(dst.dtype)
            dst.copy_(src)
            filled += src.numel()
    return filled


def restore(path, target=None, mesh=None, specs=None):
    """The tree saved by :func:`save` under ``path``.

    Without ``target``: the saved tree, its tensors whole and on the
    CPU. With ``target`` (a tree like the saved one, of tensors): each
    tensor leaf comes back with the target leaf's dtype and device; with
    ``mesh`` and ``specs`` too, as this rank's block of the leaf under
    its spec (any spec, not only the one it was saved under), else the
    whole leaf. Each rank reads only the stored boxes its block meets."""
    path = os.path.abspath(os.fspath(path))
    tree_path = os.path.join(path, _TREE)
    if not os.path.exists(tree_path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    saved = torch.load(tree_path, map_location="cpu", weights_only=False)
    stored = {}
    for name in sorted(os.listdir(path)):
        if _BLOCKS.match(name):
            part = torch.load(os.path.join(path, name), map_location="cpu",
                              mmap=True, weights_only=False)
            for key, boxes in part.items():
                stored.setdefault(key, []).extend(boxes)

    def leaf(x, like, spec):
        if not isinstance(x, _Leaf):
            return x
        if not isinstance(like, torch.Tensor):
            like = None
        if mesh is not None and like is not None:
            boxes = _boxes(x.shape, spec, mesh)
            shape = _block_shape(x.shape, spec, mesh)
        else:
            boxes, shape = _whole(x.shape), x.shape
        out = torch.empty(shape, dtype=like.dtype if like is not None
                          else x.dtype, device=like.device
                          if like is not None else "cpu")
        want = out.numel()
        if _fill(out, boxes, stored.get(x.key, [])) != want:
            raise ValueError(f"the checkpoint at {path} does not hold "
                             f"every element of its {x.shape} leaf "
                             f"{x.key}")
        return out

    return decode_pytree(_map(leaf, saved, target, specs))


def _block_shape(shape, spec, mesh):
    from horovod_tpu_torch.parallel.sharding import block_index

    if not spec:
        return tuple(shape)
    return tuple(n // block_index(mesh, spec.entry(d))[1]
                 for d, n in enumerate(shape))


# ---- step-numbered checkpoints ----------------------------------------

def _rebuild(like, items):
    """A list, tuple or named tuple like ``like`` holding ``items``; a
    named tuple keeps its instance attributes (a ZeRO state's
    ``zero_layout``)."""
    if hasattr(like, "_make"):
        out = like._make(items)
        if getattr(like, "__dict__", None):
            out.__dict__.update(like.__dict__)
        return out
    return type(like)(items)


def _to_host(tree, into=None):
    """A host copy of ``tree``: tensors copied (CUDA ones into pinned
    memory, queued on the current stream and synchronized once), other
    leaves deep-copied. A tensor of ``into`` (the previous snapshot)
    at the same place, of the same shape and dtype, and pinned where the
    source is on the card, is written over instead of allocated anew:
    a commit then holds one host state and calls no ``cudaHostAlloc``."""
    cards = set()

    def walk(v, old):
        if isinstance(v, dict):
            old = old if isinstance(old, dict) else {}
            return type(v)((k, walk(x, old.get(k))) for k, x in v.items())
        if isinstance(v, (list, tuple)):
            if not isinstance(old, (list, tuple)) or len(old) != len(v):
                old = [None] * len(v)
            return _rebuild(v, [walk(x, o) for x, o in zip(v, old)])
        if not torch.is_tensor(v):
            return copy.deepcopy(v)
        v = v.detach()
        if torch.is_tensor(old) and old.device.type == "cpu" and \
                old.shape == v.shape and old.dtype == v.dtype and \
                (not v.is_cuda or old.is_pinned()):
            out = old
        else:
            out = torch.empty(v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
        out.copy_(v, non_blocking=v.is_cuda)
        if v.is_cuda:
            cards.add(v.device)
        return out

    out = walk(tree, into)
    for card in cards:
        torch.cuda.synchronize(card)
    return out


def _onto(tree, target):
    """``tree``'s tensors with the dtype and device of ``target``'s."""

    def leaf(x, like):
        if not isinstance(x, torch.Tensor) or \
                not isinstance(like, torch.Tensor):
            return x
        if x.dtype != like.dtype:
            x = x.to(like.dtype)
        return x.to(like.device)

    return _map(leaf, tree, target)


class CheckpointManager:
    """Checkpoints by step under ``directory``, the newest
    ``max_to_keep`` kept; ``async_save`` writes on a thread."""

    def __init__(self, directory, max_to_keep=3, async_save=True):
        self._dir = os.path.abspath(os.fspath(directory))
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._thread = None
        self._inflight = None
        self._error = None
        # The last write's seconds (on its thread for an async save) and
        # the bytes of its file.
        self.last_write_s = None
        self.last_write_bytes = None
        self._last = None

    def _path(self, step):
        return os.path.join(self._dir, f"{int(step)}.pt")

    def _ensure_role(self):
        """Whether this rank writes, re-evaluated at each call: an
        elastic reset renumbers the ranks, and a rank that stops being
        rank 0 finishes its write in flight and writes no more."""
        writer = _i_write()
        if not writer:
            self.wait()
        return writer

    def all_steps(self):
        steps = set()
        if os.path.isdir(self._dir):
            steps = {int(m.group(1)) for m in map(_STEP.match,
                                                  os.listdir(self._dir))
                     if m}
        if self._inflight is not None:
            steps.add(self._inflight)
        return sorted(steps)

    def save(self, step, state, wait=False):
        """Write ``state`` (anything ``torch.save`` takes; the tensors of
        its tree are what an async save snapshots) under ``step``: at
        once, or with ``async_save`` on a thread once the state is on the
        host. ``wait`` blocks until the file is on disk. False on a rank
        that does not write, and when the step is already on disk."""
        if not self._ensure_role():
            return False
        self.wait()
        if os.path.exists(self._path(step)):
            return False
        os.makedirs(self._dir, exist_ok=True)
        if not self._async:
            self._write(int(step), state)
            return True
        # The write in flight has ended (joined above): its snapshot's
        # buffers take this one.
        snap = self._last = _to_host(state, self._last)
        self._inflight = int(step)
        self._thread = threading.Thread(target=self._write_caught,
                                        args=(int(step), snap),
                                        name="hvd-checkpoint")
        self._thread.start()
        if wait:
            self.wait()
        return True

    def _write(self, step, snap):
        t0 = time.perf_counter()
        _write_file(snap, self._path(step))
        self.last_write_s = time.perf_counter() - t0
        self.last_write_bytes = os.path.getsize(self._path(step))
        steps = sorted(int(m.group(1)) for m in map(_STEP.match,
                                                    os.listdir(self._dir))
                       if m)
        for old in steps[:max(len(steps) - self._max_to_keep, 0)]:
            os.remove(self._path(old))

    def _write_caught(self, step, snap):
        try:
            self._write(step, snap)
        except BaseException as e:  # noqa: BLE001 -- raised by wait()
            self._error = e

    def _block_path(self, step, key):
        return os.path.join(self._dir, f"{int(step)}.{key}.pt")

    def save_block(self, step, key, block):
        """Write this rank's ``block`` of ``step`` under ``key`` (every
        rank writes its own; skipped when on disk); the blocks of this
        key older than the newest ``max_to_keep`` steps are removed."""
        path = self._block_path(step, key)
        if os.path.exists(path):
            return False
        os.makedirs(self._dir, exist_ok=True)
        _write_file(block, path)
        pat = re.compile(rf"(\d+)\.{re.escape(key)}\.pt\Z")
        steps = sorted(int(m.group(1)) for m in map(pat.match,
                                                    os.listdir(self._dir))
                       if m)
        for old in steps[:max(len(steps) - self._max_to_keep, 0)]:
            os.remove(self._block_path(old, key))
        return True

    def has_block(self, step, key):
        return os.path.exists(self._block_path(step, key))

    def restore_block(self, step, key):
        """The block written under ``step`` and ``key``, on the CPU."""
        return torch.load(self._block_path(step, key), map_location="cpu",
                          weights_only=False)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step=None, target=None):
        """The state saved under ``step`` (default: the latest): on the
        CPU, or with ``target`` (a tree like it) each tensor with the
        target's dtype and device. Every rank may call it; a write in
        flight from this process is joined first."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self._dir}")
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=False)
        return state if target is None else _onto(state, target)

    def wait(self):
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
