"""Elastic training for the PyTorch frontend (``hvd.elastic``).

Counterpart of ``horovod_tpu/torch/elastic.py`` (``TorchState``: a
model's and an optimizer's state dicts and picklable extras, committed
to host memory, restored after a failed collective, synced from rank 0
after a reset; ``run``, ``init``, ``reset``, ``ObjectState``,
``survivors``, ``rejoin``, ``shrink``) and of
``horovod_tpu/jax/elastic.py:43 JaxState`` as
:class:`TreeState`: named trees (nested dicts, lists, tuples) of
tensors, such as the ``(params, opt)`` carry of
``parallel/train_step.py make_split_train_step``.

A commit copies every tensor to the host (a CUDA tensor into pinned
memory, one synchronize for the whole state), into the previous
commit's host tensors where they fit, so that a run holds one host copy
of its state and allocates it once. ``TreeState.restore``
puts each tensor back on the device it was committed from, in its
dtype; ``JaxState.restore`` leaves host arrays that JAX moves on first
use, but the port's split step follows its params' device, so host
tensors there would move training to the CPU. ``checkpoint_dir`` also
writes each commit to disk (``horovod_tpu_torch/checkpoint.py``; rank 0
writes) and ``resume()`` reloads the newest after a restart, its step
numbers continuing past a previous run's commits.
"""

import copy
import time

import torch

from horovod_tpu_torch.checkpoint import _rebuild, _to_host
from horovod_tpu_torch.common import elastic as _elastic
from horovod_tpu_torch.common.elastic import State
from horovod_tpu_torch.common.exceptions import (
    HorovodReformationError,
    HorovodStateLostError,
)
from horovod_tpu_torch.parallel.reshard import (
    execute_plan,
    plan_redistribute,
    reshard_rows,
    rows_layout,
    torch_dtype_as_numpy,
)
from horovod_tpu_torch.parallel.zero import (
    SHARD_FIELDS,
    ZeroCarryLayout,
    is_zero_state,
    state_layout,
)

run = _elastic.run_fn
init = _elastic.init
reset = _elastic.reset
ObjectState = _elastic.ObjectState
survivors = _elastic.survivors
rejoin = _elastic.rejoin
shrink = _elastic.shrink


def _map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (the first one's structure:
    dicts, lists, tuples and named tuples)."""
    head = trees[0]
    if isinstance(head, dict):
        return type(head)((k, _map(fn, *(t[k] for t in trees)))
                          for k in head)
    if isinstance(head, (list, tuple)):
        return _rebuild(head, [_map(fn, *parts) for parts in zip(*trees)])
    return fn(*trees)


def _devices(tree):
    return _map(lambda v: v.device if torch.is_tensor(v) else None, tree)


def _to_devices(tree, devices):
    """``tree``'s tensors copied to ``devices`` (a like tree; None keeps
    the host, and so does a place ``devices`` lacks: a resumed commit
    may hold keys the live tree has not), other leaves deep-copied:
    never aliases the snapshot."""
    def walk(v, device):
        if isinstance(v, dict):
            device = device if isinstance(device, dict) else {}
            return type(v)((k, walk(x, device.get(k))) for k, x in v.items())
        if isinstance(v, (list, tuple)):
            if not isinstance(device, (list, tuple)) or \
                    len(device) != len(v):
                device = [None] * len(v)
            return _rebuild(v, [walk(x, d) for x, d in zip(v, device)])
        if not torch.is_tensor(v):
            return copy.deepcopy(v)
        return v.to(device if isinstance(device, torch.device) else "cpu",
                    copy=True, non_blocking=v.is_pinned())

    return walk(tree, devices)


class _Durable(State):
    """Commit-to-disk plumbing shared by both states."""

    def __init__(self, checkpoint_dir):
        super().__init__()
        self._ckpt_mgr = None
        self._commit_step = 0
        if checkpoint_dir is not None:
            from horovod_tpu_torch.checkpoint import CheckpointManager

            self._ckpt_mgr = CheckpointManager(checkpoint_dir,
                                               async_save=False)
            # Continue past a previous run's commits: a step already on
            # disk is never written again.
            self._commit_step = self._ckpt_mgr.latest_step() or 0

    def commit(self):
        _elastic.settle_card()
        self.save()
        if self._ckpt_mgr is not None:
            self._commit_step += 1
            self._ckpt_mgr.save(self._commit_step, self._saved)
        self.check_host_updates()

    def resume(self):
        """Load the newest on-disk commit (a cold restart): its step, or
        None when the directory holds none yet."""
        if self._ckpt_mgr is None:
            raise ValueError(f"{type(self).__name__} was created without "
                             "checkpoint_dir")
        step = self._ckpt_mgr.latest_step()
        if step is None:
            return None
        self._saved = self._ckpt_mgr.restore(step)
        self._commit_step = step
        self.restore()
        return step


class TorchState(_Durable):
    """Elastic state of a model and an optimizer, plus picklable extras
    set by keyword (``step=0``)."""

    def __init__(self, model=None, optimizer=None, checkpoint_dir=None,
                 **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._extra_keys = list(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        super().__init__(checkpoint_dir)
        self.save()

    def save(self):
        prev = getattr(self, "_saved", None) or {}
        self._saved = {
            "model": _to_host(self.model.state_dict(), prev.get("model"))
            if self.model is not None else None,
            "optimizer": _to_host(self.optimizer.state_dict(),
                                  prev.get("optimizer"))
            if self.optimizer is not None else None,
            "extra": {k: copy.deepcopy(getattr(self, k))
                      for k in self._extra_keys},
        }

    def restore(self):
        saved = self._saved
        if self.model is not None and saved["model"] is not None:
            self.model.load_state_dict(saved["model"])   # copies in place
        if self.optimizer is not None and saved["optimizer"] is not None:
            self.optimizer.load_state_dict(saved["optimizer"])
            # load_state_dict keeps a CPU tensor that needs no cast (Adam's
            # step counts, a CPU model's moments): copy it, or the next
            # step would update the snapshot in place.
            for state in self.optimizer.state.values():
                for key, v in state.items():
                    if torch.is_tensor(v) and v.device.type == "cpu":
                        state[key] = v.clone()
        for k, v in saved["extra"].items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        _elastic._sync_state(self, "elastic.torch_state")


class TreeState(_Durable):
    """Elastic state over named trees of tensors and picklable values::

        state = hvd.elastic.TreeState(carry=carry, step=0)

    ``restore`` puts each tensor back on the device it was committed
    from (each rank its own), in its dtype.

    A ZeRO carry's state (``parallel.zero.is_zero_state``: the split
    step's ``ZeroAdamState``/``ZeroMasterAdamState``, the eager lane's
    dict) holds only this rank's block, so it is never taken from rank
    0. ``sync`` re-lays every rank's blocks out onto the even layout of
    the current world (``parallel.reshard.reshard_rows``, one alltoallv
    a bucket and field, on the blocks' devices), each rank's rows held
    read from synced state: every rank's ``zero_layout``, gathered, the
    members of rank 0's layout holding their blocks and a joiner none.
    A reset that lost no rank moves nothing. The other leaves come from
    rank 0 as before, the tensors broadcast in place over the lane. Rows
    no rank holds come from ``checkpoint_dir``'s block files of the
    commit when every block of it is there (each rank writes its own),
    else ``sync`` raises :class:`HorovodStateLostError` naming them.
    ``hvd.elastic.shrink(victims, state=)`` hands the victims' rows over
    before they leave (:meth:`hand_over`). ``last_relayout_s`` is the
    last re-layout's (or hand-over's) seconds, its cards synchronized.
    JAX's carry is the global view, broadcast like any other."""

    def __init__(self, checkpoint_dir=None, **trees):
        self._keys = list(trees)
        for k, v in trees.items():
            setattr(self, k, v)
        super().__init__(checkpoint_dir)
        self.save()

    def save(self):
        self._devices = {k: _devices(getattr(self, k)) for k in self._keys}
        prev = getattr(self, "_saved", None) or {}
        self._saved = {k: _to_host(getattr(self, k), prev.get(k))
                       for k in self._keys}

    def restore(self):
        for k, v in self._saved.items():
            setattr(self, k, _to_devices(v, self._devices.get(k)))

    def commit(self):
        _elastic.settle_card()
        self.save()
        if self._ckpt_mgr is not None:
            self._commit_step += 1
            self._ckpt_mgr.save(self._commit_step, self._saved)
            zero = self._zero_paths()
            if zero:
                # Every rank its own blocks: rank 0's file holds its own.
                self._ckpt_mgr.save_block(self._commit_step, _block_key(), [
                    _zero_block(_get(self._saved[k], p)) for k, p in zero])
        self.check_host_updates()

    def resume(self):
        step = super().resume()
        zero = self._zero_paths()
        if step is None or not zero:
            return step
        # The restored snapshot is rank 0's: each rank takes its own
        # blocks of the commit, or none when the commit had fewer ranks.
        own = _read_block(self._ckpt_mgr, step, zero_index=None)
        for j, (k, p) in enumerate(zero):
            st = _get(getattr(self, k), p)
            blocks = _fields(st)
            if own:
                fields, meta = own[j]
            else:
                fields = {f: [b[:0] for b in bs] for f, bs in blocks.items()}
                meta = state_layout(st)._replace(shard_rank=-1)
            fields = {f: [b.to(t.device, t.dtype) for b, t in
                          zip(bs, blocks[f])] for f, bs in fields.items()}
            setattr(self, k, _put(getattr(self, k), p,
                                  _with_blocks(st, fields, meta)))
        self.save()
        return step

    def _zero_paths(self):
        """``(key, path)`` of every ZeRO state in the live trees."""
        return [(k, p) for k in self._keys
                for p in _zero_paths(getattr(self, k))]

    def sync(self):
        zero = self._zero_paths()
        if not zero:
            _elastic._sync_state(self, "elastic.tree_state")
            return
        states = [_get(getattr(self, k), p) for k, p in zero]
        t0 = time.perf_counter()
        relaid = _relayout(states, self._commit_step, self._ckpt_mgr)
        self.last_relayout_s = _settled(relaid, t0)
        for (k, p), st in zip(zero, relaid):
            setattr(self, k, _put(getattr(self, k), p, st))
        _sync_rest(self, zero)
        self.save()

    def hand_over(self, victims):
        """A voluntary shrink's first half (collective on the old world,
        victims included): each ZeRO state's blocks moved onto the
        survivors' layout of the smaller world, the victims left holding
        no row (one alltoallv a bucket and field, ``Layout.from_rows``).
        Returns ``finish()``, which a survivor calls once the world has
        re-formed: it installs the blocks and commits to host memory."""
        zero = self._zero_paths()
        t0 = time.perf_counter()
        moved = [_hand_over(_get(getattr(self, k), p), victims, j)
                 for j, (k, p) in enumerate(zero)]
        self.last_relayout_s = _settled([m[0] for m in moved], t0)

        def finish():
            epoch = _elastic.basics.epoch()
            for (k, p), (st, fields, meta) in zip(zero, moved):
                setattr(self, k, _put(getattr(self, k), p, _with_blocks(
                    st, fields, meta._replace(epoch=epoch))))
            self.save()

        return finish


# ---- ZeRO carries across a re-formation --------------------------------


def _settled(states, t0):
    """Seconds since ``t0`` once the cards holding ``states``' blocks
    have finished their work (``last_relayout_s``)."""
    cards = {t.device for st in states for bs in _fields(st).values()
             for t in bs if t.is_cuda}
    for card in cards:
        torch.cuda.synchronize(card)
    return time.perf_counter() - t0


def _zero_paths(tree, path=()):
    if is_zero_state(tree):
        return [path]
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _zero_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _zero_paths(v, path + (i,))]
    return []


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    """``tree`` with ``value`` at ``path`` (the containers on the way
    rebuilt)."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return type(tree)((k, _put(v, rest, value) if k == head else v)
                          for k, v in tree.items())
    return _rebuild(tree, [_put(v, rest, value) if i == head else v
                           for i, v in enumerate(tree)])


def _fields(state):
    """A ZeRO state's block fields: ``{field: [each bucket's block]}``."""
    if isinstance(state, dict):
        return {f: list(state[f]) for f in SHARD_FIELDS if f in state}
    return {f: list(getattr(state, f)) for f in SHARD_FIELDS
            if f in state._fields}


def _with_blocks(state, fields, meta):
    """``state`` holding ``fields``' blocks, laid out as ``meta``."""
    if isinstance(state, dict):
        return dict(state, **{f: list(v) for f, v in fields.items()},
                    zero_layout=meta)
    out = state._replace(**{f: tuple(v) for f, v in fields.items()})
    out.zero_layout = meta
    return out


def _zero_block(state):
    """What a rank's block file holds of one ZeRO state."""
    return (_fields(state), state_layout(state))


def _block_key(shard=None):
    shard = _elastic.basics.rank() if shard is None else shard
    return f"zero{int(shard)}"


def _read_block(ckpt, step, zero_index, shard=None):
    """This rank's (or shard ``shard``'s) block file of ``step``: a list
    of ``(fields, meta)``, one a ZeRO state; None when absent. With
    ``zero_index`` the entry of that state alone."""
    key = _block_key(shard)
    if ckpt is None or step is None or not ckpt.has_block(step, key):
        return None
    blocks = ckpt.restore_block(step, key)
    return blocks if zero_index is None else blocks[zero_index]


def _world():
    b = _elastic.basics
    if not b.is_initialized():
        return 0, 1, 0
    return b.rank(), b.size(), b.epoch()


def _real_rows(meta, bucket, shard):
    """The rows of block ``shard`` of ``bucket`` that are not padding."""
    s = meta.padded()[bucket] // meta.n_shards
    n = meta.nelems[bucket]
    return max(0, min(n, (shard + 1) * s) - shard * s)


def _relayout(states, commit_step, ckpt, name="elastic.zero"):
    """Every ZeRO state's blocks on the even layout of the current world
    (collective): the states with their new blocks, in order."""
    rank, size, epoch = _world()
    metas = [state_layout(st) for st in states]
    if any(m is None for m in metas):
        raise ValueError(
            "a ZeRO state without its zero_layout (built outside "
            "make_zero_apply/DistributedFusedAdam, e.g. by "
            "models/convert.py): its blocks cannot be re-laid out")
    mine = {"metas": metas, "step": commit_step}
    every = _elastic._allgather_object(mine, name=f"{name}.layouts") \
        if size > 1 else [mine]
    out = []
    for j, st in enumerate(states):
        ref = every[0]["metas"][j]
        holders = {r: e["metas"][j].shard_rank for r, e in enumerate(every)
                   if ref.same_layout(e["metas"][j])
                   and e["metas"][j].shard_rank >= 0}
        if ref.fixed:
            if size != ref.world or len(holders) != size:
                raise HorovodReformationError(
                    f"a ZeRO carry over a {ref.fixed} ({ref.world} ranks) "
                    f"cannot follow a re-formation to {size} ranks: the "
                    "axes are fixed (ROADMAP.md, \"Not queued\")")
            out.append(_with_blocks(st, _fields(st), metas[j]._replace(
                epoch=epoch)))
            continue
        n_old = ref.n_shards
        meta = ZeroCarryLayout(ref.nelems, size, rank, epoch, size)
        if sorted(holders.values()) != sorted(set(holders.values())):
            raise ValueError(f"two ranks hold the same ZeRO block: "
                             f"{holders}")
        lost = sorted(set(range(n_old)) - set(holders.values()))
        if lost:
            out.append(_with_blocks(st, _blocks_from_disk(
                st, j, ref, lost, every[0]["step"], ckpt, rank, size),
                meta))
            continue
        if n_old == size and all(holders.get(r) == r for r in range(size)):
            out.append(_with_blocks(st, _fields(st), meta))
            continue
        order = [holders[r] for r in sorted(holders)]
        if order != sorted(order):
            raise ValueError(
                f"the ranks holding ZeRO blocks are not in block order "
                f"({holders}): the re-formation renumbered them")
        fields = {}
        for f, blocks in _fields(st).items():
            fields[f] = []
            for i, block in enumerate(blocks):
                n, padded = ref.nelems[i], meta.padded()[i]
                held = [_real_rows(ref, i, holders[r]) if r in holders
                        else 0 for r in range(size)]
                held[-1] += padded - n
                local = block[:held[rank] - (padded - n
                                             if rank == size - 1 else 0)]
                if rank == size - 1:
                    local = torch.cat([local, block.new_zeros(padded - n)])
                fields[f].append(reshard_rows(
                    local, held, name=f"{name}.{j}.{f}.{i}"))
        out.append(_with_blocks(st, fields, meta))
    return out


def _blocks_from_disk(state, j, ref, lost, step, ckpt, rank, size):
    """This rank's blocks of ZeRO state ``j`` on the even layout of
    ``size`` ranks, read from the commit's block files (rows of blocks
    ``lost`` are held by no rank); raises ``HorovodStateLostError``
    unless every block of the commit is on disk."""
    shards = {}
    for k in range(ref.n_shards):
        got = _read_block(ckpt, step, j, shard=k)
        if got is None or not ref.same_layout(got[1]) or \
                got[1].shard_rank != k:
            shards = None
            break
        shards[k] = got[0]
    if shards is None:
        s = [p // ref.n_shards for p in ref.padded()]
        rows = {i: [(k * s[i], min((k + 1) * s[i], n)) for k in lost
                    if k * s[i] < n]
                for i, n in enumerate(ref.nelems)}
        rows = {i: r for i, r in rows.items() if r}
        raise HorovodStateLostError(
            f"ZeRO state {j}: blocks {lost} of {ref.n_shards} are held by "
            "no rank of the re-formed world and not all of the commit's "
            f"blocks are on disk (step {step}): lost elements by bucket "
            f"{rows}", lost={j: rows})
    s_new = [p // size for p in ref.padded(size)]
    s_old = [p // ref.n_shards for p in ref.padded()]
    fields = {}
    for f, blocks in _fields(state).items():
        fields[f] = []
        for i, block in enumerate(blocks):
            lo, hi = rank * s_new[i], (rank + 1) * s_new[i]
            out = block.new_zeros(s_new[i])
            for k, fl in shards.items():
                a, z = max(lo, k * s_old[i]), min(hi, (k + 1) * s_old[i],
                                                  ref.nelems[i])
                if a < z:
                    out[a - lo:z - lo].copy_(
                        fl[f][i][a - k * s_old[i]:z - k * s_old[i]])
            fields[f].append(out)
    return fields


def _hand_over(state, victims, j, name="elastic.handover"):
    """A ZeRO state's blocks moved on the old world onto the survivors'
    layout of the smaller one: ``(state, fields, meta)``, the fields
    padded to the new block (a victim's empty)."""
    rank, size, epoch = _world()
    meta = state_layout(state)
    if meta is None or meta.fixed or meta.n_shards != size or \
            meta.shard_rank != rank:
        raise HorovodReformationError(
            f"ZeRO state {j} ({meta}) is not laid out one block a rank "
            f"over this world of {size}: it cannot be handed over")
    alive = [r for r in range(size) if r not in victims]
    m = len(alive)
    new = ZeroCarryLayout(meta.nelems, m,
                          alive.index(rank) if rank in alive else -1,
                          epoch, m)
    fields = {}
    for f, blocks in _fields(state).items():
        fields[f] = []
        for i, block in enumerate(blocks):
            n, s_new = meta.nelems[i], new.padded()[i] // m
            src = [_real_rows(meta, i, r) for r in range(size)]
            dst = [0 if r in victims else
                   max(0, min(n, (alive.index(r) + 1) * s_new)
                       - alive.index(r) * s_new) for r in range(size)]
            plan = plan_redistribute((n,), torch_dtype_as_numpy(block.dtype),
                                     rows_layout(src), rows_layout(dst))
            got = execute_plan(plan, block[:src[rank]].contiguous(),
                               name=f"{name}.{j}.{f}.{i}")
            if rank in alive:
                got = torch.cat([got, block.new_zeros(s_new - dst[rank])])
            fields[f].append(got)
    return state, fields, new


def _sync_rest(state, zero, name="elastic.tree_state"):
    """Every leaf of ``state``'s live trees outside the ZeRO blocks
    taken from rank 0: tensors broadcast in place over the lane (on
    their devices), the other leaves in one pickled broadcast."""
    rank, size, _ = _world()
    if size == 1:
        return
    from horovod_tpu_torch.torch import mpi_ops

    blocks = {id(t) for k, p in zero
              for bs in _fields(_get(getattr(state, k), p)).values()
              for t in bs}
    tensors, others = [], []

    def walk(v, where):
        if isinstance(v, dict):
            for k in sorted(v, key=str):
                if k != "zero_layout":
                    walk(v[k], where + (k,))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(x, where + (i,))
        elif torch.is_tensor(v):
            if id(v) not in blocks:
                tensors.append(v)
        else:
            others.append(where)

    for k in state._keys:
        walk(getattr(state, k), (k,))
    handles = [mpi_ops.broadcast_async_(t, 0, name=f"{name}.{i}")
               for i, t in enumerate(tensors)]
    values = [_get({k: getattr(state, k) for k in state._keys}, w)
              for w in others]
    values = _elastic._broadcast_object(values, name=f"{name}.values")
    for h in handles:
        h.synchronize()
    for where, v in zip(others, values):
        setattr(state, where[0],
                _put(getattr(state, where[0]), where[1:], v))
