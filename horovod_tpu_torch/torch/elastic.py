"""Elastic training for the PyTorch frontend (``hvd.elastic``).

Counterpart of ``horovod_tpu/torch/elastic.py`` (``TorchState``: a
model's and an optimizer's state dicts and picklable extras, committed
to host memory, restored after a failed collective, synced from rank 0
after a reset; ``run``, ``init``, ``reset``, ``ObjectState``,
``survivors``) and of ``horovod_tpu/jax/elastic.py:43 JaxState`` as
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

import torch

from horovod_tpu_torch.common import elastic as _elastic
from horovod_tpu_torch.common.elastic import State

run = _elastic.run_fn
init = _elastic.init
reset = _elastic.reset
ObjectState = _elastic.ObjectState
survivors = _elastic.survivors
rejoin = _elastic.rejoin


def _map(fn, *trees):
    """``fn`` over the leaves of ``trees`` (the first one's structure:
    dicts, lists, tuples and named tuples)."""
    head = trees[0]
    if isinstance(head, dict):
        return type(head)((k, _map(fn, *(t[k] for t in trees)))
                          for k in head)
    if isinstance(head, (list, tuple)):
        out = [_map(fn, *parts) for parts in zip(*trees)]
        if hasattr(head, "_make"):
            return head._make(out)
        return type(head)(out)
    return fn(*trees)


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
            out = [walk(x, o) for x, o in zip(v, old)]
            return v._make(out) if hasattr(v, "_make") else type(v)(out)
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


def _devices(tree):
    return _map(lambda v: v.device if torch.is_tensor(v) else None, tree)


def _to_devices(tree, devices):
    """``tree``'s tensors copied to ``devices`` (a like tree; None keeps
    the host), other leaves deep-copied: never aliases the snapshot."""
    def leaf(v, device):
        if not torch.is_tensor(v):
            return copy.deepcopy(v)
        return v.to(device or "cpu", copy=True,
                    non_blocking=v.is_pinned())

    return _map(leaf, tree, devices if devices is not None else
                _map(lambda v: None, tree))


class _Durable(State):
    """Commit-to-disk plumbing shared by both states."""

    def __init__(self, checkpoint_dir):
        super().__init__()
        self._ckpt_mgr = None
        self._commit_step = 0
        if checkpoint_dir is not None:
            from horovod_tpu_torch.checkpoint import CheckpointManager

            self._ckpt_mgr = CheckpointManager(checkpoint_dir)
            # Continue past a previous run's commits: a step already on
            # disk is never written again.
            self._commit_step = self._ckpt_mgr.latest_step() or 0

    def commit(self):
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
    from (each rank its own), in its dtype."""

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

    def sync(self):
        _elastic._sync_state(self, "elastic.tree_state")
