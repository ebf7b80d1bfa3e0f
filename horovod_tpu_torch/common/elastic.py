"""Elastic training: the worker-side retry loop and state machinery.

The port's counterpart of ``horovod_tpu/common/elastic.py``: training
wraps in ``@hvd.elastic.run`` (:func:`run_fn`); a failed collective
raises ``HorovodInternalError`` (a lost peer the typed
``HorovodPeerFailureError``), the state rolls back to its last commit
and :func:`reset` re-forms the world; a topology change the driver
announces raises ``HostsUpdatedInterrupt``, which re-rendezvouses
without the rollback. State objects commit to host memory
(:class:`State`, :class:`ObjectState`; the torch frontend's
``TorchState`` and ``TreeState``) and, after a reset, take rank 0's
commit (:func:`_sync_state`) over the port's own lane
(``torch/functions.py``), under the reference's op names.

:func:`reset` takes the reference's three paths in order: under the
elastic driver (``HOROVOD_RDZV_ADDR``) a re-rendezvous for the next
epoch's assignment; without one, a re-formation in place over
:func:`survivors` (``basics.reinit``); otherwise a full ``shutdown()``
and ``init()`` of the same world at the next epoch. Without a driver,
rank 0 hosts the rendezvous store and must survive.

Not in this slice: the parole door (``rejoin``, ``_ParoleDoor``,
``HOROVOD_REJOIN_PORT``, joiner slots; ROADMAP.md L5b), so the commit's
host check polls only the driver's notifications; the voluntary
``shrink`` (the autoscaler's, A12); the bare-mpirun bootstrap (L9).
"""

import copy
import os
import socket
import sys
import uuid
import warnings

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.common.metrics import REGISTRY


def _is_elastic():
    return bool(os.environ.get("HOROVOD_RDZV_ADDR"))


# Frontends register what must re-initialize with the world here (the
# auto-namer's counters, the optimizer's stale handles); reset() runs
# them once the new epoch's lane is up.
_post_reset_hooks = []


def register_post_reset_hook(fn):
    if fn not in _post_reset_hooks:
        _post_reset_hooks.append(fn)


def unregister_post_reset_hook(fn):
    try:
        _post_reset_hooks.remove(fn)
    except ValueError:
        pass


def _run_post_reset_hooks():
    for hook in list(_post_reset_hooks):
        hook()


def _worker_id():
    wid = os.environ.get("HOROVOD_WORKER_ID")
    if not wid:
        wid = f"{socket.gethostname()}:{uuid.uuid4().hex[:8]}"
        os.environ["HOROVOD_WORKER_ID"] = wid
    return wid


def survivors():
    """The rank-consistent survivor list of the current fault, or None
    when no driverless agreement is possible: no unrecovered fault, a
    record that is not ``certain`` at a size above 2 (at size 2 the
    suspect can only be the other rank), or a corruption record (the
    peer is alive)."""
    if not basics.is_initialized():
        return None
    fault = basics.last_fault()
    if fault is None or fault.get("recovered"):
        return None
    if fault.get("kind") == "corruption":
        return None
    dead = {int(r) for r in fault.get("ranks") or ()}
    size = basics.size()
    if not dead or not (fault.get("certain") or size == 2):
        return None
    return [r for r in range(size) if r not in dead]


def rejoin(addr=None, port=None, timeout=None):
    """The parole door's joiner side: not ported yet."""
    raise NotImplementedError(
        "hvd.elastic.rejoin (the parole door: driverless scale-up) is not "
        "ported yet (ROADMAP.md L5b)")


def init(device=None, epoch=None):
    """Open the lane; under the elastic driver, first register and take
    this epoch's rank assignment, exported as the ``HOROVOD_*`` layout.
    ``device`` as ``basics.init`` (None: the card); ``epoch`` applies
    without a driver (the driver numbers its own)."""
    if not _is_elastic():
        basics.init(device, epoch=epoch)
        return
    from horovod_tpu_torch.runner.elastic.rendezvous import RendezvousClient
    from horovod_tpu_torch.runner.elastic.worker import notification_manager

    client = RendezvousClient(os.environ["HOROVOD_RDZV_ADDR"],
                              os.environ["HOROVOD_RDZV_PORT"])
    notify_port = notification_manager.init()
    last_epoch = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", 0))
    client.register(_worker_id(), os.environ.get("HOROVOD_HOSTNAME",
                                                 socket.gethostname()),
                    int(os.environ.get("HOROVOD_LOCAL_RANK", 0)),
                    notify_port, last_epoch=last_epoch)
    timeout = float(os.environ.get("HOROVOD_START_TIMEOUT", 60))
    asg = client.poll_assignment(_worker_id(), timeout,
                                 min_epoch=last_epoch + 1)
    os.environ["HOROVOD_ELASTIC_EPOCH"] = str(asg["epoch"])
    os.environ.update({
        "HOROVOD_RANK": str(asg["rank"]),
        "HOROVOD_SIZE": str(asg["size"]),
        "HOROVOD_LOCAL_RANK": str(asg["local_rank"]),
        "HOROVOD_LOCAL_SIZE": str(asg["local_size"]),
        "HOROVOD_CROSS_RANK": str(asg["cross_rank"]),
        "HOROVOD_CROSS_SIZE": str(asg["cross_size"]),
        "HOROVOD_CONTROLLER_ADDR": asg["controller_addr"],
        "HOROVOD_CONTROLLER_PORT": str(asg["controller_port"]),
    })
    basics.init(device)


def _reset_driverless():
    """Re-form in place over :func:`survivors` at the fault's epoch + 1.
    True when this path applied; False defers to the full re-init. A
    rank its peers declared dead gets a terminal ``RuntimeError`` (not a
    ``HorovodInternalError``: it must leave the retry loop)."""
    if not basics.is_initialized() or not basics.loop_failed():
        # A healthy lane re-forms in place only to absorb paroled
        # joiners, and the door is not ported (L5b).
        return False
    alive = survivors()
    if alive is None:
        return False
    fault = basics.last_fault()
    old_rank = basics.rank()
    if old_rank not in alive:
        raise RuntimeError(
            f"rank {old_rank} was declared dead by its peers (fault: "
            f"{fault.get('reason')}); cannot rejoin epoch "
            f"{fault.get('epoch', 0) + 1} in-process")
    try:
        basics.reinit(alive, int(fault.get("epoch", 0)) + 1)
    except RuntimeError as e:
        warnings.warn(f"in-place re-formation failed ({e}); falling back "
                      "to full re-initialization", RuntimeWarning,
                      stacklevel=2)
        return False
    return True


def reset():
    """Tear down and re-form (an elastic epoch transition): the driver's
    re-rendezvous, else a re-formation in place over the survivors,
    else ``shutdown()`` and ``init()`` of the same world at the next
    epoch; then the post-reset hooks."""
    if not _is_elastic() and _reset_driverless():
        _run_post_reset_hooks()
        return
    # The lane re-opens on the device it ran on (None, the card, when
    # none is open).
    device = None
    if basics.is_initialized():
        device = "cpu" if basics.device() is None else "cuda"
    fault = basics.last_fault()
    target = basics.epoch() + 1
    basics.shutdown()
    init(device, epoch=None if _is_elastic() else target)
    REGISTRY.record_reset(len(fault["ranks"]) if fault is not None and
                          not fault["recovered"] else 0)
    _run_post_reset_hooks()


def _poll_hosts_updated():
    if not _is_elastic():
        return False, False
    from horovod_tpu_torch.runner.elastic.worker import notification_manager

    return notification_manager.poll_hosts_updated()


class State:
    """Base elastic state: commit/restore/sync and reset callbacks."""

    def __init__(self):
        self._reset_callbacks = []

    def register_reset_callbacks(self, callbacks):
        """Callbacks run after every reset (e.g. rescale the learning
        rate to the new world size)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def commit(self):
        """Snapshot to host memory, then surface a pending topology
        change as ``HostsUpdatedInterrupt``."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self):
        updated, skip_sync = _poll_hosts_updated()
        if updated:
            raise HostsUpdatedInterrupt(skip_sync)

    # The subclass surface:
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


def _broadcast_object(obj, root_rank=0, name="elastic.obj"):
    """``obj`` pickled from ``root_rank`` over the lane (two broadcasts:
    its length, then its bytes)."""
    from horovod_tpu_torch.torch import functions

    return functions.broadcast_object(obj, root_rank, name=name)


def _allgather_object(obj, name="allgather.obj"):
    """Every rank's ``obj``, a list by rank."""
    from horovod_tpu_torch.torch import functions

    return functions.allgather_object(obj, name=name)


def _sync_state(state, name, attr="_saved"):
    """Rank 0 snapshots, every rank adopts its snapshot (kept in
    ``attr``), then restores. A no-op at size 1."""
    if basics.size() == 1:
        return
    if basics.rank() == 0:
        state.save()
    setattr(state, attr, _broadcast_object(getattr(state, attr), name=name))
    state.restore()


class ObjectState(State):
    """Elastic state over picklable attributes, set by keyword and
    committed, restored and synced as one unit."""

    def __init__(self, **kwargs):
        super().__init__()
        self._saved_state = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def save(self):
        self._saved_state = {
            k: copy.deepcopy(getattr(self, k)) for k in self._saved_state}

    def restore(self):
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self):
        _sync_state(self, "elastic.object_state", attr="_saved_state")


def _is_internal_error(exc):
    """``HorovodInternalError``, or an error raised ``from`` one: the
    explicit ``__cause__`` chain only. An implicit ``__context__`` does
    not count: ``except HorovodInternalError: raise RuntimeError(...)``
    is a deliberate abort. (The reference also matches TensorFlow's
    wrapped errors by text; the port runs torch only.)"""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, HorovodInternalError):
            return True
        exc = exc.__cause__
    return False


def run_fn(func):
    """Wrap an elastic training function: sync, run, and on a failed
    collective restore the last commit, reset and run again::

        @hvd.elastic.run
        def train(state, ...): ...
    """

    def wrapper(state, *args, **kwargs):
        skip_sync = False
        while True:
            # sync() runs collectives, so it sits inside the recovery
            # scope: a peer lost right after a reset loops again.
            try:
                if not skip_sync:
                    state.sync()
                return func(state, *args, **kwargs)
            except HostsUpdatedInterrupt as e:
                skip_sync = e.skip_sync
            except Exception as e:  # noqa: BLE001 — see _is_internal_error
                if not _is_internal_error(e):
                    raise
                if os.environ.get("HOROVOD_ELASTIC_VERBOSE"):
                    print(f"[elastic] recovering from: {e!r}",
                          file=sys.stderr)
                state.restore()
                skip_sync = False
            reset()
            state.on_reset()

    return wrapper
