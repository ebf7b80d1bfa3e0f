"""Elastic training: the worker-side retry loop and state machinery.

The port's counterpart of ``horovod_tpu/common/elastic.py``: training
wraps in ``@hvd.elastic.run`` (:func:`run_fn`); a failed collective
raises ``HorovodInternalError`` (a lost peer the typed
``HorovodPeerFailureError``), the state rolls back to its last commit
and :func:`reset` re-forms the world; a topology change the driver
announces, or a joiner at the parole door, raises
``HostsUpdatedInterrupt``, which re-forms without the rollback. State
objects commit to host memory (:class:`State`, :class:`ObjectState`;
the torch frontend's ``TorchState`` and ``TreeState``) and, after a
reset, take rank 0's commit (:func:`_sync_state`) over the port's own
lane (``torch/functions.py``), under the reference's op names.

:func:`reset` takes the reference's three paths in order: under the
elastic driver (``HOROVOD_RDZV_ADDR``) a re-rendezvous for the next
epoch's assignment; without one, a re-formation in place over
:func:`survivors` and the joiners frozen at the parole door
(``basics.reinit``); otherwise a full ``shutdown()`` and ``init()`` of
the same world at the next epoch. Without a driver, rank 0 hosts the
rendezvous store and must survive.

The parole door (driverless scale-up): with ``HOROVOD_REJOIN_PORT`` set
on every rank, rank 0 listens on that port (:class:`_ParoleDoor`). A
fresh process calls :func:`rejoin`, says hello and is held on parole.
Each commit asks, by a MAX-allreduce of rank 0's pending count, whether
anyone waits (:func:`_poll_rejoiners`; ``HOROVOD_REJOIN_POLL=0`` turns
the check off, and joiners then enter only at a fault's re-formation);
if so every rank raises ``HostsUpdatedInterrupt`` at the same step. At
the epoch transition every survivor reads the door's joiner count,
frozen once per target epoch (:func:`_freeze_joiners`), rank 0 releases
each joiner its assignment, the world re-forms over ``alive + [-1] *
joiners`` and the joiners open straight into it (``basics.init(epoch=
E)``). :func:`shrink` re-forms the world without some ranks, no fault:
the autoscaler's scale-down leg, after which a victim may knock again.

Without a driver and without ``HOROVOD_RANK``, :func:`init` first
bootstraps from an MPI world (``mpi_bootstrap.py``, L9's first half),
as the reference's does; ``HOROVOD_CONTROLLER=mpi`` is ROADMAP.md L9b.
"""

import copy
import json
import os
import socket
import sys
import threading
import time
import uuid
import warnings

import torch

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


# ---- the parole door ---------------------------------------------------


def _rejoin_port():
    port = os.environ.get("HOROVOD_REJOIN_PORT")
    return int(port) if port else 0


def _rejoin_addr():
    return os.environ.get(
        "HOROVOD_REJOIN_ADDR",
        os.environ.get("HOROVOD_CONTROLLER_ADDR", "127.0.0.1"))


class _ParoleDoor:
    """Rank 0's rejoin listener, TCP JSON lines. A ``hello`` is held
    pending; a ``poll`` for a target epoch freezes the pending set for
    it (once: every later poll of that epoch reads the same count) and
    answers its size; :meth:`release` hands each frozen joiner its
    assignment. Frozen sets are never popped: a survivor may poll after
    rank 0 released, and must read the same count, or the re-formation's
    world sizes would disagree."""

    def __init__(self, port):
        self._lock = threading.Lock()
        self._pending = []      # [(conn, hello)]
        self._frozen = {}       # epoch -> [(conn, hello)]
        self._released = set()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", port))
        self._sock.listen(16)
        threading.Thread(target=self._serve, name="hvd-torch-parole-door",
                         daemon=True).start()

    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        try:
            conn.settimeout(30)
            msg = json.loads(conn.makefile("r").readline())
        except (OSError, ValueError):
            conn.close()
            return
        if msg.get("op") == "hello":
            conn.settimeout(None)
            with self._lock:
                self._pending.append((conn, msg))
        elif msg.get("op") == "poll":
            count = self.freeze(int(msg["epoch"]))
            try:
                conn.sendall((json.dumps({"count": count}) + "\n").encode())
            except OSError:
                pass
            finally:
                conn.close()
        else:
            conn.close()

    def pending_count(self):
        with self._lock:
            return len(self._pending)

    def freeze(self, epoch):
        with self._lock:
            if epoch not in self._frozen:
                self._frozen[epoch] = self._pending
                self._pending = []
            return len(self._frozen[epoch])

    def release(self, epoch, assignments):
        with self._lock:
            if epoch in self._released:
                return
            self._released.add(epoch)
            held = list(self._frozen.get(epoch, ()))
        for (conn, _), asg in zip(held, assignments):
            try:
                conn.sendall((json.dumps(asg) + "\n").encode())
            except OSError:
                pass
            finally:
                conn.close()


_door = None


def _ensure_door():
    """Open the door on rank 0 when parole is on (idempotent): at init
    and after every re-formation."""
    global _door
    if (_door is None and _rejoin_port() and basics.is_initialized()
            and basics.rank() == 0):
        _door = _ParoleDoor(_rejoin_port())
    return _door


# The commit-time poll is a collective, so its name must match on every
# rank, a joiner's fresh counter included: (epoch, n) restarts n at each
# epoch transition, which every member sees together.
_rejoin_poll_state = {"epoch": None, "n": 0}


def _poll_rejoiners():
    """The commit-time scale-up check (driverless only): rank 0's count
    of joiners at the door, MAX-allreduced so that every rank raises (or
    not) at the same commit. At size 1 it is local and runs no
    collective; 0 without a door or with ``HOROVOD_REJOIN_POLL=0``."""
    if _is_elastic() or not _rejoin_port() or not basics.is_initialized():
        return 0
    if os.environ.get("HOROVOD_REJOIN_POLL", "1") == "0":
        return 0
    door = _ensure_door()
    local = door.pending_count() if door is not None else 0
    if basics.size() == 1:
        return local
    from horovod_tpu_torch.torch import mpi_ops

    state, epoch = _rejoin_poll_state, basics.epoch()
    if state["epoch"] != epoch:
        state["epoch"], state["n"] = epoch, 0
    name = f"elastic.rejoin_poll.{epoch}.{state['n']}"
    state["n"] += 1
    out = mpi_ops.allreduce(torch.tensor([local], dtype=torch.int64),
                            name=name, op=mpi_ops.Max)
    return int(out[0])


def _freeze_joiners(target_epoch):
    """The joiner count frozen for ``target_epoch``, the same on every
    survivor (rank 0 asks its door in-process, the rest over TCP); its
    latency is the ``parole_freeze`` control phase."""
    t0 = time.monotonic()
    try:
        return _freeze_joiners_inner(target_epoch)
    finally:
        REGISTRY.record_phase("parole_freeze",
                              int((time.monotonic() - t0) * 1e6))


def _freeze_joiners_inner(target_epoch):
    if _is_elastic() or not _rejoin_port():
        return 0
    if basics.rank() == 0:
        door = _ensure_door()
        return door.freeze(target_epoch) if door is not None else 0
    # The count must equal rank 0's, or the re-formation's world sizes
    # disagree: retry a transient failure; a door that stays shut (rank
    # 0's process gone) means no joiners, and the full re-init that
    # follows is the right recovery there anyway.
    for attempt in range(3):
        try:
            with socket.create_connection(
                    (_rejoin_addr(), _rejoin_port()), timeout=10) as s:
                s.sendall((json.dumps(
                    {"op": "poll", "epoch": target_epoch}) + "\n").encode())
                s.settimeout(10)
                line = s.makefile("r").readline()
            return int(json.loads(line)["count"])
        except (OSError, ValueError, KeyError):
            if attempt == 2:
                warnings.warn(
                    "rejoin-door poll failed 3x; assuming 0 joiners for "
                    f"epoch {target_epoch} (world-size agreement may "
                    "degrade to the full re-init fallback)",
                    RuntimeWarning, stacklevel=2)
                return 0
            time.sleep(0.2 * (attempt + 1))
    return 0


def rejoin(addr=None, port=None, timeout=None, device=None):
    """The parole door's joiner side: enter a driverless elastic job as
    a fresh process (a host back after its rank was fenced out, or one
    more to scale up). Knocks at the survivors' door, waits until an
    epoch transition absorbs it, then opens the lane (on ``device``, as
    ``basics.init``: None is the card) straight into the grown world at
    the assigned rank and epoch. Returns the assignment. The training
    state comes with the first ``state.sync()`` of ``hvd.elastic.run``:
    rank 0's last commit."""
    addr = addr or _rejoin_addr()
    port = int(port or _rejoin_port())
    if not port:
        raise ValueError(
            "rejoin needs HOROVOD_REJOIN_PORT (or port=): the door the "
            "survivors' rank 0 keeps open")
    if timeout is None:
        timeout = float(os.environ.get("HOROVOD_START_TIMEOUT", 60))
    s = socket.create_connection((addr, port), timeout=timeout)
    try:
        s.sendall((json.dumps({"op": "hello", "worker": _worker_id(),
                               "host": socket.gethostname()})
                   + "\n").encode())
        s.settimeout(timeout)
        line = s.makefile("r").readline()
    finally:
        s.close()
    if not line:
        raise RuntimeError(
            "rejoin door closed without an assignment (no epoch "
            "transition absorbed this worker within the timeout)")
    asg = json.loads(line)
    os.environ.update({
        "HOROVOD_RANK": str(asg["rank"]),
        "HOROVOD_SIZE": str(asg["size"]),
        "HOROVOD_LOCAL_RANK": str(asg["rank"]),
        "HOROVOD_LOCAL_SIZE": str(asg["size"]),
        "HOROVOD_CROSS_RANK": "0",
        "HOROVOD_CROSS_SIZE": "1",
        "HOROVOD_CONTROLLER_ADDR": asg["controller_addr"],
        "HOROVOD_CONTROLLER_PORT": str(asg["controller_port"]),
    })
    basics.init(device, epoch=asg["epoch"])
    return asg


def shrink(victims):
    """Voluntary shrink (the autoscaler's scale-down leg): re-form the
    world without ``victims`` at the next epoch, no fault; the
    negotiated shutdown drains every collective in flight. Collective:
    every rank, victims included, calls it at the same point with the
    same set. A victim shuts its lane down and returns False (it may
    exit, or knock at the door later with :func:`rejoin`); a survivor
    re-forms, runs the post-reset hooks and returns True."""
    victims = {int(v) for v in victims}
    size, rank = basics.size(), basics.rank()
    if any(v < 0 or v >= size for v in victims) or len(victims) >= size:
        raise ValueError(
            f"shrink(victims={sorted(victims)}): victims must be a "
            f"proper subset of range({size})")
    if rank in victims:
        basics.shutdown()
        return False
    basics.reinit([r for r in range(size) if r not in victims],
                  basics.epoch() + 1)
    _ensure_door()
    _run_post_reset_hooks()
    return True


def init(device=None, epoch=None):
    """Open the lane; under the elastic driver, first register and take
    this epoch's rank assignment, exported as the ``HOROVOD_*`` layout.
    Without a driver and without ``HOROVOD_RANK``, a job that a bare
    ``mpirun`` or ``srun`` started takes its layout and endpoint from
    the MPI world (``mpi_bootstrap.py``); ``HOROVOD_CONTROLLER=mpi``
    raises (ROADMAP.md L9b). ``device`` as ``basics.init`` (None: the
    card); ``epoch`` applies without a driver (the driver numbers its
    own). Without a driver, rank 0 opens the parole door when
    ``HOROVOD_REJOIN_PORT`` is set."""
    if not _is_elastic():
        # A bare mpirun/srun (no launcher's HOROVOD_RANK): the layout and
        # rank 0's endpoint come from the MPI world (L9's bootstrap).
        from horovod_tpu_torch.common import mpi_bootstrap

        mpi_bootstrap.check_controller()
        mpi_bootstrap.maybe_bootstrap_from_mpi()
        basics.init(device, epoch=epoch)
        _ensure_door()
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
    """Re-form in place at the next epoch over the survivors of a fault
    (:func:`survivors`, at the fault's epoch + 1) or, on a healthy lane,
    over every rank, plus the joiners frozen at the door, who take the
    top ranks. True when this path applied; False defers to the full
    re-init (a healthy lane with no joiner, no agreed survivor set, or a
    re-formation that failed, with a warning). A rank its peers declared
    dead gets a terminal ``RuntimeError`` (not a ``HorovodInternalError``:
    it must leave the retry loop; it may come back through the door)."""
    if not basics.is_initialized():
        return False
    faulted = basics.loop_failed()
    if faulted:
        alive = survivors()
        if alive is None:
            return False
        fault = basics.last_fault()
        old_rank = basics.rank()
        if old_rank not in alive:
            raise RuntimeError(
                f"rank {old_rank} was declared dead by its peers (fault: "
                f"{fault.get('reason')}); cannot rejoin epoch "
                f"{fault.get('epoch', 0) + 1} in-process: restart and use "
                "hvd.elastic.rejoin() (the parole door)")
        target = int(fault.get("epoch", 0)) + 1
    else:
        alive = list(range(basics.size()))
        target = basics.epoch() + 1
    joiners = _freeze_joiners(target)
    if not faulted and joiners == 0:
        return False
    world = alive + [-1] * joiners
    if joiners and basics.rank() == 0 and _door is not None:
        # Out before the blocking re-formation, so that the joiners can
        # reach its rendezvous.
        _door.release(target, [
            {"rank": len(alive) + i, "size": len(world), "epoch": target,
             "controller_addr": os.environ.get("HOROVOD_CONTROLLER_ADDR",
                                               "127.0.0.1"),
             "controller_port": int(os.environ.get(
                 "HOROVOD_CONTROLLER_PORT", 29500))}
            for i in range(joiners)])
    try:
        basics.reinit(world, target)
    except RuntimeError as e:
        warnings.warn(f"in-place re-formation failed ({e}); falling back "
                      "to full re-initialization", RuntimeWarning,
                      stacklevel=2)
        return False
    return True


def reset():
    """Tear down and re-form (an elastic epoch transition): the driver's
    re-rendezvous, else a re-formation in place over the survivors and
    the door's joiners, else ``shutdown()`` and ``init()`` of the same
    world at the next epoch; then the post-reset hooks."""
    # The lane re-opens on the device it ran on (None, the card, when
    # none is open), a failed re-formation's fallback included.
    device = None
    if basics.is_initialized():
        device = "cpu" if basics.device() is None else "cuda"
    if not _is_elastic() and _reset_driverless():
        _ensure_door()
        _run_post_reset_hooks()
        return
    fault = basics.last_fault()
    target = basics.epoch() + 1
    basics.shutdown()
    init(device, epoch=None if _is_elastic() else target)
    lost = fault is not None and not fault["recovered"]
    REGISTRY.record_reset(lost, len(fault["ranks"]) if lost else 0)
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
        # Driverless scale-up: a joiner at the door interrupts every rank
        # at the same commit (the poll is a collective); reset() grows
        # the world in place.
        if _poll_rejoiners() > 0:
            raise HostsUpdatedInterrupt(False)

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
