"""init, shutdown and the rank layout of the port's Horovod lane.

Counterpart of ``horovod_tpu/common/basics.py`` (``HorovodBasics`` over
the core's C API) and of the core's init (``csrc/operations.cc:1452``).
It reads the same environment: ``HOROVOD_RANK``/``SIZE`` (default 0/1),
``HOROVOD_LOCAL_RANK``/``LOCAL_SIZE`` (default rank/size),
``HOROVOD_CROSS_RANK``/``CROSS_SIZE`` (default 0/1), the launchers'
variables when those are unset (mpirun, srun, jsrun),
``HOROVOD_CONTROLLER_ADDR``/``PORT`` (default 127.0.0.1:29500), and the
knobs ``HOROVOD_FUSION_THRESHOLD`` (bytes, default 64 MiB),
``HOROVOD_CYCLE_TIME`` (ms, default 1.0), ``HOROVOD_CACHE_CAPACITY``
(response cache positions, default 1024, 0 disables),
``HOROVOD_STALL_CHECK_TIME`` (s, default 60) and
``HOROVOD_STALL_CHECK_DISABLE``, ``HOROVOD_TIMELINE`` (a path: rank 0
writes the timeline from init on) and ``HOROVOD_TIMELINE_MARK_CYCLES``,
and ``HOROVOD_DEBUG_PORT`` (rank r serves ``telemetry/debug_server.py``
on that port + r; 0 binds an ephemeral port).

The lane's instruments are read here: :func:`metrics` (the registry's
snapshot), :func:`metrics_reset`, :func:`events` and
:func:`events_drain` (the event ring), :func:`start_timeline` and
:func:`stop_timeline`, :func:`step_mark`, :func:`debug_port` and
:func:`response_cache_stats`.

``init()`` opens ``torch.distributed`` with a gloo group for control, a
gloo group for CPU tensors and, when the lane runs on the card, an NCCL
group on ``cuda:{local_rank}``, then starts the lane thread. Its
rendezvous is one ``TCPStore`` at the controller address, kept for the
process's life (rank 0 hosts it; a second bind of the port would
fail), each membership epoch under its own ``PrefixStore``
(``hvd/epoch<e>``), as torchelastic does; a world of one needs no
rendezvous and takes an in-process store. The device rule is the
port's (``_device.py``): with no ``device`` and no CUDA, ``init``
raises; after ``init(device="cpu")`` a CUDA tensor raises, and a CUDA
tensor never travels over gloo or through host memory, nor a CPU
tensor over NCCL.

The core's epoch and fault surface (``horovod_tpu/common/basics.py:635``
to ``:700``): :func:`epoch`, :func:`last_fault`, :func:`reinit` (the
world re-formed in place over surviving ranks, no process restart),
:func:`set_fault_inject` and :func:`set_fault_inject_spec`.
:func:`shutdown` and :func:`reinit` tear the lane down whatever state it
is in: a failed lane skips the negotiation, and its NCCL communicators
are aborted rather than destroyed behind a collective that will never
finish. Without a driver, rank 0 hosts the store and must survive, as
in the reference (``horovod_tpu/common/elastic.py:457``). After a
shrink the layout is flat (one host: ``local_*`` = the new rank and
size, ``cross_*`` 0 and 1; the hierarchical split is ROADMAP.md L7), and
each rank keeps the card it had.
"""

import atexit
import datetime
import os
import sys
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.common import events as _events
from horovod_tpu_torch.common.data_plane import DataPlane
from horovod_tpu_torch.common.metrics import REGISTRY, now_us
from horovod_tpu_torch.common.operations import (
    Runtime,
    SetGroups,
    parse_fault_spec,
)

_TIMEOUT = datetime.timedelta(seconds=600)

# Launcher fallbacks, HOROVOD_* first (horovod_tpu/common/basics.py:251).
_ENV_FALLBACKS = {
    "HOROVOD_RANK": ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
                     "SLURM_PROCID", "JSM_NAMESPACE_RANK"),
    "HOROVOD_SIZE": ("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS",
                     "JSM_NAMESPACE_SIZE"),
    "HOROVOD_LOCAL_RANK": ("OMPI_COMM_WORLD_LOCAL_RANK", "PMI_LOCAL_RANK",
                           "SLURM_LOCALID", "JSM_NAMESPACE_LOCAL_RANK"),
    "HOROVOD_LOCAL_SIZE": ("OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_LOCAL_SIZE",
                           "SLURM_TASKS_PER_NODE"),
}


def _env_int(name, default):
    val = os.environ.get(name)
    if val:
        return int(val)
    for src in _ENV_FALLBACKS.get(name, ()):
        val = os.environ.get(src)
        if val:
            # SLURM_TASKS_PER_NODE can read '4(x2)': take the number.
            return int(val.split("(")[0].split(",")[0])
    return default


class _Lane:
    """What init() opened; shutdown() closes it."""

    def __init__(self, runtime, layout, device):
        self.runtime = runtime
        self.layout = layout
        self.device = device


_lock = threading.Lock()
_lane = None
_store = None        # ((addr, port, is_master), TCPStore) for the process
_epoch = 0
_last_fault = None   # the newest fault record, kept across a reinit


def init(device=None, epoch=None):
    """Open the lane. ``device`` None means the card (``cuda`` must be
    available), ``"cpu"`` a gloo-only lane. ``epoch`` is the membership
    epoch to open at: None is 0, or under the elastic driver its epoch
    less one (every worker of an epoch names the same one); an elastic
    ``reset()`` passes the next. A second call is a no-op."""
    global _last_fault
    with _lock:
        if _lane is not None:
            return
        dev = resolve_device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"the lane runs on cuda or cpu, not {dev}")
        rank = _env_int("HOROVOD_RANK", 0)
        size = _env_int("HOROVOD_SIZE", 1)
        layout = dict(rank=rank, size=size,
                      local_rank=_env_int("HOROVOD_LOCAL_RANK", rank),
                      local_size=_env_int("HOROVOD_LOCAL_SIZE", size),
                      cross_rank=_env_int("HOROVOD_CROSS_RANK", 0),
                      cross_size=_env_int("HOROVOD_CROSS_SIZE", 1))
        card = (torch.device("cuda", layout["local_rank"])
                if dev.type == "cuda" else None)
        if epoch is None:
            driver = os.environ.get("HOROVOD_ELASTIC_EPOCH") \
                if os.environ.get("HOROVOD_RDZV_ADDR") else None
            epoch = max(int(driver) - 1, 0) if driver else 0
        _open(layout, card, int(epoch), _fault_inject_from_env())
        _last_fault = None
    if os.environ.get("HOROVOD_DEBUG_PORT"):
        try:
            from horovod_tpu_torch.telemetry import debug_server

            debug_server.maybe_start(rank)
        except Exception as e:  # noqa: BLE001 — never fatal
            print(f"hvdtpu debug server not started: {e}", file=sys.stderr)


def _fault_inject_from_env():
    spec = os.environ.get("HOROVOD_FAULT_INJECT")
    if not spec:
        return None
    parsed = parse_fault_spec(spec)   # raises on the wire's actions (L8)
    if parsed is None:
        print(f"hvd-torch: ignoring malformed HOROVOD_FAULT_INJECT={spec} "
              "(expected <rank>:<op>[:kill|delay:<ms>])", file=sys.stderr)
    return parsed


def _base_store(rank, size):
    """The process's TCPStore for this controller address, made once."""
    global _store
    key = (os.environ.get("HOROVOD_CONTROLLER_ADDR") or "127.0.0.1",
           _env_int("HOROVOD_CONTROLLER_PORT", 29500), rank == 0)
    if _store is None or _store[0] != key:
        _store = (key, dist.TCPStore(key[0], key[1], size,
                                     is_master=key[2], timeout=_TIMEOUT))
    return _store[1]


def _open(layout, card, epoch, fault_inject):
    """Open torch.distributed and the lane at ``epoch``; caller holds
    ``_lock``."""
    global _lane, _epoch
    rank, size = layout["rank"], layout["size"]
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is already initialized: hvd.init() opens "
            "its own process groups")
    t0 = now_us()
    if size == 1:
        store, fault_store = dist.HashStore(), None
    else:
        base = _base_store(rank, size)
        store = dist.PrefixStore(f"hvd/epoch{epoch}", base)
        fault_store = dist.PrefixStore(f"hvd/epoch{epoch}/fault", base)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=size, timeout=_TIMEOUT)
    try:
        runtime = _open_lane(rank, size, card, epoch, fault_store,
                             fault_inject)
    except BaseException:
        dist.destroy_process_group()
        raise
    REGISTRY.record_phase("rendezvous", now_us() - t0)
    timeline = os.environ.get("HOROVOD_TIMELINE")
    if timeline and rank == 0:
        # One file per job: the ranks share the path, so only the
        # coordinator writes it (hvd.start_timeline works on any rank).
        runtime.timeline.start(timeline, rank, _mark_cycles())
    runtime.start()
    _lane = _Lane(runtime, layout, card)
    _epoch = epoch


def _mark_cycles():
    return _env_int("HOROVOD_TIMELINE_MARK_CYCLES", 0) != 0


def _open_lane(rank, size, card, epoch, store, fault_inject):
    """The process groups of the global set and the lane's runtime."""

    def make_groups(ranks):
        ranks = sorted(int(r) for r in ranks)
        groups = {"cpu": dist.new_group(ranks, timeout=_TIMEOUT,
                                        backend="gloo")}
        if card is not None:
            groups["cuda"] = dist.new_group(ranks, timeout=_TIMEOUT,
                                            backend="nccl")
        return groups

    world = list(range(size))
    groups = make_groups(world)
    if card is not None:
        # Open the communicator now, so that a failure shows at init.
        t0 = now_us()
        with torch.cuda.device(card):
            probe = torch.zeros(1, device=card)
            dist.all_reduce(probe, group=groups["cuda"])
            torch.cuda.synchronize(card)
        REGISTRY.record_phase("nccl_init", now_us() - t0)
    threshold = _env_int("HOROVOD_FUSION_THRESHOLD", 64 << 20)
    stall_s = None if _env_int("HOROVOD_STALL_CHECK_DISABLE", 0) else float(
        os.environ.get("HOROVOD_STALL_CHECK_TIME") or 60.0)
    return Runtime(rank, size, dist.group.WORLD, DataPlane(card, threshold),
                   {0: SetGroups(world, rank, groups)}, threshold,
                   float(os.environ.get("HOROVOD_CYCLE_TIME") or 1.0),
                   make_groups,
                   cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY", 1024),
                   stall_warning_s=stall_s, epoch=epoch, store=store,
                   fault_inject=fault_inject)


def _close(lane):
    """Tear the lane and its process groups down, whatever state it is
    in: a running lane negotiates its shutdown first (every rank must
    call); a failed one, or one whose negotiation did not end, has its
    NCCL communicators aborted rather than waited for."""
    rt = lane.runtime
    t0 = now_us()
    ended = rt.failure is None and rt.shutdown(_TIMEOUT.total_seconds())
    rt.stop()
    rt.timeline.stop()
    if not ended:
        for s in rt.sets.values():
            if "cuda" in s.groups:
                try:
                    s.groups["cuda"].abort()
                except Exception as e:  # noqa: BLE001 — best effort
                    print(f"hvd-torch: NCCL abort failed: {e}",
                          file=sys.stderr)
    # Drop the lane's references: a gloo context closes its sockets when
    # its last one goes, which ends a peer's collective waiting on it.
    rt.sets.clear()
    rt.control.group = None
    dist.destroy_process_group()
    REGISTRY.record_phase("shutdown", now_us() - t0)


def shutdown():
    """Negotiated while the lane runs: returns once every rank has
    called it. A failed lane (a lost peer) is torn down at once. Either
    way the process groups close and ``init()`` may open them again. A
    no-op when not initialized."""
    global _lane
    with _lock:
        lane, _lane = _lane, None
    if lane is None:
        return
    server = sys.modules.get("horovod_tpu_torch.telemetry.debug_server")
    if server is not None:
        server.stop()
    _close(lane)


def reinit(ranks, epoch):
    """Re-form the world in place over surviving OLD ranks at ``epoch``
    (``basics.py:665``): no process restart; this rank's new rank is its
    index in ``ranks``. Collective among the members. The old groups are
    aborted (a running lane first drains by its negotiated shutdown, so
    every old rank must call), new ones open on the epoch's prefix of
    the same store, and the lane reopens (controller, fusion buffer,
    response cache), the fault trigger cleared. Joiner slots (``-1``)
    are the parole door's (ROADMAP.md L5b)."""
    global _lane, _last_fault
    ranks, epoch = [int(r) for r in ranks], int(epoch)
    with _lock:
        lane = _lane
        old_size = lane.layout["size"] if lane is not None else 0
        if lane is None or not ranks or len(set(ranks)) != len(ranks) or \
                any(r >= old_size or r < -1 for r in ranks) or \
                epoch <= _epoch:
            raise RuntimeError(
                f"reinit(ranks={ranks}, epoch={epoch}) failed: not "
                "initialized / bad ranks / epoch not past the current")
        if -1 in ranks:
            raise NotImplementedError(
                "reinit with joiner slots (-1): the parole door is not "
                "ported yet (ROADMAP.md L5b)")
        old_rank = lane.layout["rank"]
        if old_rank not in ranks:
            raise RuntimeError(
                f"reinit(ranks={ranks}, epoch={epoch}) failed: this rank "
                f"({old_rank}) is not in the survivor set")
        t0 = now_us()
        fault = lane.runtime.fault
        old_epoch = _epoch
        _events.record("reinit_begin", len(ranks), 0, epoch)
        _lane = None
        _close(lane)
        rank, size = ranks.index(old_rank), len(ranks)
        layout = dict(rank=rank, size=size, local_rank=rank,
                      local_size=size, cross_rank=0, cross_size=1)
        try:
            _open(layout, lane.device, epoch, None)
        except Exception as e:
            _events.record("reinit_end", -4, size, epoch)
            raise RuntimeError(
                f"reinit(ranks={ranks}, epoch={epoch}) failed: "
                f"re-formation rendezvous failed ({e})") from e
        _events.record("reinit_end", 0, size, epoch)
        _events.record("epoch", 0, 0, epoch, old_epoch)
        if fault is not None:
            _last_fault = dict(fault, recovered=True)
        REGISTRY.record_reset(len(fault["ranks"]) if fault else 0)
        REGISTRY.record_phase("reinit", now_us() - t0)


@atexit.register
def _shutdown_at_exit():
    # A process that never called shutdown() still takes part in the
    # negotiated one, so that no peer is left waiting.
    shutdown()


def epoch():
    """The membership epoch: 0 at a fresh init, bumped by every
    re-formation (:func:`reinit`, an elastic reset)."""
    return _epoch


def last_fault():
    """The newest fault record, or None if no collective has failed on
    a lost peer: ``{"epoch", "ranks", "certain", "reason", "detect_ms",
    "recovered", "kind"}``, ranks numbered as in the epoch that faulted;
    ``certain`` when every rank read the same dead set (the store's
    check-in)."""
    current = _lane
    rec = current.runtime.fault if current is not None else None
    rec = rec if rec is not None else _last_fault
    return None if rec is None else dict(rec, ranks=list(rec["ranks"]))


def set_fault_inject(rank, op_index):
    """Arm the trigger: ``rank`` SIGKILLs itself at the top of its
    ``op_index``-th executed collective (``HOROVOD_FAULT_INJECT``'s
    programmatic twin); a negative ``rank`` disarms."""
    rt = _require_lane("set_fault_inject")
    rt.fault_inject = None if rank < 0 else (int(rank), int(op_index),
                                             "kill", 0)


def set_fault_inject_spec(spec):
    """Arm the trigger from a ``HOROVOD_FAULT_INJECT`` spec; raises
    ``ValueError`` on a malformed one (the trigger stays disarmed) and
    on the wire's actions (ROADMAP.md L8)."""
    rt = _require_lane("set_fault_inject_spec")
    parsed = parse_fault_spec(str(spec))
    if parsed is None:
        raise ValueError(f"malformed fault-injection spec {spec!r} "
                         "(expected <rank>:<op>[:kill|delay:<ms>])")
    rt.fault_inject = parsed


def _require_lane(what):
    current = _lane
    if current is None:
        raise RuntimeError(f"{what} requires hvd.init()")
    return current.runtime


def is_initialized():
    return _lane is not None


def lane():
    """The open lane's runtime; raises before init()."""
    current = _lane
    if current is None:
        raise ValueError("Horovod is not initialized: call hvd.init() first")
    return current.runtime


def device():
    """The card this rank's lane runs CUDA tensors on, or None."""
    current = _lane
    return None if current is None else current.device


def _layout(key):
    current = _lane
    if current is None:
        raise ValueError(f"hvd.{key}() called before hvd.init(); call "
                         "hvd.init() first")
    return current.layout[key]


def rank():
    return _layout("rank")


def size():
    return _layout("size")


def local_rank():
    return _layout("local_rank")


def local_size():
    return _layout("local_size")


def cross_rank():
    return _layout("cross_rank")


def cross_size():
    return _layout("cross_size")


def loop_failed():
    """Whether the lane stopped on a failed collective."""
    current = _lane
    return current is not None and current.runtime.failure is not None


# ---- the instruments ----------------------------------------------------


def start_timeline(file_path, mark_cycles=False):
    """Start (or restart) this rank's timeline at ``file_path``; cycle
    marks with ``mark_cycles`` or ``HOROVOD_TIMELINE_MARK_CYCLES``."""
    current = _lane
    if current is None:
        raise ValueError(f"could not start timeline at {file_path!r} "
                         "(is Horovod initialized and the path writable?)")
    current.runtime.timeline.start(file_path, current.layout["rank"],
                                   bool(mark_cycles) or _mark_cycles())


def stop_timeline():
    """Stop the timeline and close its file (valid JSON either way)."""
    current = _lane
    if current is not None:
        current.runtime.timeline.stop()


def response_cache_stats():
    """(hits, misses, entries) of this rank's response cache."""
    c = lane().cache
    return c.hits, c.misses, c.entries


def metrics():
    """One snapshot of the metrics registry (``metrics.py`` lists its
    sections); before init it carries ``initialized: False``."""
    current = _lane
    if current is None:
        return REGISTRY.snapshot(epoch=_epoch, last_fault=last_fault())
    rt = current.runtime
    c = rt.cache
    return REGISTRY.snapshot(
        initialized=True, rank=rt.rank, size=rt.size,
        fusion_threshold_bytes=rt.fusion_threshold,
        cycle_time_ms=rt.cycle_time_ms,
        cache=(c.hits, c.misses, c.entries, c.hit_bytes), epoch=_epoch,
        last_fault=last_fault())


def metrics_reset():
    """Zero every counter and histogram of the registry."""
    REGISTRY.reset()


def events(last_n=0):
    """The newest ``last_n`` events of the ring (0: all it holds), as
    dicts; does not consume them."""
    return _events.peek(int(last_n))


def events_drain():
    """Every event recorded since the last drain, consumed."""
    return _events.drain()


_step = dict(open=-1, count=0, begin_us=0)


def step_mark(begin=True):
    """Mark a training-step boundary: ``begin`` closes an open step
    (``step_end``) and opens the next (``step_begin``), returning its
    id; ``begin=False`` closes the open step and returns its id, or -1."""
    now = now_us()
    open_id = _step["open"]
    _step["open"] = -1
    if open_id >= 0:
        _events.record("step_end", c=open_id, d=now - _step["begin_us"])
    if not begin:
        return open_id
    _step["count"] += 1
    _step["open"], _step["begin_us"] = _step["count"], now
    _events.record("step_begin", c=_step["count"])
    return _step["count"]


def debug_port():
    """The port this rank's debug server listens on, or None."""
    server = sys.modules.get("horovod_tpu_torch.telemetry.debug_server")
    return None if server is None else server.debug_port()
