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
``HOROVOD_DEBUG_PORT`` (rank r serves ``telemetry/debug_server.py``
on that port + r; 0 binds an ephemeral port), and the autotuner's
``HOROVOD_AUTOTUNE`` (1: rank 0 tunes the fusion threshold, the cycle
time and, where they have a choice, the wire codec and the hierarchy
split), ``HOROVOD_AUTOTUNE_LOG``, ``_STEPS``, ``_WINDOW_BYTES`` and
``_WINDOW_CYCLES`` (``parameter_manager.py``), read by
:func:`_init_autotune` at every init and re-formation, so that a world
that grew or shrank tunes again from the start with a fresh log.

The cross-plane knobs (``csrc/operations.cc:1462-1505``), read at every
open: ``HOROVOD_CROSS_PLANE`` (``auto|ici|ring|hier``, case-insensitive;
unset, ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` means ``hier``; an unknown
value warns and means ``auto``), ``HOROVOD_CROSS_PLANE_COMPRESSION``
(1: bf16 on the hierarchical allreduce's cross hop alone) and
``HOROVOD_WIRE_COMPRESSION`` (``0``/``1``/``2``, ``bf16``, ``int8``: the
codec of f32 Sum and Average allreduces and reducescatters,
``data_plane.py``). In modes ``auto`` and ``hier`` a first ``init`` at
epoch 0 runs the reference's eligibility probe
(``operations.cc:1575-1615``): one MIN allreduce of ``(local_size,
-local_size, host-major)`` on the gloo group (and ``-autotune``, see
below); a homogeneous host-major layout of more than one rank a slice
on more than one slice sets the
split to ``local_size``, anything else runs flat, and an explicit
``hier`` then warns on rank 0 (a world of one warns without the probe).
A joiner's ``init`` (epoch > 0) and a re-formation never probe: both go
through :func:`_open`, and a probe that one side ran and the other did
not would hang the lane. The lane opens the slices' groups (gloo, and
NCCL on the card) for the split, on every rank in one order; when some
rank set ``HOROVOD_AUTOTUNE`` (the probe's fourth entry, kept for the
re-formations), for every smaller divisor of ``local_size`` that tiles
the world too, the autotuner's grid.

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
rendezvous and takes an in-process store, unless the parole door is on
(``HOROVOD_REJOIN_PORT``, ``elastic.py``): then rank 0 hosts the store
at size 1 too, so that a joiner can reach the grown world's. A joiner
opens with ``init(epoch=E)`` straight into the survivors' epoch prefix.
A world's first rendezvous waits at most ``HOROVOD_START_TIMEOUT``
seconds (default 60, the reference core's) for every rank, and then
raises a ``TimeoutError`` naming the wait that ran out: making the
store (rank 0 for every rank to connect, a worker to reach rank 0) and
the epoch's check-in (:func:`_await_world`). The store's own bound,
which every later ``get``/``wait`` keeps, and the process groups' stay
at 600 s.
The device rule is the
port's (``_device.py``): with no ``device`` and no CUDA, ``init``
raises; after ``init(device="cpu")`` a CUDA tensor raises, and a CUDA
tensor never travels over gloo or through host memory, nor a CPU
tensor over NCCL.

The core's epoch and fault surface (``horovod_tpu/common/basics.py:635``
to ``:700``): :func:`epoch`, :func:`last_fault`, :func:`reinit` (the
world re-formed in place over surviving ranks and joiner slots, no
process restart),
:func:`set_fault_inject` and :func:`set_fault_inject_spec`.
:func:`shutdown` and :func:`reinit` tear the lane down whatever state it
is in: a failed lane skips the negotiation, and its NCCL communicators
are aborted rather than destroyed behind a collective that will never
finish. Without a driver, rank 0 hosts the store and must survive, as
in the reference (``horovod_tpu/common/elastic.py:457``). A
re-formation re-derives the slice layout from the survivors' old hosts
(``operations.cc:1837-1880``): when the old world was hierarchical and
the sorted survivors keep every remaining host at one count L > 1 on
more than one host, the new world has ``local_size`` L and split L;
otherwise, and for a world with joiner slots, it is flat (one host:
``local_*`` = the new rank and size, ``cross_*`` 0 and 1). Each rank
keeps the card it had.
"""

import atexit
import datetime
import os
import re
import sys
import threading
import time

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
from horovod_tpu_torch.common.parameter_manager import ParameterManager
from horovod_tpu_torch.ops.wire_codec import CODEC_NAMES

_TIMEOUT = datetime.timedelta(seconds=600)
#: HOROVOD_CROSS_PLANE mode names in the reference's order.
CROSS_PLANE_MODES = ("auto", "ici", "ring", "hier")

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


def _env_strtoll(name, default=0):
    """``EnvInt64``: ``strtoll`` of the variable's leading digits (0 when
    there are none), ``default`` when it is unset."""
    val = os.environ.get(name)
    if val is None:
        return default
    m = re.match(r"\s*[+-]?\d+", val)
    return int(m.group()) if m else 0


def _cross_plane_mode():
    mode = (os.environ.get("HOROVOD_CROSS_PLANE") or "").lower()
    if not mode:
        mode = "hier" if _env_strtoll("HOROVOD_HIERARCHICAL_ALLREDUCE") \
            else "auto"
    if mode not in CROSS_PLANE_MODES:
        print(f"hvd-torch: ignoring unknown HOROVOD_CROSS_PLANE={mode} "
              "(expected auto|ici|ring|hier)", file=sys.stderr, flush=True)
        mode = "auto"
    return mode


def _wire_codec_env():
    """``HOROVOD_WIRE_COMPRESSION``: 0/1/2 or ``bf16``/``int8``; any other
    number means off."""
    comp = os.environ.get("HOROVOD_WIRE_COMPRESSION", "0")
    if comp in ("bf16", "int8"):
        return 1 if comp == "bf16" else 2
    mode = _env_strtoll("HOROVOD_WIRE_COMPRESSION")
    return mode if mode in (0, 1, 2) else 0


class _Lane:
    """What init() opened; shutdown() closes it."""

    def __init__(self, runtime, layout, device, cross_plane):
        self.runtime = runtime
        self.layout = layout
        self.device = device
        self.cross_plane = cross_plane


_lock = threading.Lock()
_lane = None
_store = None        # ((addr, port, is_master), TCPStore) for the process
_epoch = 0
_last_fault = None   # the newest fault record, kept across a reinit
_tune_splits = False  # the probe's verdict: open the tuner's every split


def card_index(local_rank):
    """The card a process opens its lane on: its elastic driver's spawn
    slot (``HOROVOD_ELASTIC_SLOT``, fixed for the process's life), else
    ``local_rank``. Under the driver a survivor's local rank can change
    at a new epoch (workers are numbered by spawn age) while its state
    stays on the card it ran on; the slot keeps it there."""
    slot = os.environ.get("HOROVOD_ELASTIC_SLOT")
    return int(slot) if slot not in (None, "") else int(local_rank)


def init(device=None, epoch=None):
    """Open the lane. ``device`` None means the card (``cuda`` must be
    available), ``"cpu"`` a gloo-only lane. On the card the lane takes
    ``cuda:{card_index(local_rank)}`` (the elastic driver's spawn slot,
    else the local rank) and makes it the process's current device.
    ``epoch`` is the membership
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
        card = (torch.device("cuda", card_index(layout["local_rank"]))
                if dev.type == "cuda" else None)
        if card is not None:
            # "cuda" now means this rank's card, as an upstream script's
            # torch.cuda.set_device(hvd.local_rank()) makes it.
            torch.cuda.set_device(card)
        if epoch is None:
            driver = os.environ.get("HOROVOD_ELASTIC_EPOCH") \
                if os.environ.get("HOROVOD_RDZV_ADDR") else None
            epoch = max(int(driver) - 1, 0) if driver else 0
        # Only a first open probes the layout: a joiner opens at its
        # survivors' epoch, which their re-formation reached unprobed.
        _open(layout, card, int(epoch), _fault_inject_from_env(),
              probe=int(epoch) == 0)
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


def _start_timeout():
    """``HOROVOD_START_TIMEOUT`` (seconds, default 60, as the reference
    core's ``csrc/operations.cc:376``): how long a first rendezvous
    waits for the world."""
    return datetime.timedelta(
        seconds=float(os.environ.get("HOROVOD_START_TIMEOUT") or 60))


def _start_timed_out(what, start, exc):
    return TimeoutError(
        f"HOROVOD_START_TIMEOUT ({start.total_seconds():g} s) ran out "
        f"{what}: {exc}")


def _base_store(rank, size):
    """The process's TCPStore for this controller address, made once.
    Making it waits for the world, bounded by ``HOROVOD_START_TIMEOUT``:
    rank 0 for every rank to connect, a worker to reach rank 0. Then the
    store's own bound goes back to ``_TIMEOUT``, which every later
    ``get``/``wait`` on it keeps (the fault check-in, the door)."""
    global _store
    key = (os.environ.get("HOROVOD_CONTROLLER_ADDR") or "127.0.0.1",
           _env_int("HOROVOD_CONTROLLER_PORT", 29500), rank == 0)
    if _store is None or _store[0] != key:
        start = _start_timeout()
        t0 = time.monotonic()
        try:
            store = dist.TCPStore(key[0], key[1], size, is_master=key[2],
                                  timeout=start)
        except Exception as e:  # noqa: BLE001 — reworded when it is the wait
            if time.monotonic() - t0 < 0.9 * start.total_seconds():
                raise
            what = (f"while rank 0's rendezvous store at {key[0]}:{key[1]} "
                    f"waited for all {size} ranks to connect" if key[2]
                    else f"while rank {rank} tried to reach rank 0's "
                    f"rendezvous store at {key[0]}:{key[1]}")
            raise _start_timed_out(what, start, e) from e
        store.set_timeout(_TIMEOUT)
        _store = (key, store)
    return _store[1]


def _await_world(store, rank, size):
    """A first rendezvous's check-in under the epoch's prefix: every
    rank marks its arrival and waits for all the others, bounded by
    ``HOROVOD_START_TIMEOUT`` (the store's own bound stays as it is)."""
    start = _start_timeout()
    store.set(f"arrived/{rank}", "1")
    try:
        store.wait([f"arrived/{r}" for r in range(size)], start)
    except Exception as e:  # noqa: BLE001 — say which wait ran out
        try:
            missing = [r for r in range(size)
                       if not store.check([f"arrived/{r}"])]
        except Exception:  # noqa: BLE001 — rank 0's store went away
            missing = "unknown (rank 0's store is gone)"
        raise _start_timed_out(
            f"while rank {rank} waited for the world of {size} to arrive "
            f"(missing ranks: {missing})", start, e) from e


def _open(layout, card, epoch, fault_inject, probe=False, split=0):
    """Open torch.distributed and the lane at ``epoch``; caller holds
    ``_lock``. ``probe``: run the hierarchy's eligibility probe (a first
    init); else ``split`` is the hierarchy split (a re-formation's)."""
    global _lane, _epoch, _tune_splits
    rank, size = layout["rank"], layout["size"]
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is already initialized: hvd.init() opens "
            "its own process groups")
    t0 = now_us()
    if size == 1 and not _door_enabled():
        store, fault_store = dist.HashStore(), None
    else:
        base = _base_store(rank, size)
        store = dist.PrefixStore(f"hvd/epoch{epoch}", base)
        fault_store = dist.PrefixStore(f"hvd/epoch{epoch}/fault", base)
        if probe and size > 1:
            # A world's first rendezvous; a joiner's or a re-formation's
            # meets ranks that are already up.
            _await_world(store, rank, size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=size, timeout=_TIMEOUT)
    mode = _cross_plane_mode()
    try:
        if probe:
            split, _tune_splits = _probe_hier(layout, mode)
        runtime = _open_lane(layout, card, epoch, fault_store,
                             fault_inject, mode, split, _tune_splits)
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
    _lane = _Lane(runtime, layout, card, mode)
    _epoch = epoch


def _mark_cycles():
    return _env_int("HOROVOD_TIMELINE_MARK_CYCLES", 0) != 0


def _door_enabled():
    """Whether the parole door may grow this world (``elastic.py``): a
    rejoin port is set and no elastic driver runs the job."""
    return bool(os.environ.get("HOROVOD_REJOIN_PORT")) and \
        not os.environ.get("HOROVOD_RDZV_ADDR")


def _probe_hier(layout, mode):
    """The hierarchy split of a first open (``operations.cc:1575-1615``):
    in modes ``auto`` and ``hier``, one MIN allreduce of ``(local_size,
    -local_size, host-major)`` on the gloo group, collective on every
    rank alike (the gate reads the mode and the world size only).
    Returns the split, ``local_size`` when the layout tiles, else 0 with
    a warning on rank 0 under ``hier``; and whether some rank set
    ``HOROVOD_AUTOTUNE`` (the probe's fourth entry, ``-autotune``), so
    that every rank opens the tuner's splits alike."""
    rank, size, local = layout["rank"], layout["size"], layout["local_size"]
    if mode not in ("auto", "hier"):
        return 0, False
    homogeneous = host_major = True
    tune = _env_int("HOROVOD_AUTOTUNE", 0) != 0
    if size > 1:
        ls = max(local, 1)
        major = int(layout["local_rank"] == rank % ls and
                    layout["cross_rank"] == rank // ls)
        probe = torch.tensor([local, -local, major, -int(tune)],
                             dtype=torch.int64)
        dist.all_reduce(probe, op=dist.ReduceOp.MIN)
        homogeneous = int(probe[0]) == -int(probe[1])
        host_major = int(probe[2]) == 1
        tune = int(probe[3]) < 0
    if homogeneous and host_major and local > 1 and size % local == 0 \
            and size != local:
        return local, tune
    if rank == 0 and mode == "hier":
        print("hvd-torch: HOROVOD_CROSS_PLANE=hier disabled: requires a "
              "homogeneous host-major layout with >1 rank per slice on >1 "
              f"slices (local sizes {'uniform' if homogeneous else 'mixed'}"
              f", layout {'host-major' if host_major else 'not host-major'}"
              ")", file=sys.stderr, flush=True)
    return 0, tune


def _hier_splits(split, local_size, size):
    """The autotuner's splits (``InitAutotune``): none when flat, else
    every divisor d >= 2 of ``local_size`` that divides ``size``."""
    if split <= 1:
        return []
    return [d for d in range(2, local_size + 1)
            if local_size % d == 0 and size % d == 0]


def _init_autotune(rank, fusion_bytes, cycle_ms, codec, mode, split,
                   local_size, size):
    """The autotuner's one construction site, for init and every
    re-formation (``InitAutotune``): None without ``HOROVOD_AUTOTUNE``;
    else, on the coordinator, a fresh tuner from the live knobs (its log
    truncated). The codec joins its grid only when the user chose one;
    the split, on a hierarchical layout, over flat (not under an
    explicit ``hier``) and :func:`_hier_splits`. Workers take the
    coordinator's knobs from the response lists and open no log."""
    if not _env_int("HOROVOD_AUTOTUNE", 0) or rank != 0:
        return None
    hier_values = _hier_splits(split, local_size, size)
    if hier_values and mode != "hier":
        hier_values = [0] + hier_values
    return ParameterManager(
        fusion_bytes, cycle_ms, os.environ.get("HOROVOD_AUTOTUNE_LOG"),
        max_samples=_env_int("HOROVOD_AUTOTUNE_STEPS", 20),
        window_bytes=_env_int("HOROVOD_AUTOTUNE_WINDOW_BYTES", 1 << 20),
        window_cycles=_env_int("HOROVOD_AUTOTUNE_WINDOW_CYCLES", 20),
        wire_codec=codec, tune_wire_codec=codec != 0,
        hier_values=hier_values, hier_split=split)


def _open_lane(layout, card, epoch, store, fault_inject, mode, split,
               tune_splits):
    """The process groups of the global set and of the slices (the
    split's, or with ``tune_splits`` every split of the tuner's grid),
    and the lane's runtime."""
    rank, size = layout["rank"], layout["size"]

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
    cycle_ms = float(os.environ.get("HOROVOD_CYCLE_TIME") or 1.0)
    stall_s = None if _env_int("HOROVOD_STALL_CHECK_DISABLE", 0) else float(
        os.environ.get("HOROVOD_STALL_CHECK_TIME") or 60.0)
    plane = DataPlane(card, threshold, world=size)
    plane.wire_codec = _wire_codec_env()
    plane.cross_compression = \
        _env_strtoll("HOROVOD_CROSS_PLANE_COMPRESSION") != 0
    plane.hier_split = split
    local_size = layout["local_size"]
    splits = _hier_splits(split, local_size, size) if tune_splits else \
        [split] if split > 1 else []
    for d in splits:
        # Every rank opens every slice's groups, in one order.
        slices = [list(range(i, i + d)) for i in range(0, size, d)]
        crosses = [list(range(j, size, d)) for j in range(d)]
        made = [(m, make_groups(m)) for m in slices + crosses]
        plane.hier_groups[d] = tuple(
            SetGroups(m, rank, g) for m, g in made if rank in m)
    return Runtime(rank, size, dist.group.WORLD, plane,
                   {0: SetGroups(world, rank, groups)}, threshold, cycle_ms,
                   make_groups,
                   cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY", 1024),
                   stall_warning_s=stall_s, epoch=epoch, store=store,
                   fault_inject=fault_inject,
                   param_manager=_init_autotune(
                       rank, threshold, cycle_ms, plane.wire_codec, mode,
                       split, local_size, size))


def _close(lane):
    """Tear the lane and its process groups down, whatever state it is
    in: a running lane negotiates its shutdown first (every rank must
    call); a failed one, or one whose negotiation did not end, has its
    NCCL communicators aborted rather than waited for: the sets' and the
    slices' (a peer lost in a hierarchical allreduce leaves the lane in
    a slice's or a cross group's collective)."""
    rt = lane.runtime
    plane = rt.data_plane
    t0 = now_us()
    ended = rt.failure is None and rt.shutdown(_TIMEOUT.total_seconds())
    rt.stop()
    rt.timeline.stop()
    if rt.param_manager is not None:
        rt.param_manager.close()
    if not ended:
        hops = [s for pair in plane.hier_groups.values() for s in pair]
        _abort_all([s.groups["cuda"] for s in list(rt.sets.values()) + hops
                    if "cuda" in s.groups])
    # Drop the lane's references: a gloo context closes its sockets when
    # its last one goes, which ends a peer's collective waiting on it.
    rt.sets.clear()
    plane.hier_groups.clear()
    rt.control.group = None
    dist.destroy_process_group()
    REGISTRY.record_phase("shutdown", now_us() - t0)


def _abort_all(groups):
    """Abort NCCL communicators at once, one thread each: a collective a
    lost peer left hung holds the lane's stream, and one communicator's
    abort can wait on that stream until the hung one's is aborted too."""
    def abort(pg):
        try:
            pg.abort()
        except Exception as e:  # noqa: BLE001 — best effort
            print(f"hvd-torch: NCCL abort failed: {e}", file=sys.stderr)

    threads = [threading.Thread(target=abort, args=(pg,), daemon=True)
               for pg in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


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
    (``basics.py:665``): no process restart; a slot's new rank is its
    index in ``ranks``. A ``-1`` is a joiner slot: a fresh process that
    opens with ``init(epoch=epoch)`` at that rank (the parole door's
    scale-up, ``elastic.py``). Collective among the members. The old
    groups are aborted (a running lane first drains by its negotiated
    shutdown, so every old rank must call), new ones open on the epoch's
    prefix of the same store (a joiner's ``init`` runs the same
    collectives in the same order: both sides go through ``_open``), and
    the lane reopens (controller, fusion buffer, response cache, a fresh
    autotuner), the fault trigger cleared."""
    global _lane, _last_fault
    ranks, epoch = [int(r) for r in ranks], int(epoch)
    with _lock:
        lane = _lane
        old_size = lane.layout["size"] if lane is not None else 0
        members = [r for r in ranks if r != -1]
        if lane is None or not ranks or \
                len(set(members)) != len(members) or \
                any(r >= old_size or r < -1 for r in ranks) or \
                epoch <= _epoch:
            raise RuntimeError(
                f"reinit(ranks={ranks}, epoch={epoch}) failed: not "
                "initialized / bad ranks / epoch not past the current")
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
        old_split = lane.runtime.data_plane.hier_split
        _close(lane)
        rank, size = ranks.index(old_rank), len(ranks)
        local = _survivor_slices(ranks, old_split,
                                 lane.layout["local_size"])
        layout = dict(rank=rank, size=size, local_rank=rank % local,
                      local_size=local, cross_rank=rank // local,
                      cross_size=size // local)
        try:
            _open(layout, lane.device, epoch, None,
                  split=local if local < size else 0)
        except Exception as e:
            _events.record("reinit_end", -4, size, epoch)
            raise RuntimeError(
                f"reinit(ranks={ranks}, epoch={epoch}) failed: "
                f"re-formation rendezvous failed ({e})") from e
        _events.record("reinit_end", 0, size, epoch)
        _events.record("epoch", 0, 0, epoch, old_epoch)
        joiners = size - len(members)
        if joiners:
            _events.record("rejoin", joiners, 0, epoch)
        if fault is not None:
            _last_fault = dict(fault, recovered=True)
        REGISTRY.record_reset(fault is not None, old_size - len(members),
                              joiners)
        REGISTRY.record_phase("reinit", now_us() - t0)


def _survivor_slices(ranks, old_split, old_local):
    """The re-formed world's ``local_size`` (``operations.cc:1837-1880``):
    with a hierarchical old world and no joiner slot, the survivors
    grouped by old host (``old_rank // old_local``); when the sorted list
    keeps every remaining host at one count L > 1 over more than one
    host, L; else the world's size (flat)."""
    size = len(ranks)
    if old_split <= 1 or old_local <= 0 or -1 in ranks or \
            ranks != sorted(ranks):
        return size
    counts = []
    for r in ranks:
        host = r // old_local
        if counts and counts[-1][0] == host:
            counts[-1][1] += 1
        else:
            counts.append([host, 1])
    tile = counts[0][1]
    if all(c == tile for _, c in counts) and tile > 1 and \
            size % tile == 0 and size // tile > 1:
        return tile
    return size


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


def cross_plane():
    """The cross-plane mode (``HOROVOD_CROSS_PLANE``): one of
    :data:`CROSS_PLANE_MODES`, fixed at init."""
    current = _lane
    if current is None:
        raise ValueError("hvd.cross_plane() called before hvd.init(); call "
                         "hvd.init() first")
    return current.cross_plane


def hier_split():
    """The active hierarchy split of the global set's allreduce: 0 flat,
    L >= 2 slices of L consecutive ranks; -1 before init."""
    current = _lane
    return -1 if current is None else current.runtime.data_plane.hier_split


def set_hier_split(split):
    """Set the hierarchy split; must be rank-uniform. 0 (flat) or a split
    whose slices' groups the lane opened (the probe's, or under
    ``HOROVOD_AUTOTUNE`` the autotuner's grid); raises ``ValueError`` for
    any other."""
    plane = _require_lane("set_hier_split").data_plane
    split = int(split)
    if split != 0 and split not in plane.hier_groups:
        raise ValueError(
            f"hier split {split} has no slice groups on this lane: 0 or one "
            f"of {sorted(plane.hier_groups)}")
    plane.hier_split = split


def cross_compression():
    """Whether the bf16 codec rides the hierarchical allreduce's cross hop
    alone (``HOROVOD_CROSS_PLANE_COMPRESSION``; fixed at init)."""
    current = _lane
    return current is not None and \
        current.runtime.data_plane.cross_compression


def wire_codec():
    """The wire codec: 0 off, 1 bf16, 2 int8 (``HOROVOD_WIRE_COMPRESSION``
    until init, then the lane's)."""
    current = _lane
    return _wire_codec_env() if current is None else \
        current.runtime.data_plane.wire_codec


def set_wire_codec(mode):
    """Select the wire codec on the live lane; must be rank-uniform. A
    mode outside 0-2 means off."""
    mode = int(mode)
    _require_lane("set_wire_codec").data_plane.wire_codec = \
        mode if mode in (0, 1, 2) else 0


def wire_compression():
    """Whether f32 Sum/Average payloads cross the wire narrowed."""
    return wire_codec() != 0


def set_wire_compression(on):
    """bf16 on the wire (True) or off."""
    set_wire_codec(1 if on else 0)


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
    c, plane = rt.cache, rt.data_plane
    return REGISTRY.snapshot(
        initialized=True, rank=rt.rank, size=rt.size,
        fusion_threshold_bytes=rt.fusion_threshold,
        cycle_time_ms=rt.cycle_time_ms,
        cache=(c.hits, c.misses, c.entries, c.hit_bytes), epoch=_epoch,
        last_fault=last_fault(), wire_knobs={
            "wire_compression": plane.wire_codec != 0,
            "wire_codec": CODEC_NAMES[plane.wire_codec],
            "cross_plane": current.cross_plane,
            "hier_split": plane.hier_split,
            "cross_compression": plane.cross_compression})


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


def step_id():
    """The open step's id (``step_mark``), or -1."""
    return _step["open"]


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
