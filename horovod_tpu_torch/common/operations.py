"""The background cycle: tensor queue, handles and the lane thread.

Counterpart of ``csrc/operations.cc`` (the background loop,
``ExecuteResponse``, ``SynthesizeJoinedEntries:725``) and
``csrc/tensor_queue.cc``. A caller's op becomes a :class:`TensorEntry`
in the :class:`TensorQueue` and returns a :class:`Handle`. One lane
thread per process cycles every ``HOROVOD_CYCLE_TIME`` ms: it sends the
requests queued since the last cycle to the coordinator
(:class:`controller.ControlPlane`), then runs the responses it gets back
in order through the :class:`data_plane.DataPlane` and completes the
handles. Only this thread issues collectives, in the same order on
every rank, so no rank waits on a peer in a collective the peer never
runs; shutdown is negotiated like any request.

Each cycle also feeds the instruments: the metrics registry
(``metrics.py``: op counts and bytes per response, negotiation and queue
latency, cycles), the event ring (``events.py``) and, when one is
running, the timeline (``timeline.py``).

A joined rank takes part in the collectives it never enqueued with
zero-filled tensors. A mismatch across ranks fails only the tensors
concerned.

A failed collective (a lost peer) ends the lane, and every rank names
the same dead set (the core's probe sweep, ``csrc/operations.cc``, has
no counterpart on ``torch.distributed``; the port checks in on the
rendezvous store instead, :meth:`Runtime._agree`): the rank that fails
posts ``fault`` and ``alive/<rank>`` under its epoch's prefix; every
rank's watcher thread polls ``fault`` every 0.1 s and checks in, so a
rank a gloo ring never gives an EOF raises as promptly as the dead
rank's neighbours; rank 0 freezes the ranks that checked in within 3 s
of its own (``CHECKIN_S``), or as soon as all did, and every rank reads
the frozen list. The
fault record (:attr:`Runtime.fault`, the reference's ``last_fault()``
dict) is written before any handle wakes; then every in-flight handle
and every later enqueue raises :class:`HorovodPeerFailureError` naming
the dead ranks. A store that cannot be reached means its host, rank 0,
is gone: the record then names rank 0, not certain. A failure that
leaves no rank dead raises :class:`HorovodInternalError`.

``HOROVOD_FAULT_INJECT="<rank>:<op>[:<action>[:<param>]]"`` arms the
chaos trigger (:func:`parse_fault_spec`, the reference's strict
grammar): at the top of the ``op``-th executed response (JOIN and ERROR
not counted, as ``MaybeInjectFault``) rank ``rank`` runs ``kill``
(SIGKILL) or ``delay:<ms>`` (a straggler sleep). One-shot per epoch.
"""

import dataclasses
import datetime
import os
import signal
import sys
import threading
import time

import torch

from horovod_tpu_torch.common import events
from horovod_tpu_torch.common.controller import ControlPlane, Controller
from horovod_tpu_torch.common.data_plane import ResponseError
from horovod_tpu_torch.common.exceptions import (
    HorovodInternalError,
    HorovodPeerFailureError,
)
from horovod_tpu_torch.common.message import (
    Request,
    RequestType,
    ResponseType,
    response_bytes,
)
from horovod_tpu_torch.common.metrics import REGISTRY, now_us, op_class
from horovod_tpu_torch.common.response_cache import ResponseCache
from horovod_tpu_torch.common.timeline import Timeline


_WIRE_ACTIONS = ("stop", "reset", "flip")
_MAX_WIRE_CHANNELS = 8                # csrc/wire.h kMaxWireChannels
_FLIP_SKIP_SHIFT, _FLIP_CHAN_SHIFT = 20, 44
_INT64 = 1 << 63


def _strtoll(text):
    """``strtoll(text, &end, 10)`` consuming all of ``text``; None if
    it does not (leading whitespace and one sign allowed)."""
    body = text.lstrip(" \t\n\v\f\r")
    digits = body[1:] if body[:1] in "+-" else body
    if not body or not digits or not digits.isascii() \
            or not digits.isdigit():
        return None
    v = int(body)
    return v if -_INT64 <= v < _INT64 else None


def parse_fault_spec(spec):
    """``HOROVOD_FAULT_INJECT``'s grammar, as ``ParseFaultSpec``
    (``csrc/operations.cc:268``): ``(rank, op, action, param)`` with
    action ``"kill"`` or ``"delay"``; None for a malformed spec, which
    stays disarmed. ``stop``, ``reset`` and ``flip`` parse as in the
    reference and raise ``ValueError``: they act on the reference's
    socket wire (its deadline and CRC framing, ROADMAP.md L8)."""
    parts = spec.split(":")
    if not 2 <= len(parts) <= 6:
        return None
    rank, op = _strtoll(parts[0]), _strtoll(parts[1])
    if rank is None or rank < 0 or op is None or op < 0:
        return None
    action, param = "kill", 0
    has_param = len(parts) >= 4
    if len(parts) >= 5 and parts[2] != "flip":
        return None
    if len(parts) >= 3:
        action = parts[2]
        value = _strtoll(parts[3]) if has_param else None
        if action == "kill":
            if has_param:
                return None
        elif action in ("stop", "delay"):
            if value is None or value <= 0:
                return None
            param = value
        elif action == "reset":
            if has_param and (value is None or not
                              0 <= value < _MAX_WIRE_CHANNELS):
                return None
        elif action == "flip":
            if value is None or value >= 1 << _FLIP_SKIP_SHIFT:
                return None
            if len(parts) >= 5:
                skip = _strtoll(parts[4])
                if value < 0 or skip is None or not 0 <= skip < 1 << (
                        _FLIP_CHAN_SHIFT - _FLIP_SKIP_SHIFT):
                    return None
                if len(parts) == 6:
                    chan = _strtoll(parts[5])
                    if chan is None or not 0 <= chan < _MAX_WIRE_CHANNELS:
                        return None
        else:
            return None
    if action in _WIRE_ACTIONS:
        raise ValueError(
            f"HOROVOD_FAULT_INJECT={spec!r}: the {action!r} action acts on "
            "the reference's socket wire (deadline, CRC framing), which the "
            "port does not have yet (ROADMAP.md L8); kill and delay:<ms> "
            "are ported")
    return rank, op, action, param


# The watcher's poll of the store, and how long rank 0 waits for the
# survivors to check in: a live rank's watcher is at most one poll (and
# a store round trip) late, so the window only ever delays a real death.
POLL_S = 0.1
CHECKIN_S = 3.0


class SetGroups:
    """A registered process set as the lane sees it: sorted global
    ``members``, this rank's ``position`` among them (None outside the
    set) and its ``groups``, ``{"cpu": gloo group, "cuda": NCCL group}``
    (no ``"cuda"`` on a CPU-only lane)."""

    def __init__(self, members, rank, groups):
        self.members = sorted(int(r) for r in members)
        self.position = (self.members.index(rank) if rank in self.members
                         else None)
        self.groups = groups

    def size(self):
        return len(self.members)


class Handle:
    """Completion of one enqueued op: its result (or error) and, for a
    CUDA op, the event that marks its end on the lane's stream."""

    def __init__(self):
        self._done = threading.Event()
        self.result = None
        self.error = None
        self.cuda_event = None

    def complete(self, result, cuda_event=None):
        self.result = result
        self.cuda_event = cuda_event
        self._done.set()

    def fail(self, error):
        if self._done.is_set():
            return
        self.error = error
        self._done.set()

    def poll(self):
        return self._done.is_set() and (self.cuda_event is None or
                                        self.cuda_event.query())

    def wait(self):
        """The result, once the lane has run the op (for a CUDA op: once
        its work is queued; the caller's stream then waits on
        ``cuda_event``). Raises the op's error. A wait that blocked is a
        ``wait`` event."""
        t0 = now_us()
        self._done.wait()
        t1 = now_us()
        if t1 > t0:
            events.record("wait", c=t1 - t0)
        if self.error is not None:
            raise self.error
        return self.result


@dataclasses.dataclass(eq=False)
class TensorEntry:
    request: object
    input: torch.Tensor = None
    output: torch.Tensor = None
    handle: Handle = None
    ready_event: object = None
    result: object = None
    enqueue_us: int = 0

    @property
    def prescale(self):
        return self.request.prescale_factor

    @property
    def postscale(self):
        return self.request.postscale_factor


class TensorQueue:
    """Entries by (process set, name) and the requests not yet sent.
    Counterpart of ``csrc/tensor_queue.cc``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {}
        self._new = []
        self._closed = None

    def add(self, entries):
        keys = [(e.request.process_set_id, e.request.tensor_name)
                for e in entries]
        with self._lock:
            if self._closed is not None:
                raise self._closed
            batch = set()
            for ps, name in keys:
                if (ps, name) in self._entries or (ps, name) in batch:
                    raise ValueError(
                        f"a collective named {name!r} is already in flight "
                        f"on process set {ps}: names must be unique until "
                        "synchronized")
                batch.add((ps, name))
            for key, e in zip(keys, entries):
                self._entries[key] = e
                self._new.append(e.request)

    def depth(self):
        """Collectives enqueued and not yet run."""
        with self._lock:
            return len(self._entries)

    def pop_requests(self):
        with self._lock:
            out, self._new = self._new, []
        return out

    def take(self, process_set_id, names):
        """The entries of a response in its order; None where this rank
        holds no entry of that name."""
        with self._lock:
            return [self._entries.pop((process_set_id, n), None)
                    for n in names]

    def close(self, error):
        """Refuse every later entry with ``error``; fail the queued ones."""
        with self._lock:
            self._closed = error
            pending, self._entries = list(self._entries.values()), {}
            self._new = []
        for e in pending:
            e.handle.fail(error)


class Runtime:
    """One rank's lane: queue, lane thread, controller (on rank 0) and
    data plane. ``sets`` maps a process set id to its :class:`SetGroups`;
    ``make_groups(ranks)`` creates a new set's groups. ``cache_capacity``
    sizes the response cache (0: off); ``stall_warning_s`` is the stall
    check's threshold (None: off). ``epoch`` is the membership epoch;
    ``store`` the fault check-in's store (its prefix is the epoch's;
    None in a world of one); ``fault_inject`` a parsed
    :func:`parse_fault_spec` or None."""

    def __init__(self, rank, size, control_group, data_plane, sets,
                 fusion_threshold, cycle_time_ms, make_groups,
                 cache_capacity=1024, stall_warning_s=60.0, epoch=0,
                 store=None, fault_inject=None):
        self.rank = rank
        self.size = size
        self.data_plane = data_plane
        self.sets = sets
        self._sets_lock = threading.Lock()
        self._make_groups = make_groups
        self._next_set_id = max(sets) + 1
        self.fusion_threshold = fusion_threshold
        self.cycle_time_ms = cycle_time_ms
        self.cache = ResponseCache(cache_capacity)
        controller = Controller(size, fusion_threshold, self.members_of,
                                self.cache, stall_warning_s) \
            if rank == 0 else None
        self.control = ControlPlane(control_group, rank, size, self.cache,
                                    controller)
        self.timeline = data_plane.timeline = Timeline()
        self.queue = TensorQueue()
        self.joined = False
        self.failure = None
        self.epoch = epoch
        self.fault = None           # the fault record, once agreed
        self.fault_inject = fault_inject
        self._store = store if size > 1 else None
        self._error = None          # what every handle then raises
        self._fault_lock = threading.Lock()
        self._op_counter = 0        # executed responses, for the trigger
        self._executing = []        # the entries of the running response
        self._op_start_us = now_us()
        self._barrier_seq = {}
        self._group_seq = 0
        self._shutdown = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-torch-lane", daemon=True)
        self._watcher = threading.Thread(
            target=self._watch, name="hvd-torch-fault-watch",
            daemon=True) if self._store is not None else None

    def start(self):
        self._thread.start()
        if self._watcher is not None:
            self._watcher.start()

    # ---- process sets --------------------------------------------------

    def members_of(self, process_set_id):
        with self._sets_lock:
            s = self.sets.get(process_set_id)
        return None if s is None else s.members

    def set_groups(self, process_set_id):
        with self._sets_lock:
            return self.sets.get(process_set_id)

    def register_set(self, ranks):
        """Collective on every rank, in the same order: groups for
        ``ranks`` and the set's id."""
        groups = self._make_groups(ranks)
        with self._sets_lock:
            set_id = self._next_set_id
            self._next_set_id += 1
            self.sets[set_id] = SetGroups(ranks, self.rank, groups)
        return set_id

    def unregister_set(self, set_id):
        with self._sets_lock:
            return self.sets.pop(set_id, None)

    # ---- enqueue ------------------------------------------------------

    def next_group_id(self):
        gid, self._group_seq = self._group_seq, self._group_seq + 1
        return gid

    def barrier_name(self, process_set_id):
        n = self._barrier_seq.get(process_set_id, 0)
        self._barrier_seq[process_set_id] = n + 1
        return f"__barrier__.{n}"

    def enqueue(self, request, input=None, output=None):
        """Queue one op; returns its :class:`Handle`."""
        return self.enqueue_many([(request, input, output)])[0]

    def enqueue_many(self, items):
        """Queue ``(request, input, output)`` items all or none (a group
        half queued would wait forever for its other members)."""
        if self.failure is not None:
            raise self._later_error(items[0][0].tensor_name)
        entries = []
        for request, input, output in items:
            ready = None
            if request.device == "cuda":
                # The producer's stream at enqueue: the lane waits on it.
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(input.device))
            entries.append(TensorEntry(request, input, output, Handle(),
                                       ready, enqueue_us=now_us()))
        if any(r.request_type == RequestType.JOIN for r, _, _ in items):
            self.joined = True
        self.queue.add(entries)
        for r, _, _ in items:
            self.timeline.entry_queued(r.tensor_name)
        return [e.handle for e in entries]

    def barrier(self, process_set_id=0):
        """A negotiated barrier over the set: returns once every member
        has reached it."""
        self.enqueue(Request(self.rank, RequestType.BARRIER,
                             self.barrier_name(process_set_id),
                             process_set_id=process_set_id)).wait()

    # ---- the lane thread -----------------------------------------------

    def _loop(self):
        error = HorovodInternalError("Horovod has been shut down")
        tl = self.timeline
        try:
            self.data_plane.start_thread()
            while self._error is None:
                t0 = self._op_start_us = now_us()
                if tl.mark_cycles:
                    tl.mark_cycle()
                requests = self.queue.pop_requests()
                for r in requests:
                    tl.negotiate_start(r.tensor_name)
                if requests:
                    events.record("negotiate_begin", len(requests))
                responses = self.control.exchange(requests,
                                                  self._shutdown.is_set())
                if requests or responses.responses:
                    # Active cycles only: idle rounds would swamp it.
                    REGISTRY.record(REGISTRY.negotiation_us, now_us() - t0)
                    events.record("negotiate_end", len(responses.responses),
                                  int(responses.shutdown))
                for res in responses.responses:
                    if self._error is not None:
                        break
                    for name in res.tensor_names:
                        tl.negotiate_end(name)
                    t1 = self._op_start_us = now_us()
                    self._perform(res)
                    REGISTRY.record(REGISTRY.execute_us, now_us() - t1)
                if responses.shutdown:
                    # Every rank ends in this cycle: rank 0 may close the
                    # store at any moment now.
                    self._stopped.set()
                    break
                elapsed = now_us() - t0
                budget = self.cycle_time_ms * 1e3
                REGISTRY.account_cycle(elapsed, budget)
                REGISTRY.drain_cuda_spans()
                time.sleep(max(0.0, budget - elapsed) / 1e6)
        except Exception as exc:  # noqa: BLE001 — the lane's boundary
            print(f"hvd-torch lane: collective failed: "
                  f"{type(exc).__name__}: {exc}", file=sys.stderr)
            error = self.fail(f"{type(exc).__name__}: {exc}")
        finally:
            if self._error is not None:
                error = self._error
            self.queue.close(error)

    # ---- faults ----------------------------------------------------------

    def _watch(self):
        """Check in as soon as any rank reports a failed collective, so
        that a rank a gloo ring gives no EOF raises too; a store that
        stops answering means rank 0, its host, is gone."""
        while not self._stopped.wait(POLL_S):
            try:
                seen = self._store.check(["fault"])
            except Exception as exc:  # noqa: BLE001 — the store's host died
                if self._stopped.wait(0.5):
                    return       # a negotiated shutdown, not a fault
                self.fail(f"rendezvous store unreachable: {exc}")
                return
            if seen:
                self.fail("a peer reported a failed collective")
                return

    def _agree(self):
        """The dead ranks every rank names, and whether the list is
        agreed (``certain``): the store's check-in (module docstring)."""
        st = self._store
        if st is None:
            return [], True
        try:
            st.set("fault", str(self.rank))
            st.set(f"alive/{self.rank}", "1")
            if self.rank == 0:
                deadline = time.monotonic() + CHECKIN_S
                while True:
                    alive = [r for r in range(self.size)
                             if st.check([f"alive/{r}"])]
                    if len(alive) == self.size or \
                            time.monotonic() >= deadline:
                        break
                    time.sleep(0.02)
                st.set("frozen", ",".join(map(str, alive)))
            else:
                st.wait(["frozen"],
                        datetime.timedelta(seconds=CHECKIN_S + 60))
            alive = {int(r) for r in st.get("frozen").decode().split(",")
                     if r}
        except Exception:  # noqa: BLE001 — rank 0's store went with it
            return ([0] if self.rank != 0 else []), False
        return [r for r in range(self.size) if r not in alive], True

    def fail(self, reason):
        """End the lane on a failed collective: agree on the dead ranks,
        write the fault record, then fail every handle. Idempotent; any
        thread; returns the error the handles get."""
        with self._fault_lock:
            if self._error is not None:
                return self._error
            self._stopped.set()
            dead, certain = self._agree()
            detect_ms = (now_us() - self._op_start_us) // 1000
            self.failure = reason
            if dead:
                self.fault = dict(epoch=self.epoch, ranks=dead,
                                  certain=certain, reason=reason,
                                  detect_ms=int(detect_ms), recovered=False,
                                  kind="peer")
                REGISTRY.record_fault(detect_ms * 1000)
                events.record("fault", 0, int(certain), self.epoch, dead[0])
                self._error = self._peer_error(
                    f"collective runtime failed: rank(s) {dead} lost at "
                    f"epoch {self.epoch} ({reason}); detected in "
                    f"{detect_ms} ms")
            else:
                self._error = HorovodInternalError(
                    f"collective runtime failed: {reason}")
        self.queue.close(self._error)
        for e in list(self._executing):
            if e.handle is not None:
                e.handle.fail(self._error)
        return self._error

    def _peer_error(self, message):
        f = self.fault
        return HorovodPeerFailureError(message, f["ranks"], f["epoch"],
                                       f["detect_ms"])

    def _later_error(self, name):
        msg = (f"cannot enqueue {name}: collective runtime failed "
               f"({self.failure})")
        return self._peer_error(msg) if self.fault is not None else \
            HorovodInternalError(msg)

    def _maybe_inject(self):
        """``MaybeInjectFault``: count this executed response; run the
        armed action at the top of the chosen one."""
        idx, self._op_counter = self._op_counter, self._op_counter + 1
        spec = self.fault_inject
        if spec is None or spec[0] != self.rank or spec[1] != idx:
            return
        _, _, action, param = spec
        events.record("inject", 0 if action == "kill" else 4, 0, idx)
        if action == "kill":
            print(f"HOROVOD_FAULT_INJECT: rank {self.rank} dying at "
                  f"collective {idx}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        self.fault_inject = None
        time.sleep(param / 1e3)

    def _perform(self, res):
        if res.response_type == ResponseType.JOIN:
            self.joined = False
            for e in self.queue.take(0, res.tensor_names):
                if e is not None:
                    self.timeline.entry_done(e.request.tensor_name)
                    e.handle.complete(res.last_joined_rank)
            return
        if res.response_type != ResponseType.ERROR:
            self._maybe_inject()
            events.record("response_launch", op_class(res.response_type),
                          int(res.device == "cuda"), len(res.tensor_names),
                          response_bytes(res))
        pset = self.set_groups(res.process_set_id)
        if res.response_type != ResponseType.ERROR and (
                pset is None or pset.position is None):
            return     # not a member of the set: nothing to run
        entries = self.queue.take(res.process_set_id, res.tensor_names)
        if res.response_type == ResponseType.ERROR:
            self._account(res, [e for e in entries if e is not None], False)
            self._finish(entries, error=HorovodInternalError(
                res.error_message))
            return
        if None in entries:
            if not self.joined:
                raise RuntimeError(
                    f"response {res.tensor_names} names a tensor this rank "
                    "never enqueued")
            entries = [e if e is not None else self._zero_entry(res, i)
                       for i, e in enumerate(entries)]
        start = now_us()
        for e in entries:
            if e.enqueue_us:
                REGISTRY.record(REGISTRY.queue_us, start - e.enqueue_us)
        # Out of the queue now: a failure mid-collective fails them here.
        self._executing = entries
        try:
            done = self.data_plane.execute(res, entries, pset)
        except ResponseError as exc:
            self._executing = []
            self._account(res, entries, False)
            self._finish(entries, error=HorovodInternalError(str(exc)))
            return
        self._executing = []
        self._account(res, entries, True)
        self._finish(entries, done=done)

    def _finish(self, entries, done=None, error=None):
        for e in entries:
            if e is None:
                continue
            self.timeline.entry_done(e.request.tensor_name)
            if e.handle is None:
                continue
            if error is not None:
                e.handle.fail(error)
            else:
                e.handle.complete(e.result, done)

    @staticmethod
    def _account(res, entries, ok):
        """Counts and payload bytes of one response (``AccountResponse``):
        on the card the negotiated shapes; on the CPU the inputs (results
        for allgather and alltoall)."""
        kind = res.response_type
        if res.device == "cuda":
            moved = response_bytes(res)
        elif kind in (ResponseType.ALLREDUCE, ResponseType.BROADCAST,
                      ResponseType.REDUCESCATTER):
            moved = sum(e.input.nbytes for e in entries)
        elif ok and kind in (ResponseType.ALLGATHER, ResponseType.ALLTOALL):
            moved = sum(e.result.nbytes for e in entries)
        else:
            moved = 0
        REGISTRY.account_response(kind, res.device, len(res.tensor_names),
                                  moved, ok)

    def _zero_entry(self, res, i):
        """This joined rank's zero contribution to the response's i-th
        tensor (``SynthesizeJoinedEntries``)."""
        name = res.tensor_names[i]
        shape = tuple(res.tensor_shapes[i])
        req = Request(self.rank, res.response_type, name,
                      res.tensor_type, shape, res.reduce_op,
                      process_set_id=res.process_set_id, device=res.device)
        if res.response_type == ResponseType.BARRIER:
            # Keep this rank's barrier names in step with the ranks
            # that enqueued this one.
            n = int(name.rsplit(".", 1)[1])
            self._barrier_seq[res.process_set_id] = n + 1
            return TensorEntry(req)
        if res.response_type == ResponseType.ALLGATHER:
            shape = (0,) + shape[1:]
        zeros = self.data_plane.zeros(shape, getattr(torch, res.tensor_type),
                                      res.device)
        return TensorEntry(req, zeros, zeros)

    def shutdown(self, timeout=None):
        """Negotiate shutdown (it completes once every rank asked) and
        wait for the lane thread; True if it ended."""
        self._shutdown.set()
        deadline = None if timeout is None else time.monotonic() + timeout
        # A lane that fails meanwhile may sit in a collective a lost peer
        # never finishes: stop waiting for it then.
        while self._thread.is_alive() and self._error is None and (
                deadline is None or time.monotonic() < deadline):
            self._thread.join(0.1)
        return not self._thread.is_alive()

    def stop(self):
        """Stop the watcher and refuse every later op, whatever state
        the lane is in (its thread may still sit in a collective that a
        lost peer never finishes: it is left to end on its own)."""
        self._stopped.set()
        if self._error is None:
            self._error = HorovodInternalError("Horovod has been shut down")
        self.queue.close(self._error)
