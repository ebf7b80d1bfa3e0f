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

A joined rank takes part in the collectives it never enqueued with
zero-filled tensors. After a failed collective (a lost peer) every
in-flight handle and every later enqueue raises
:class:`HorovodInternalError`; a mismatch across ranks fails only the
tensors concerned.
"""

import dataclasses
import sys
import threading
import time
import traceback

import torch

from horovod_tpu_torch.common.controller import (
    ControlPlane,
    Controller,
    nbytes,
)
from horovod_tpu_torch.common.data_plane import ResponseError
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.message import (
    Request,
    RequestList,
    RequestType,
    ResponseType,
)


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
        self.error = error
        self._done.set()

    def poll(self):
        return self._done.is_set() and (self.cuda_event is None or
                                        self.cuda_event.query())

    def wait(self):
        """The result, once the lane has run the op (for a CUDA op: once
        its work is queued; the caller's stream then waits on
        ``cuda_event``). Raises the op's error."""
        self._done.wait()
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
    ``make_groups(ranks)`` creates a new set's groups."""

    def __init__(self, rank, size, control_group, data_plane, sets,
                 fusion_threshold, cycle_time_ms, make_groups):
        self.rank = rank
        self.size = size
        self.data_plane = data_plane
        self.sets = sets
        self._sets_lock = threading.Lock()
        self._make_groups = make_groups
        self._next_set_id = max(sets) + 1
        self.cycle_s = cycle_time_ms / 1e3
        controller = Controller(size, fusion_threshold, self.members_of) \
            if rank == 0 else None
        self.control = ControlPlane(control_group, rank, size, controller)
        self.queue = TensorQueue()
        self.joined = False
        self.failure = None
        self._barrier_seq = {}
        self._group_seq = 0
        self._shutdown = threading.Event()
        # Host seconds of the lane: negotiation (the control exchange)
        # and execution (queuing the responses' work), by cycle.
        # Responses carrying several tensors count as fused;
        # largest_fused is the most bytes one fused outside a group.
        self.stats = dict(cycles=0, responses=0, fused=0, largest_fused=0,
                          negotiate_s=0.0, execute_s=0.0)
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd-torch-lane", daemon=True)

    def start(self):
        self._thread.start()

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
            raise HorovodInternalError(
                f"cannot enqueue {items[0][0].tensor_name}: collective "
                f"runtime failed ({self.failure})")
        entries = []
        for request, input, output in items:
            ready = None
            if request.device == "cuda":
                # The producer's stream at enqueue: the lane waits on it.
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(input.device))
            entries.append(TensorEntry(request, input, output, Handle(),
                                       ready))
        if any(r.request_type == RequestType.JOIN for r, _, _ in items):
            self.joined = True
        self.queue.add(entries)
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
        try:
            self.data_plane.start_thread()
            while True:
                t0 = time.perf_counter()
                requests = RequestList(self.queue.pop_requests(),
                                       self._shutdown.is_set())
                responses = self.control.exchange(requests)
                t1 = time.perf_counter()
                st = self.stats
                st["cycles"] += 1
                # Counted before any handle completes: a caller that
                # synchronized sees its response counted.
                st["responses"] += len(responses.responses)
                for r in responses.responses:
                    if len(r.tensor_names) > 1:
                        st["fused"] += 1
                        if r.group_id < 0:
                            st["largest_fused"] = max(
                                st["largest_fused"],
                                sum(nbytes(r.tensor_type, shape)
                                    for shape in r.tensor_shapes))
                for res in responses.responses:
                    self._perform(res)
                t2 = time.perf_counter()
                st["negotiate_s"] += t1 - t0
                st["execute_s"] += t2 - t1
                if responses.shutdown:
                    break
                time.sleep(max(0.0, self.cycle_s - (t2 - t0)))
        except Exception as exc:  # noqa: BLE001 — the lane's boundary
            traceback.print_exc(file=sys.stderr)
            self.failure = f"{type(exc).__name__}: {exc}"
            error = HorovodInternalError(
                f"collective runtime failed: {self.failure}")
        finally:
            self.queue.close(error)

    def _perform(self, res):
        if res.response_type == ResponseType.JOIN:
            self.joined = False
            for e in self.queue.take(0, res.tensor_names):
                if e is not None:
                    e.handle.complete(res.last_joined_rank)
            return
        entries = self.queue.take(res.process_set_id, res.tensor_names)
        if res.response_type == ResponseType.ERROR:
            for e in entries:
                if e is not None:
                    e.handle.fail(HorovodInternalError(res.error_message))
            return
        pset = self.set_groups(res.process_set_id)
        if pset is None or pset.position is None:
            return     # not a member of the set: nothing to run
        if None in entries:
            if not self.joined:
                raise RuntimeError(
                    f"response {res.tensor_names} names a tensor this rank "
                    "never enqueued")
            entries = [e if e is not None else self._zero_entry(res, i)
                       for i, e in enumerate(entries)]
        try:
            done = self.data_plane.execute(res, entries, pset)
        except ResponseError as exc:
            for e in entries:
                if e.handle is not None:
                    e.handle.fail(HorovodInternalError(str(exc)))
            return
        for e in entries:
            if e.handle is not None:
                e.handle.complete(e.result, done)

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
        if self._thread.is_alive():
            self._thread.join(timeout)
        return not self._thread.is_alive()
