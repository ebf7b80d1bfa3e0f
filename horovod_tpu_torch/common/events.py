"""The event ring: a fixed-capacity, always-on record of the lane's
typed, timestamped transitions.

Counterpart of ``csrc/events.{h,cc}`` (capacity 8192). An event is a
dict ``{"seq", "ts_us", "type", ...}`` with the named arguments the
reference prints for its type (``kEventSpecs``); ``ts_us`` is the
steady clock in microseconds. The lane records these types:

- ``negotiate_begin`` (requests popped) and ``negotiate_end``
  (responses, shutdown): an active cycle's control exchange;
- ``response_launch`` (op_class, device, tensors, bytes): a response
  about to run; ``op_class`` in the reference's order
  (:data:`metrics.OP_CLASSES`), ``device`` 1 for CUDA tensors;
- ``stall`` (waited_s, missing): the coordinator's stall check;
- ``phase`` (phase, dur_us, and ``phase_name``): a control phase;
- ``step_begin`` (step) and ``step_end`` (step, dur_us): step marks;
- ``wait`` (dur_us): a caller blocked in ``synchronize``, stamped at
  its end;
- ``fault`` (kind, certain, epoch, fault_rank): a collective failed on a
  lost peer; ``inject`` (action, op_index): ``HOROVOD_FAULT_INJECT``
  fired; ``reinit_begin`` (size, epoch), ``reinit_end`` (rc, size,
  epoch) and ``epoch`` (epoch, old_epoch): an in-place re-formation.

:func:`peek` reads without consuming; :func:`drain` consumes what was
recorded since the last drain. Both see at most the newest 8192.
"""

import threading
import time

CAPACITY = 8192

# type -> the JSON keys of its four arguments ("" = unused), as
# csrc/events.cc prints them.
SPECS = {
    "negotiate_begin": ("requests", "", "", ""),
    "negotiate_end": ("responses", "shutdown", "", ""),
    "response_launch": ("op_class", "device", "tensors", "bytes"),
    "stall": ("waited_s", "missing", "", ""),
    "phase": ("phase", "", "dur_us", ""),
    "step_begin": ("", "", "step", ""),
    "step_end": ("", "", "step", "dur_us"),
    "wait": ("", "", "dur_us", ""),
    "fault": ("kind", "certain", "epoch", "fault_rank"),
    "epoch": ("", "", "epoch", "old_epoch"),
    "reinit_begin": ("size", "", "epoch", ""),
    "reinit_end": ("rc", "size", "epoch", ""),
    "inject": ("action", "", "op_index", ""),
}
# The reference's control-phase order (csrc/metrics.h ControlPhase), then
# the port's own: the lane's teardown (``shutdown()``, or the old lane's
# within ``reinit``) and the NCCL communicator's creation within
# ``rendezvous``. The lane records all but ``probe_sweep`` and
# ``parole_freeze`` (no sweep; the door is ROADMAP.md L5b).
CONTROL_PHASES = ("rendezvous", "gather", "broadcast", "probe_sweep",
                  "reinit", "parole_freeze", "shutdown", "nccl_init")


class EventRing:
    def __init__(self):
        self._lock = threading.Lock()
        self._slots = [None] * CAPACITY
        self._head = 0      # next sequence number
        self._cursor = 0    # drain position
        self._floor = 0     # reset() hides everything before this

    def record(self, type, a=0, b=0, c=0, d=0):
        ts = time.monotonic_ns() // 1000
        with self._lock:
            seq = self._head
            self._slots[seq % CAPACITY] = (seq, ts, type, a, b, c, d)
            self._head = seq + 1

    def _since(self, first):
        first = max(first, self._head - CAPACITY, self._floor)
        return [self._slots[s % CAPACITY] for s in range(first, self._head)]

    def peek(self, last_n=0):
        with self._lock:
            live = self._since(0)
        return [_as_dict(e) for e in (live[-last_n:] if last_n > 0
                                      else live)]

    def drain(self):
        with self._lock:
            out = self._since(self._cursor)
            self._cursor = self._head
        return [_as_dict(e) for e in out]

    def reset(self):
        """Forget every recorded event; sequence numbers go on."""
        with self._lock:
            self._floor = self._cursor = self._head


def _as_dict(event):
    seq, ts, type, *args = event
    out = {"seq": seq, "ts_us": ts, "type": type}
    for key, value in zip(SPECS[type], args):
        if key:
            out[key] = value
    if type == "phase":
        out["phase_name"] = CONTROL_PHASES[args[0]]
    return out


RING = EventRing()
record = RING.record
peek = RING.peek
drain = RING.drain
