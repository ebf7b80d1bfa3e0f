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
- ``wire_span`` (dur_us, tx_bytes, rx_bytes, and the decoded ``plane``
  and ``channels``): one collective call, stamped at its end (on the
  card at the end its CUDA events measured, mapped to the host clock:
  ``metrics.py``); ``plane`` 1 is the hierarchical allreduce's cross
  hop, ``channels`` always 1 (the reference's socket stripes wait for
  L8). The port books its wire bytes per hop in the ``wire`` counters,
  so ``tx_bytes`` and ``rx_bytes`` are 0;
- ``stall`` (waited_s, missing): the coordinator's stall check;
- ``phase`` (phase, dur_us, and ``phase_name``): a control phase;
- ``step_begin`` (step) and ``step_end`` (step, dur_us): step marks;
- ``wait`` (dur_us): a caller blocked in ``synchronize``, stamped at
  its end;
- ``fault`` (kind, certain, epoch, fault_rank): a collective failed on a
  lost peer; ``inject`` (action, op_index): ``HOROVOD_FAULT_INJECT``
  fired; ``reinit_begin`` (size, epoch), ``reinit_end`` (rc, size,
  epoch) and ``epoch`` (epoch, old_epoch): an in-place re-formation;
  ``rejoin`` (slots, epoch): joiner slots it absorbed;
- ``request`` (phase, rid, aux, and ``phase_name``): a serving request
  entered a lifecycle phase (:data:`REQUEST_PHASES`;
  ``telemetry/reqtrace.py``);
- ``knob_adopt`` (knob, value): a knob the autotuner moved, on the
  coordinator when it moves it and on a worker when it adopts it;
  ``knob`` 0 is the fusion threshold (bytes), 1 the cycle time (value
  in microseconds), 3 the wire codec (0-2) and 4 the hierarchy split;
- ``slo_breach`` (objective, breach_rank, value, phase, and the decoded
  ``objective_name`` and ``phase_name``): an SLO breach the engine
  recorded (``telemetry/slo.py SloEngine.record``); ``objective``
  indexes :data:`SLO_OBJECTIVES`, ``phase`` :data:`RANK_BUCKETS` (-1,
  printed ``unknown``: no ledger rode along), ``value`` is rounded ms,
  or permille for a ratio objective.

:func:`peek` reads without consuming; :func:`drain` consumes what was
recorded since the last drain. Both see at most the newest 8192.

:func:`dump_blackbox` is the black-box dump (``DumpBlackBox``,
``csrc/operations.cc:883-940``): at a typed fault the lane appends the
ring to ``blackbox-rank{r}.jsonl`` under ``HOROVOD_BLACKBOX_DIR``
(default ``$TMPDIR/hvdtpu_blackbox``; ``off``, ``none`` or ``0``
disable it) before any handle wakes a caller: one ``blackbox_header``
line with the fault record and a (``unix_us``, ``steady_us``) clock
pair, then one line an event. ``telemetry/postmortem.py`` reads them.
"""

import json
import os
import sys
import threading
import time

CAPACITY = 8192
# kKnob* (csrc/events.h): 2 (ring chunk) and 5 (stripes) wait for L8.
KNOB_FUSION_BYTES, KNOB_CYCLE_TIME_MS = 0, 1
KNOB_COMPRESSION, KNOB_HIER_SPLIT = 3, 4

# type -> the JSON keys of its four arguments ("" = unused), as
# csrc/events.cc prints them.
SPECS = {
    "negotiate_begin": ("requests", "", "", ""),
    "negotiate_end": ("responses", "shutdown", "", ""),
    "response_launch": ("op_class", "device", "tensors", "bytes"),
    # a packs plane | (channels << 1), decoded into named keys below.
    "wire_span": ("", "dur_us", "tx_bytes", "rx_bytes"),
    "stall": ("waited_s", "missing", "", ""),
    "phase": ("phase", "", "dur_us", ""),
    "step_begin": ("", "", "step", ""),
    "step_end": ("", "", "step", "dur_us"),
    "wait": ("", "", "dur_us", ""),
    "fault": ("kind", "certain", "epoch", "fault_rank"),
    "epoch": ("", "", "epoch", "old_epoch"),
    "reinit_begin": ("size", "", "epoch", ""),
    "reinit_end": ("rc", "size", "epoch", ""),
    "rejoin": ("slots", "", "epoch", ""),
    "knob_adopt": ("knob", "", "value", ""),
    "inject": ("action", "", "op_index", ""),
    "request": ("phase", "", "rid", "aux"),
    "slo_breach": ("objective", "breach_rank", "value", "phase"),
}
# The reference's control-phase order (csrc/metrics.h ControlPhase), then
# the port's own: the lane's teardown (``shutdown()``, or the old lane's
# within ``reinit``) and the NCCL communicator's creation within
# ``rendezvous``. The lane records all but ``probe_sweep`` (the port
# checks in on the store instead of sweeping sockets).
CONTROL_PHASES = ("rendezvous", "gather", "broadcast", "probe_sweep",
                  "reinit", "parole_freeze", "shutdown", "nccl_init")
# A serving request's lifecycle phases, in the reference's order
# (csrc/events.h RequestPhase, kRequestPhaseNames).
REQUEST_PHASES = ("queued", "prefill", "kv_ship", "decode_wait",
                  "decode_active", "evicted_requeue", "fault_requeue",
                  "done")


# The SLO objectives in the reference's order (csrc/events.h
# SloObjective, kSloObjectiveNames): ``telemetry/slo.py OBJECTIVES``.
SLO_OBJECTIVES = ("serving_p99_ms", "step_time_ewma_ms",
                  "overlap_efficiency", "queued_idle_share", "stall_ms")
# The rank-seconds ledger's buckets in the reference's order
# (csrc/events.cc kRankBucketNames): ``telemetry/fleet.py BUCKETS``.
RANK_BUCKETS = ("compute", "exposed_wire", "negotiation", "serving_prefill",
                "serving_decode", "serving_queued", "stall", "idle",
                "unattributed")


def _name(table, index):
    return table[index] if 0 <= index < len(table) else "unknown"


class EventRing:
    def __init__(self):
        self._lock = threading.Lock()
        self._slots = [None] * CAPACITY
        self._head = 0      # next sequence number
        self._cursor = 0    # drain position
        self._floor = 0     # reset() hides everything before this

    def record(self, type, a=0, b=0, c=0, d=0, ts_us=None):
        """Record one event, stamped now or at ``ts_us`` (steady-clock
        microseconds: a CUDA span's end, known once its events
        completed)."""
        ts = time.monotonic_ns() // 1000 if ts_us is None else int(ts_us)
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
    if type == "wire_span":
        out["plane"], out["channels"] = args[0] & 1, args[0] >> 1
    elif type == "phase":
        out["phase_name"] = CONTROL_PHASES[args[0]]
    elif type == "request":
        out["phase_name"] = REQUEST_PHASES[args[0]]
    elif type == "slo_breach":
        out["objective_name"] = _name(SLO_OBJECTIVES, args[0])
        out["phase_name"] = _name(RANK_BUCKETS, args[3])
    return out


RING = EventRing()
record = RING.record
peek = RING.peek
drain = RING.drain


def blackbox_dir():
    """The dump directory, or None when dumps are off."""
    d = os.environ.get("HOROVOD_BLACKBOX_DIR", "")
    if d in ("off", "none", "0"):
        return None
    return d or os.path.join(os.environ.get("TMPDIR") or "/tmp",
                             "hvdtpu_blackbox")


def dump_blackbox(rank, size, epoch, kind, certain, ranks, detect_ms,
                  reason):
    """Append the header and the ring to this rank's black-box file;
    returns its path, or None when dumps are off or the file cannot be
    opened (a warning on stderr, as the reference's)."""
    d = blackbox_dir()
    if d is None:
        return None
    path = os.path.join(d, f"blackbox-rank{rank}.jsonl")
    header = {"kind": "blackbox_header", "rank": rank, "size": size,
              "epoch": epoch, "unix_us": time.time_ns() // 1000,
              "steady_us": time.monotonic_ns() // 1000,
              "fault": {"kind": kind, "certain": bool(certain),
                        "ranks": [int(r) for r in ranks],
                        "detect_ms": int(detect_ms), "reason": reason}}
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(header, separators=(",", ":")) + "\n")
            for ev in peek():
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")
    except OSError as e:
        print(f"black-box dump skipped: cannot write {path} ({e})",
              file=sys.stderr)
        return None
    return path
