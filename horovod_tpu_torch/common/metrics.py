"""The lane's metrics registry: op counters, latency histograms, fusion,
cycle and cache accounting, and the coordinator's straggler table.

Counterpart of ``csrc/metrics.{h,cc}``. :meth:`Metrics.snapshot` returns
the reference's dict (``hvd.metrics()``): ``initialized``, ``rank``,
``size``; ``ops`` (CPU tensors, on gloo) and ``device_ops`` (CUDA
tensors, on NCCL), each ``{op class: {responses, tensors, bytes}}``
with the classes that moved; the histograms ``negotiation_us`` (one
active cycle's control exchange), ``queue_us`` (a tensor's enqueue to
the start of its response's execution) and ``wire_us`` (one collective
call); ``control_phase`` (the coordinator's gather and broadcast, the
init's rendezvous, a re-formation's reinit, and the port's own
``shutdown`` and ``nccl_init``: the lane's teardown and the NCCL
communicator's creation); ``fusion``; ``cycle``; ``cache``; ``straggler``
(which rank completed a tensor last, on the coordinator); ``elastic``
(``epoch``, ``faults_detected``, ``faults_recovered``,
``ranks_blacklisted``, ``ranks_rejoined``, the ``detect_us`` histogram
of a fault's detection, and the port's ``resets`` (re-formations and
elastic re-inits) and ``last_fault`` record); ``errors``; ``knobs``
(``fusion_threshold_bytes``, ``cycle_time_ms``).

Left out, with what they wait for: ``wire`` (the host ring's transport
bytes, syscalls and overlap ledger: the port has no host ring, ROADMAP.md
L8), the ``elastic`` section's wire counters ``heals``, ``retries`` and
``crc_errors`` (L8), and the wire and ring knobs (L8).

``wire_us`` of a CPU collective is the host time of the gloo call. Of a
CUDA collective it is the time between two CUDA events the lane records
on its stream around the NCCL call: from the stream reaching the call
to the collective's end on the device. The registry reads them only
once the second has completed (``Event.query``), at the end of each
lane cycle and at each snapshot, so it adds no host synchronisation.

Counters live for the process, across init and shutdown, as the
reference's do; :meth:`Metrics.reset` zeroes them (``hvd.metrics_reset``).
The lane thread records; any thread may snapshot.
"""

import collections
import threading
import time

from horovod_tpu_torch.common import events
from horovod_tpu_torch.common.message import ResponseType

# Op classes by the reference's ResponseType order (csrc/message.h).
OP_CLASSES = ("allreduce", "allgather", "broadcast", "alltoall",
              "reducescatter", "join", "barrier", "error")
_OP_CLASS = {ResponseType.ALLREDUCE: 0, ResponseType.ALLGATHER: 1,
             ResponseType.BROADCAST: 2, ResponseType.ALLTOALL: 3,
             ResponseType.REDUCESCATTER: 4, ResponseType.JOIN: 5,
             ResponseType.BARRIER: 6, ResponseType.ERROR: 7}
CONTROL_PHASES = events.CONTROL_PHASES


def op_class(response_type):
    """The reference's op-class index of a port response type."""
    return _OP_CLASS[response_type]


def now_us():
    """Steady-clock microseconds (``MetricsNowUs``)."""
    return time.monotonic_ns() // 1000


class LatencyHistogram:
    """Log2 buckets of microseconds: bucket i holds [2^i, 2^(i+1));
    percentiles are the bucket's upper bound, clamped to the max."""

    BUCKETS = 40

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = self.sum = self.min = self.max = 0
        self.buckets = [0] * self.BUCKETS

    def record(self, us):
        us = max(int(us), 0)
        self.min = us if self.count == 0 else min(self.min, us)
        self.count += 1
        self.sum += us
        self.max = max(self.max, us)
        self.buckets[min(max(us, 1).bit_length() - 1, self.BUCKETS - 1)] += 1

    def _percentile(self, q):
        if self.count == 0:
            return 0
        target = max(int(q * self.count), 1)
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return min(1 << (i + 1), self.max)
        return self.max

    def json(self):
        return {"count": self.count, "sum_us": self.sum,
                "min_us": self.min if self.count else 0,
                "max_us": self.max, "p50_us": self._percentile(0.50),
                "p90_us": self._percentile(0.90),
                "p99_us": self._percentile(0.99)}


class Metrics:
    """The process's registry (:data:`REGISTRY`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cuda_spans = collections.deque()
        self.negotiation_us = LatencyHistogram()
        self.queue_us = LatencyHistogram()
        self.wire_us = LatencyHistogram()
        self.straggler_skew_us = LatencyHistogram()
        self.control_phase_us = {p: LatencyHistogram()
                                 for p in CONTROL_PHASES}
        # Host time the lane thread spends executing one response (on
        # the card: queuing its work). Not in the reference's snapshot;
        # chip_smoke.py reads it.
        self.execute_us = LatencyHistogram()
        self.fault_detect_us = LatencyHistogram()
        self.reset()

    def reset(self):
        with self._lock:
            self.ops = {dev: [[0, 0, 0] for _ in OP_CLASSES]
                        for dev in ("cpu", "cuda")}
            for h in (self.negotiation_us, self.queue_us, self.wire_us,
                      self.straggler_skew_us, self.execute_us,
                      self.fault_detect_us,
                      *self.control_phase_us.values()):
                h.reset()
            self.faults_detected = self.faults_recovered = 0
            self.ranks_blacklisted = self.resets = 0
            self.cycles = self.cycle_stalls = self.cycle_overrun_us = 0
            self.fused_responses = 0
            self.fusion_fill_bytes = self.fusion_capacity_bytes = 0
            self.errors = 0
            self.straggler_counts = []

    # ---- recorders (the lane thread) ----------------------------------

    def record(self, hist, us):
        with self._lock:
            hist.record(us)

    def account_response(self, response_type, device, tensors, nbytes,
                         ok=True):
        """One executed response (``AccountResponse``)."""
        with self._lock:
            c = self.ops[device][op_class(response_type)]
            c[0] += 1
            c[1] += tensors
            c[2] += nbytes
            if not ok:
                self.errors += 1

    def account_fusion(self, fill_bytes, capacity_bytes):
        with self._lock:
            self.fused_responses += 1
            self.fusion_fill_bytes += fill_bytes
            self.fusion_capacity_bytes += capacity_bytes

    def account_cycle(self, elapsed_us, budget_us):
        with self._lock:
            self.cycles += 1
            if elapsed_us > budget_us:
                self.cycle_stalls += 1
                self.cycle_overrun_us += int(elapsed_us - budget_us)

    def record_straggler(self, rank, skew_us):
        with self._lock:
            if len(self.straggler_counts) <= rank:
                self.straggler_counts += [0] * (
                    rank + 1 - len(self.straggler_counts))
            self.straggler_counts[rank] += 1
            self.straggler_skew_us.record(skew_us)

    def record_fault(self, detect_us):
        """A collective failed on a lost peer."""
        with self._lock:
            self.faults_detected += 1
            self.fault_detect_us.record(detect_us)

    def record_reset(self, recovered_ranks=0):
        """The lane re-formed (``reinit``) or re-initialized at a new
        epoch; ``recovered_ranks`` the dead ranks it left out."""
        with self._lock:
            self.resets += 1
            if recovered_ranks:
                self.faults_recovered += 1
                self.ranks_blacklisted += recovered_ranks

    def record_phase(self, phase, dur_us, emit_event=True):
        """One control-phase duration, and its ``phase`` event unless the
        cycle was idle (``RecordControlPhase``)."""
        self.record(self.control_phase_us[phase], dur_us)
        if emit_event:
            events.record("phase", CONTROL_PHASES.index(phase), 0,
                          int(dur_us))

    def cuda_span(self, start, end):
        """A CUDA collective's (start, end) timing events."""
        with self._lock:
            self._cuda_spans.append((start, end))

    def drain_cuda_spans(self):
        """Record the spans whose end event has completed, in stream
        order; never waits."""
        with self._lock:
            spans = self._cuda_spans
            while spans and spans[0][1].query():
                start, end = spans.popleft()
                self.wire_us.record(start.elapsed_time(end) * 1e3)

    # ---- the snapshot --------------------------------------------------

    def snapshot(self, initialized=False, rank=-1, size=0,
                 fusion_threshold_bytes=0, cycle_time_ms=0.0, cache=None,
                 epoch=0, last_fault=None):
        """The reference's snapshot dict, less the omitted sections;
        ratios rounded to the reference's six decimals."""
        self.drain_cuda_spans()
        with self._lock:
            out = {"initialized": initialized, "rank": rank, "size": size}
            for key, dev in (("ops", "cpu"), ("device_ops", "cuda")):
                out[key] = {OP_CLASSES[i]: {"responses": r, "tensors": t,
                                            "bytes": b}
                            for i, (r, t, b) in enumerate(self.ops[dev])
                            if r or t or b}
            out["negotiation_us"] = self.negotiation_us.json()
            out["queue_us"] = self.queue_us.json()
            out["wire_us"] = self.wire_us.json()
            out["control_phase"] = {p: h.json() for p, h in
                                    self.control_phase_us.items()
                                    if h.count}
            cap = self.fusion_capacity_bytes
            out["fusion"] = {
                "fused_responses": self.fused_responses,
                "fill_bytes": self.fusion_fill_bytes,
                "capacity_bytes": cap,
                "fill_ratio": round(self.fusion_fill_bytes / cap, 6) if cap
                else 0.0}
            out["cycle"] = {"count": self.cycles,
                            "stalls": self.cycle_stalls,
                            "overrun_us": self.cycle_overrun_us}
            hits, misses, entries, hit_bytes = cache or (0, 0, 0, 0)
            lookups = hits + misses
            out["cache"] = {"hits": hits, "misses": misses,
                            "entries": entries, "hit_bytes": hit_bytes,
                            "hit_rate": round(hits / lookups, 6) if lookups
                            else 0.0}
            out["straggler"] = {
                "last_rank_counts": list(self.straggler_counts),
                "skew_us": self.straggler_skew_us.json()}
            out["elastic"] = {
                "epoch": epoch, "faults_detected": self.faults_detected,
                "faults_recovered": self.faults_recovered,
                "ranks_blacklisted": self.ranks_blacklisted,
                "ranks_rejoined": 0, "resets": self.resets,
                "last_fault": last_fault,
                "detect_us": self.fault_detect_us.json()}
            out["errors"] = self.errors
            out["knobs"] = {"fusion_threshold_bytes": fusion_threshold_bytes,
                            "cycle_time_ms": float(cycle_time_ms)}
        return out


REGISTRY = Metrics()
