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
``ranks_blacklisted`` (old ranks a re-formation left out, a shrink's
victims too), ``ranks_rejoined`` (joiner slots it absorbed through the
parole door), the ``detect_us`` histogram of a fault's detection, and
the port's ``resets`` (re-formations and elastic re-inits) and
``last_fault`` record); ``wire`` (``csrc/metrics.cc:335-350``: bytes
sent and received, ``tx_bytes``/``rx_bytes`` on the wire and
``tx_logical_bytes``/``rx_logical_bytes`` before the codec, their
``compression_ratio``, and the ``cross_*`` twins of the hierarchical
allreduce's cross hop, a part of the totals), booked by the data plane
from the segment math, since NCCL and gloo report no bytes
(``data_plane.py``); ``errors``; ``knobs`` (the live
``fusion_threshold_bytes`` and ``cycle_time_ms``, and ``wire_compression``,
``wire_codec``, ``cross_plane``, ``hier_split`` and ``cross_compression``;
the autotuner moves the first two, the codec and the split).
``control_phase`` also holds ``parole_freeze``: the door's frozen joiner
count read at an epoch transition.

The ``wire`` section also holds ``overlap``, the per-step overlap
ledger (``csrc/metrics.h:246-300``, :class:`OverlapLedger`): per step
window (``basics.step_mark``) and per plane (``intra``; ``cross``, the
hierarchical allreduce's cross hop), ``total`` is the sum of the wire
spans (one a collective call), ``exposed`` the part of them that lies
under the union of the ``wait`` spans (a caller blocked in a handle's
``wait``), ``hidden = total - exposed`` exactly; span time outside any
window, or clipped off one, is ``unattributed_us``, so ``total`` plus
``unattributed_us`` is the ``wire_us`` histogram's sum.

Left out, with what they wait for: the ``wire`` section's per-channel
and syscall tables (the reference's socket stripes, ROADMAP.md L8), the
``elastic`` section's wire counters ``heals``, ``retries`` and
``crc_errors`` (L8), and the ring and stripe knobs (L8).

``wire_us`` of a CPU collective is the host time of the gloo call. Of a
CUDA collective it is the time between two CUDA events the lane records
on its stream around the NCCL call: from the stream reaching the call
to the collective's end on the device. The registry reads them only
once the second has completed (``Event.query``), at the end of each
lane cycle, at each snapshot and at each step mark, so it adds no host
synchronisation. The waits are on the host clock, so the ledger puts a
CUDA span there through an anchor: each step mark records a CUDA event
on an idle stream of its own beside the host time of the record, and a
span recorded while that anchor stands starts at the anchor's host time
plus the device time from the anchor event to the span's start event
(``Event.elapsed_time``). A span with no anchor (none marked yet on
that card) books unattributed; a span whose end completes after its
window closed is clipped off it (unattributed), as the reference books
a racing span.

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
# The wire knobs before init (the reference's defaults).
WIRE_KNOBS_UNSET = {"wire_compression": False, "wire_codec": "off",
                    "cross_plane": "auto", "hier_split": 0,
                    "cross_compression": False}


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


class OverlapLedger:
    """The per-step overlap ledger (``OverlapLedger``, csrc/metrics.cc):
    wire spans and wait spans of one step window, folded per plane at
    the window's end. Any thread."""

    # Past this many spans (or waits) in one open window, a span books
    # unattributed and a wait is dropped (a window left open forever).
    MAX_SPANS = 65536

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._open = False
            self._begin_us = 0
            self.steps = 0
            self.unattributed_us = 0
            self._spans = ([], [])
            self._waits = []
            self.planes = [dict.fromkeys(
                ("exposed_us", "hidden_us", "total_us", "last_exposed_us",
                 "last_hidden_us", "last_total_us"), 0) for _ in range(2)]

    def step_begin(self, ts_us):
        with self._lock:
            self._open = True
            self._begin_us = ts_us
            for spans in self._spans:
                spans.clear()
            self._waits.clear()

    def step_end(self, ts_us):
        """Close the window: fold its spans per plane. Returns the
        window's length in us, or -1 when none was open."""
        with self._lock:
            if not self._open:
                return -1
            self._open = False
            lo0 = self._begin_us
            waits = _union([(max(a, lo0), min(b, ts_us))
                            for a, b in self._waits])
            self._waits.clear()
            for plane, spans in enumerate(self._spans):
                total = exposed = 0
                clipped = []
                for a, b in spans:
                    lo, hi = max(a, lo0), min(b, ts_us)
                    if hi < lo:       # wholly outside (a racing span)
                        self.unattributed_us += b - a
                        continue
                    clipped.append((lo, hi))
                    total += hi - lo
                    self.unattributed_us += (b - a) - (hi - lo)
                for lo, hi in clipped:
                    for wa, wb in waits:
                        overlap = min(hi, wb) - max(lo, wa)
                        if overlap > 0:
                            exposed += overlap
                p = self.planes[plane]
                p["last_total_us"], p["last_exposed_us"] = total, exposed
                p["last_hidden_us"] = total - exposed
                p["total_us"] += total
                p["exposed_us"] += exposed
                p["hidden_us"] += total - exposed
                spans.clear()
            self.steps += 1
            return ts_us - lo0

    def add_span(self, plane, start_us, end_us):
        """One completed wire span of ``plane`` (1: the cross hop)."""
        if end_us < start_us:
            return
        spans = self._spans[1 if plane == 1 else 0]
        with self._lock:
            if not self._open or end_us <= self._begin_us \
                    or len(spans) >= self.MAX_SPANS:
                self.unattributed_us += end_us - start_us
                return
            spans.append((start_us, end_us))

    def add_unattributed(self, us):
        """Span time the ledger cannot place on the host clock."""
        with self._lock:
            self.unattributed_us += us

    def add_wait(self, start_us, end_us):
        """One caller's blocked interval; dropped outside a window."""
        if end_us <= start_us:
            return
        with self._lock:
            if self._open and end_us > self._begin_us \
                    and len(self._waits) < self.MAX_SPANS:
                self._waits.append((start_us, end_us))

    def json(self):
        """The snapshot's ``wire.overlap`` dict, the reference's keys
        and roundings."""
        with self._lock:
            exp = sum(p["exposed_us"] for p in self.planes)
            hid = sum(p["hidden_us"] for p in self.planes)
            out = {"steps": self.steps,
                   "unattributed_us": self.unattributed_us,
                   "exposed_wire_ms": round(exp / 1000.0, 3),
                   "hidden_wire_ms": round(hid / 1000.0, 3),
                   "overlap_efficiency": round(hid / (exp + hid), 6)
                   if exp + hid else 0.0}
            for name, p in zip(("intra", "cross"), self.planes):
                out[name] = {
                    "exposed_us": p["exposed_us"],
                    "hidden_us": p["hidden_us"],
                    "total_us": p["total_us"],
                    "overlap_efficiency": round(
                        p["hidden_us"] / p["total_us"], 6)
                    if p["total_us"] else 0.0,
                    "last_exposed_us": p["last_exposed_us"],
                    "last_hidden_us": p["last_hidden_us"],
                    "last_total_us": p["last_total_us"]}
        return out


def _union(intervals):
    """The sorted disjoint union of ``[a, b)`` intervals (empty ones
    dropped)."""
    out = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Metrics:
    """The process's registry (:data:`REGISTRY`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cuda_spans = collections.deque()
        # (anchor event, its host us) per CUDA device: the latest step
        # mark's (module docstring).
        self._anchors = {}
        self._anchor_streams = {}
        self.ledger = OverlapLedger()
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
        self.ledger.reset()
        with self._lock:
            self.ops = {dev: [[0, 0, 0] for _ in OP_CLASSES]
                        for dev in ("cpu", "cuda")}
            for h in (self.negotiation_us, self.queue_us, self.wire_us,
                      self.straggler_skew_us, self.execute_us,
                      self.fault_detect_us,
                      *self.control_phase_us.values()):
                h.reset()
            self.faults_detected = self.faults_recovered = 0
            self.ranks_blacklisted = self.ranks_rejoined = self.resets = 0
            self.cycles = self.cycle_stalls = self.cycle_overrun_us = 0
            self.fused_responses = 0
            # tx, rx, tx logical, rx logical; then the cross hop's.
            self.wire_bytes = [0] * 8
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

    def account_wire(self, tx, rx, tx_logical, rx_logical, cross=False):
        """One hop's bytes on the wire and before the codec; ``cross``
        books them under the cross hop too."""
        with self._lock:
            for base in (0, 4) if cross else (0,):
                for i, v in enumerate((tx, rx, tx_logical, rx_logical)):
                    self.wire_bytes[base + i] += int(v)

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

    def record_reset(self, recovered=False, blacklisted=0, rejoined=0):
        """The lane re-formed (``reinit``) or re-initialized at a new
        epoch: ``recovered`` after a fault, leaving ``blacklisted`` old
        ranks out and absorbing ``rejoined`` joiner slots."""
        with self._lock:
            self.resets += 1
            self.faults_recovered += int(bool(recovered))
            self.ranks_blacklisted += blacklisted
            self.ranks_rejoined += rejoined

    def record_phase(self, phase, dur_us, emit_event=True):
        """One control-phase duration, and its ``phase`` event unless the
        cycle was idle (``RecordControlPhase``)."""
        self.record(self.control_phase_us[phase], dur_us)
        if emit_event:
            events.record("phase", CONTROL_PHASES.index(phase), 0,
                          int(dur_us))

    def wire_span(self, plane, start_us, end_us):
        """A host-timed collective call (gloo): its ``wire_us``, its
        ledger span and its ``wire_span`` event."""
        self.record(self.wire_us, end_us - start_us)
        self.ledger.add_span(plane, start_us, end_us)
        events.record("wire_span", plane | 1 << 1, end_us - start_us,
                      ts_us=end_us)

    def cuda_anchor(self, device):
        """Record the step mark's anchor on ``device``: a CUDA event on
        an idle stream of the registry's own, beside the host time."""
        import torch

        with self._lock:
            stream = self._anchor_streams.get(device)
            if stream is None:
                stream = self._anchor_streams[device] = torch.cuda.Stream(
                    device)
            event = torch.cuda.Event(enable_timing=True)
            event.record(stream)
            self._anchors[device] = (event, now_us())

    def cuda_span(self, start, end, plane=0):
        """A CUDA collective's (start, end) timing events, with the
        anchor standing on their device."""
        with self._lock:
            self._cuda_spans.append(
                (start, end, plane, self._anchors.get(start.device)))

    def drain_cuda_spans(self):
        """Record the spans whose end event has completed, in stream
        order; never waits."""
        done = []
        with self._lock:
            spans = self._cuda_spans
            while spans and spans[0][1].query():
                done.append(spans.popleft())
        for start, end, plane, anchor in done:
            dur = int(start.elapsed_time(end) * 1e3)
            self.record(self.wire_us, dur)
            if anchor is None:
                self.ledger.add_unattributed(dur)
                continue
            event, host_us = anchor
            begin = host_us + int(round(event.elapsed_time(start) * 1e3))
            self.ledger.add_span(plane, begin, begin + dur)
            events.record("wire_span", plane | 1 << 1, dur,
                          ts_us=begin + dur)

    # ---- the snapshot --------------------------------------------------

    def snapshot(self, initialized=False, rank=-1, size=0,
                 fusion_threshold_bytes=0, cycle_time_ms=0.0, cache=None,
                 epoch=0, last_fault=None, wire_knobs=None):
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
            w = self.wire_bytes
            out["wire"] = {}
            for prefix, (tx, rx, txl, rxl) in (("", w[:4]),
                                               ("cross_", w[4:])):
                out["wire"].update({
                    f"{prefix}tx_bytes": tx, f"{prefix}rx_bytes": rx,
                    f"{prefix}tx_logical_bytes": txl,
                    f"{prefix}rx_logical_bytes": rxl,
                    f"{prefix}compression_ratio":
                        round(tx / txl, 6) if txl else 1.0})
            out["elastic"] = {
                "epoch": epoch, "faults_detected": self.faults_detected,
                "faults_recovered": self.faults_recovered,
                "ranks_blacklisted": self.ranks_blacklisted,
                "ranks_rejoined": self.ranks_rejoined,
                "resets": self.resets,
                "last_fault": last_fault,
                "detect_us": self.fault_detect_us.json()}
            out["wire"]["overlap"] = self.ledger.json()
            out["errors"] = self.errors
            out["knobs"] = {"fusion_threshold_bytes": fusion_threshold_bytes,
                            "cycle_time_ms": float(cycle_time_ms),
                            **(wire_knobs or WIRE_KNOBS_UNSET)}
        return out


REGISTRY = Metrics()
