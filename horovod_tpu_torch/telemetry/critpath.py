"""Cross-rank critical-path attribution over step windows.

The port's own copy of ``horovod_tpu/telemetry/critpath.py``, over the
dumps the port's lane writes (``common/events.py``: the black box at a
fault, :func:`write_event_dump` of a live rank), whose ``wire_span``,
``wait``, ``negotiate_*``, ``stall`` and ``inject`` events have the
reference's fields.

The straggler table (``report.py``) attributes by *arrival order* at
the coordinator — who submitted last. This module attributes at *span
granularity*: per step, which rank — and which phase of that rank's
step — actually bounded the step's wall time. It consumes per-rank
event-ring dumps in the black-box schema (``step_begin``/``step_end``
windows from ``hvdtpu_step_mark`` plus the ``wire_span``/
``negotiate_*``/``stall``/``retry_window``/``inject`` events inside
them), merges them onto one wall axis via the header's
``(unix_us, steady_us)`` anchor pair (the r15 CLOCK_SYNC contract),
and decomposes each rank's step window into four phases::

    wire        = interval union of its wire spans (wall time with
                  >= 1 transfer in flight — the overlap ledger's
                  "exposed" measure, recomputed offline)
    negotiation = union of negotiate_begin -> negotiate_end cycles
    stall       = union of recorded stall evidence: stall events,
                  healing-ladder retry windows, and the gap after an
                  injected chaos delay
    compute     = window - union(everything above): time the runtime
                  recorded NO activity for — local work (or an
                  uninstrumented sleep)

**Blocking rank**: in a synchronous step, a rank's wire spans stretch
to absorb waiting for slower peers, so wire time is where OTHER ranks'
slowness pools. The rank that bounded the step is the one with the
most NON-wire time (``window - wire``) — everyone else was, for that
long, waiting on the wire for it. **Blocking phase** is the largest
share among that rank's four phases (wire wins only when the step is
genuinely transport-bound on the blocking rank too).

Phases may overlap on the wall clock (a negotiation cycle can run
under a wire span of the previous collective), so per-rank shares need
not sum to the window; ``compute`` is always the exact remainder of
the union of the other three.

CLI: ``python -m horovod_tpu_torch.telemetry.report --critical-path
<dumps-or-dir>``. Dumps come from a fault (the lane's black box) or
from a live rank via :func:`write_event_dump` (what
``telemetry/perf_smoke.py`` uses).
"""

import json
import os
import time
from collections import defaultdict

from horovod_tpu_torch.telemetry import postmortem

# ``inject`` "action" values (the reference's FaultAction) that sleep
# between the inject event and the next lane activity — the gap is
# stall evidence. stop (1) SIGSTOPs the whole process for its param (the
# reference's; the port waits for ROADMAP.md L8); delay (4) sleeps the
# lane thread. The others kill the process or are instantaneous.
_INJECT_GAP_ACTIONS = (1, 4)


def union_measure(intervals, lo=None, hi=None):
    """Total length of the union of ``[start, end)`` intervals, clipped
    to ``[lo, hi]`` when given. Abutting intervals merge, nested ones
    collapse, zero-length ones contribute nothing — the same sweep the
    lane's overlap ledger runs (``common/metrics.py OverlapLedger``)."""
    clipped = []
    for a, b in intervals:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            clipped.append((a, b))
    clipped.sort()
    total = 0
    cur_lo, cur_hi = None, None
    for a, b in clipped:
        if cur_hi is None:
            cur_lo, cur_hi = a, b
        elif a <= cur_hi:
            cur_hi = max(cur_hi, b)
        else:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def _wall(ev, hdr):
    return postmortem._wall_us(ev, hdr)


def step_windows(dump):
    """``{step_id: (begin_wall_us, end_wall_us)}`` from one rank's
    dump. A ``step_end`` whose ``step_begin`` aged out of the ring
    (window spanning a ring wrap) opens at the dump's earliest event —
    the window is truncated, not dropped, so a long step that evicted
    its own begin mark still attributes."""
    hdr = dump["header"]
    events = dump["events"]
    first_wall = _wall(events[0], hdr) if events else 0
    begins, windows = {}, {}
    for ev in events:
        if ev.get("type") == "step_begin":
            begins[ev.get("step")] = _wall(ev, hdr)
        elif ev.get("type") == "step_end":
            sid = ev.get("step")
            windows[sid] = (begins.pop(sid, first_wall), _wall(ev, hdr))
    return windows


def intersect_intervals(a, b):
    """Pairwise intersection of two ``[start, end)`` interval lists —
    the offline twin of the overlap ledger's exposure clip (wire time
    under the union of API-thread waits)."""
    a = sorted((lo, hi) for lo, hi in a if hi > lo)
    b = sorted((lo, hi) for lo, hi in b if hi > lo)
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def phase_intervals(dump):
    """Wall-axis intervals per phase (``wire``/``negotiation``/
    ``stall``, plus the raw ``wait`` blocks) for one rank's dump;
    ``compute`` is derived later as the per-window remainder.

    When the dump carries ``wait`` events (hvdtpu_wait blocks, r23),
    ``wire`` is the ledger's *exposed* measure — wire spans clipped to
    the union of the waits — so a fused lane whose transfers drained
    under host compute attributes as compute-bound, exactly like the
    live overlap ledger. Dumps without wait events (pre-r23, or
    synthesized) keep the raw span union."""
    hdr = dump["header"]
    out = {"wire": [], "negotiation": [], "stall": [], "wait": []}
    spans = []
    nego_begin = None
    prev_wall = None
    pending_delay = None
    for ev in dump["events"]:
        wall = _wall(ev, hdr)
        typ = ev.get("type")
        if pending_delay is not None and typ != "inject":
            # An injected straggler delay sleeps between the inject
            # event and whatever the loop does next: that gap IS the
            # stall (the chaos lane's ground truth).
            # A wire_span (and a wait) is stamped at its END — close
            # the gap at the interval's START so the stall does not
            # swallow wire time.
            end = wall
            if typ in ("wire_span", "wait"):
                end = wall - int(ev.get("dur_us", 0))
            if end > pending_delay:
                out["stall"].append((pending_delay, end))
            pending_delay = None
        if typ == "wire_span":
            dur = int(ev.get("dur_us", 0))
            spans.append((wall - dur, wall))
        elif typ == "wait":
            dur = int(ev.get("dur_us", 0))
            out["wait"].append((wall - dur, wall))
        elif typ == "negotiate_begin":
            nego_begin = wall
        elif typ == "negotiate_end":
            if nego_begin is not None:
                out["negotiation"].append((nego_begin, wall))
                nego_begin = None
        elif typ == "stall":
            out["stall"].append(
                (wall - int(ev.get("waited_s", 0)) * 1_000_000, wall))
        elif typ == "retry_window":
            out["stall"].append(
                (wall - int(ev.get("window_ms", 0)) * 1000, wall))
        elif typ == "inject" and ev.get("action") in _INJECT_GAP_ACTIONS:
            pending_delay = wall
        prev_wall = wall
    if pending_delay is not None and prev_wall is not None:
        out["stall"].append((pending_delay, prev_wall))
    out["wire"] = (intersect_intervals(spans, out["wait"])
                   if out["wait"] else spans)
    return out


def critical_path(paths_or_dir, dump_index=-1):
    """Merge per-rank dumps and attribute, per step, the blocking rank
    and phase. Returns::

        {"ranks": [...],
         "steps": [{"step": id, "wall_ms": ..., "blocking_rank": r,
                    "phase": "compute|wire|negotiation|stall",
                    "per_rank": {rank: {window_ms, wire_ms,
                                        negotiation_ms, stall_ms,
                                        compute_ms, self_ms}}}, ...],
         "blocking_counts": {rank: steps it bounded},
         "phase_counts": {phase: steps it bounded}}

    ``self_ms`` is ``window - wire`` — the rank's own contribution to
    step length; its argmax is the blocking rank (module docstring).
    Steps are matched across ranks by the monotonic step id (every
    rank's marks count the same boundaries when one driver — StepTimer
    or the eager optimizer — paces the SPMD loop).
    """
    paths = postmortem.collect_paths(paths_or_dir)
    dumps = {}
    for path in paths:
        loaded = postmortem.load_blackbox(path)
        if not loaded:
            continue
        dump = loaded[dump_index]
        dumps[dump["header"].get("rank", -1)] = dump
    if not dumps:
        raise ValueError(f"no event dumps found in {paths_or_dir!r}")

    windows = {r: step_windows(d) for r, d in dumps.items()}
    phases = {r: phase_intervals(d) for r, d in dumps.items()}
    step_ids = sorted(set().union(*(set(w) for w in windows.values())))

    steps = []
    blocking_counts = defaultdict(int)
    phase_counts = defaultdict(int)
    for sid in step_ids:
        per_rank = {}
        for rank, w in windows.items():
            if sid not in w:
                continue
            lo, hi = w[sid]
            shares = {
                ph: union_measure(phases[rank][ph], lo, hi)
                for ph in ("wire", "negotiation", "stall")
            }
            busy = union_measure(
                phases[rank]["wire"] + phases[rank]["negotiation"]
                + phases[rank]["stall"], lo, hi)
            shares["compute"] = (hi - lo) - busy
            per_rank[rank] = {
                "window_ms": round((hi - lo) / 1000.0, 3),
                "self_ms": round((hi - lo - shares["wire"]) / 1000.0, 3),
                **{f"{ph}_ms": round(v / 1000.0, 3)
                   for ph, v in shares.items()},
            }
        if not per_rank:
            continue
        blocking = max(per_rank,
                       key=lambda r: (per_rank[r]["self_ms"],
                                      per_rank[r]["window_ms"]))
        b = per_rank[blocking]
        phase = max(("wire", "negotiation", "stall", "compute"),
                    key=lambda ph: b[f"{ph}_ms"])
        blocking_counts[blocking] += 1
        phase_counts[phase] += 1
        steps.append({
            "step": sid,
            "wall_ms": max(d["window_ms"] for d in per_rank.values()),
            "blocking_rank": blocking,
            "phase": phase,
            "per_rank": per_rank,
        })
    return {
        "ranks": sorted(dumps),
        "steps": steps,
        "blocking_counts": dict(blocking_counts),
        "phase_counts": dict(phase_counts),
    }


def format_critical_path(analysis, max_steps=40):
    """Operator-facing rendering: one line per step plus the summary
    attribution."""
    lines = []
    bc = analysis["blocking_counts"]
    if bc:
        worst = max(bc, key=bc.get)
        lines.append(
            f"critical path: rank {worst} bounded {bc[worst]} of "
            f"{len(analysis['steps'])} steps "
            f"(phases: {dict(sorted(analysis['phase_counts'].items()))})")
    lines.append(f"{'step':>6} {'wall ms':>9} {'rank':>5} {'phase':>12} "
                 f"{'self ms':>9} {'wire ms':>9} {'compute ms':>11}")
    for s in analysis["steps"][-max_steps:]:
        b = s["per_rank"][s["blocking_rank"]]
        lines.append(
            f"{s['step']:>6} {s['wall_ms']:>9.3f} "
            f"{s['blocking_rank']:>5} {s['phase']:>12} "
            f"{b['self_ms']:>9.3f} {b['wire_ms']:>9.3f} "
            f"{b['compute_ms']:>11.3f}")
    return "\n".join(lines)


def write_event_dump(path, rank, size, events, epoch=0):
    """Write a LIVE rank's ring events (``hvd.events()`` /
    ``events_drain()`` dicts) in the black-box dump schema, so the
    critical-path and post-mortem tooling consume healthy-run traces
    exactly like fault dumps. The ``(unix_us, steady_us)`` anchor pair
    is sampled together here — call it on the rank whose events these
    are (the anchor maps THAT process's steady clock to the wall)."""
    header = {
        "kind": "blackbox_header", "rank": rank, "size": size,
        "epoch": epoch, "unix_us": int(time.time() * 1e6),
        "steady_us": _steady_us(), "fault": {},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return path


def _steady_us():
    """The same steady clock the lane stamps events with
    (CLOCK_MONOTONIC microseconds, ``common/metrics.py now_us``)."""
    return int(time.clock_gettime(time.CLOCK_MONOTONIC) * 1e6)
