"""Request-scoped tracing for the serving lane: per-request span
ledgers and their cross-rank stitching.

The port's own copy of ``horovod_tpu/telemetry/reqtrace.py``'s recording
half and of the dump readers the serving smoke needs. The serving lane
records one ``request`` event (phase, rid, aux) per lifecycle
transition on the port's event ring (``common/events.py``): each marks
the instant a request ENTERS a phase, so a rid's span ledger is the
gaps between its consecutive transitions, gap-free by construction.

Phases (:data:`REQUEST_PHASES`, the reference's order)::

    queued           admitted to the frontend's pending line
    prefill          prefill compute running for this request
    kv_ship          packed; KV payload in flight to its decode rank
    decode_wait      adopted/admitted, between decode steps
    decode_active    inside a decode step's batch
    evicted_requeue  LIFO-evicted; waiting for re-prefill
    fault_requeue    orphaned by a peer fault; re-queued
    done             terminal: completion reached the scoreboard

A rid's transitions happen on more than one rank (the frontend prefills
and scoreboards, a decode rank decodes), so :func:`write_dump` writes a
rank's request events with a (wall, monotonic) clock anchor and
:func:`stitch` merges the ranks' dumps on the wall axis. A decode rank
that died without dumping leaves its phases unobserved: the frontend's
phase before extends to its next transition (``fault_requeue``), so the
chains stay gap-free through the chaos they explain. The live side is
:func:`live_requests`, the debug server's ``/requests``.

The serving smoke's dumps are one JSON file a rank (:func:`write_dump`);
the readers also take the reference's format, the black-box JSONL files
of ``common/events.py dump_blackbox`` and ``telemetry/critpath.py
write_event_dump``, each event folded once by its seq a file.
:func:`tail_report` decomposes a latency band by phase and
:func:`format_requests` renders it (``python -m
horovod_tpu_torch.telemetry.report --requests``).
"""

import json
import os
import time
from collections import defaultdict

from horovod_tpu_torch.common import events
from horovod_tpu_torch.common.events import REQUEST_PHASES

TERMINAL_PHASE = "done"

# rid -> (phase, t_phase, t_first) on this process's monotonic clock:
# the /requests live table. Writers are the serving thread; readers (the
# debug server) copy under the GIL.
_live = {}
_tracing = None     # None: HOROVOD_EVENTS decides (on unless "0")


def tracing_enabled():
    """Whether request events reach the ring (``HOROVOD_EVENTS=0`` turns
    them off; :func:`set_tracing` overrides in-process)."""
    if _tracing is None:
        return os.environ.get("HOROVOD_EVENTS", "1") != "0"
    return _tracing


def set_tracing(on):
    """Turn request events on or off in-process (None: back to the
    environment's setting)."""
    global _tracing
    _tracing = None if on is None else bool(on)


def record_request(phase, rid, aux=0):
    """Record one lifecycle transition: ``rid`` enters ``phase`` now.

    Always updates the live in-flight table; emits the ring event while
    tracing is on. A ``done`` transition retires the rid from the live
    table. An unknown phase raises."""
    pid = REQUEST_PHASES.index(phase)
    if phase == TERMINAL_PHASE:
        _live.pop(rid, None)
    else:
        now = time.monotonic()
        prev = _live.get(rid)
        _live[rid] = (phase, now, prev[2] if prev else now)
    if tracing_enabled():
        events.record("request", pid, 0, int(rid), int(aux))


def forget_request(rid):
    """Drop a rid from the live table without a ``done`` transition (the
    duplicate-cancel path: another rank owns the completion)."""
    _live.pop(rid, None)


def live_requests(limit=64):
    """The in-flight table for ``/requests?n=``: a row per live rid with
    its phase, time in that phase and total age, oldest first, at most
    ``limit`` (<= 0: all)."""
    now = time.monotonic()
    rows = [{"rid": rid, "phase": ph,
             "phase_age_ms": round((now - t_ph) * 1000.0, 3),
             "age_ms": round((now - t0) * 1000.0, 3)}
            for rid, (ph, t_ph, t0) in list(_live.items())]
    rows.sort(key=lambda r: -r["age_ms"])
    return rows[:int(limit)] if int(limit) > 0 else rows


# ---- dumps and cross-rank stitching -----------------------------------


def write_dump(path, rank):
    """Write this process's request events (those still on the ring) to
    ``path`` as one JSON object: ``{"header": {"rank", "unix_us",
    "steady_us"}, "events": [...]}``, the header's pair anchoring the
    ring's monotonic clock to the wall clock."""
    header = {"rank": int(rank), "unix_us": time.time_ns() // 1000,
              "steady_us": time.monotonic_ns() // 1000}
    evs = [e for e in events.peek() if e["type"] == "request"]
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"header": header, "events": evs}, f)
    os.replace(tmp, path)
    return path


def _dump_paths(paths_or_dir):
    """The dump files of a directory (``*.json`` and black-box
    ``blackbox-*.jsonl``), or the paths given."""
    if isinstance(paths_or_dir, (str, os.PathLike)):
        paths_or_dir = [paths_or_dir]
    out = []
    for p in map(os.fspath, paths_or_dir):
        if os.path.isdir(p):
            out += sorted(os.path.join(p, n) for n in os.listdir(p)
                          if n.endswith(".json") or (
                              n.startswith("blackbox-")
                              and n.endswith(".jsonl")))
        else:
            out.append(p)
    return out


def _dumps(path):
    """The (header, events) dumps of one file: a black-box JSONL file
    holds one a fault, a :func:`write_dump` file one."""
    if path.endswith(".jsonl"):
        from horovod_tpu_torch.telemetry import postmortem

        return [(d["header"], d["events"])
                for d in postmortem.load_blackbox(path)]
    with open(path) as f:
        dump = json.load(f)
    return [(dump["header"], dump["events"])]


def _request_transitions(paths_or_dir):
    """Every ``request`` event of the dumps on one wall axis, tagged
    with its source rank: ``[(wall_us, seq, rank, phase, rid, aux)]``;
    an event in several dumps of one file (a process dumps its ring at
    every fault) once."""
    out = []
    for path in _dump_paths(paths_or_dir):
        seen = set()
        for hdr, evs in _dumps(path):
            rank = hdr.get("rank", -1)
            for ev in evs:
                if ev.get("type", "request") != "request" \
                        or ev.get("seq") in seen:
                    continue
                seen.add(ev.get("seq"))
                phase = ev.get("phase_name")
                if phase is None:
                    pid = ev.get("phase", -1)
                    phase = (REQUEST_PHASES[pid]
                             if 0 <= pid < len(REQUEST_PHASES)
                             else "unknown")
                wall = ev["ts_us"] - hdr["steady_us"] + hdr["unix_us"]
                out.append((wall, ev.get("seq", 0), rank, phase,
                            ev.get("rid"), ev.get("aux", 0)))
    return out


def stitch(paths_or_dir):
    """Merge the ranks' dumps and reassemble each rid's span chain.

    Returns ``{rid: chain}``, a chain being ``{"rid", "spans": [{"phase",
    "rank", "start_us", "end_us", "dur_us"}], "phase_us": {phase: us},
    "start_us", "end_us", "wall_us", "complete", "ranks"}``. Span *i* is
    exactly ``[t_i, t_{i+1})`` of the rid's sorted transitions, so
    ``sum(phase_us.values()) == wall_us`` to the microsecond; adjacent
    same-phase spans of one rank merge, zero-length spans drop. Time
    after an intermediate ``done`` (a decode rank completed, the
    frontend confirmed later) books to ``done``."""
    per_rid = defaultdict(list)
    for t in _request_transitions(paths_or_dir):
        per_rid[t[4]].append(t)
    chains = {}
    for rid, transitions in per_rid.items():
        transitions.sort(key=lambda t: (t[0], t[1]))
        spans = []
        for (w0, _s0, rank, phase, _r0, _a0), (w1, *_rest) in zip(
                transitions, transitions[1:]):
            dur = w1 - w0
            if dur <= 0:
                continue
            if spans and spans[-1]["phase"] == phase \
                    and spans[-1]["rank"] == rank \
                    and spans[-1]["end_us"] == w0:
                spans[-1]["end_us"] = w1
                spans[-1]["dur_us"] += dur
                continue
            spans.append({"phase": phase, "rank": rank, "start_us": w0,
                          "end_us": w1, "dur_us": dur})
        phase_us = defaultdict(int)
        for s in spans:
            phase_us[s["phase"]] += s["dur_us"]
        start, end = transitions[0][0], transitions[-1][0]
        chains[rid] = {
            "rid": rid, "spans": spans, "phase_us": dict(phase_us),
            "start_us": start, "end_us": end, "wall_us": end - start,
            "complete": any(t[3] == TERMINAL_PHASE for t in transitions),
            "ranks": sorted({t[2] for t in transitions}),
        }
    return chains


def chain_gaps(chain):
    """An audit of one chain independent of :func:`stitch`'s
    construction: ``[(kind, at_us, us)]`` defects, ``gap`` for uncovered
    wall time between spans, ``overlap`` for doubly-covered time, and
    ``sum`` when the spans do not total the chain's wall time."""
    defects = []
    cursor = chain["start_us"]
    for s in chain["spans"]:
        if s["start_us"] > cursor:
            defects.append(("gap", cursor, s["start_us"] - cursor))
        elif s["start_us"] < cursor:
            defects.append(("overlap", s["start_us"],
                            cursor - s["start_us"]))
        cursor = s["end_us"]
    if cursor != chain["end_us"]:
        defects.append(("gap", cursor, chain["end_us"] - cursor))
    total = sum(s["dur_us"] for s in chain["spans"])
    if total != chain["wall_us"]:
        defects.append(("sum", chain["start_us"], chain["wall_us"] - total))
    return defects


# The package's name for :func:`stitch` (``telemetry.stitch_requests``).
stitch_requests = stitch


# ---- tail-latency attribution -----------------------------------------


def tail_report(chains, pct=99.0):
    """Which phases own the slow requests' wall time. Returns
    ``{"requests", "complete", "pct", "threshold_ms",
    "population_phase_share", "cohort_phase_share", "cohort":
    [{"rid", "wall_ms", "dominant_phase", "phases_ms", "ranks"}],
    "incomplete"}``: the cohort is every complete chain at or above the
    ``pct``-th percentile of the complete chains' wall time, slowest
    first; a share is phase time over wall time of its set (they sum to
    1, the chains being gap-free)."""
    import numpy as np

    complete = [c for c in chains.values() if c["complete"]]
    incomplete = sorted(c["rid"] for c in chains.values()
                        if not c["complete"])
    if not complete:
        return {"requests": len(chains), "complete": 0, "pct": pct,
                "threshold_ms": 0.0, "population_phase_share": {},
                "cohort_phase_share": {}, "cohort": [],
                "incomplete": incomplete}
    walls = np.asarray([c["wall_us"] for c in complete], np.float64)
    threshold = float(np.percentile(walls, pct))
    cohort = sorted((c for c in complete if c["wall_us"] >= threshold),
                    key=lambda c: -c["wall_us"])

    def shares(cs):
        total = sum(c["wall_us"] for c in cs)
        if total <= 0:
            return {}
        acc = defaultdict(int)
        for c in cs:
            for ph, us in c["phase_us"].items():
                acc[ph] += us
        return {ph: round(us / total, 6)
                for ph, us in sorted(acc.items())}

    rows = []
    for c in cohort:
        dominant = max(c["phase_us"], key=c["phase_us"].get) \
            if c["phase_us"] else "-"
        rows.append({
            "rid": c["rid"],
            "wall_ms": round(c["wall_us"] / 1000.0, 3),
            "dominant_phase": dominant,
            "phases_ms": {ph: round(us / 1000.0, 3)
                          for ph, us in sorted(c["phase_us"].items())},
            "ranks": c["ranks"],
        })
    return {
        "requests": len(chains),
        "complete": len(complete),
        "pct": pct,
        "threshold_ms": round(threshold / 1000.0, 3),
        "population_phase_share": shares(complete),
        "cohort_phase_share": shares(cohort),
        "cohort": rows,
        "incomplete": incomplete,
    }


def format_requests(report, max_rows=20):
    """The operator's rendering of :func:`tail_report`: the headline
    names where the slow band's time goes."""
    lines = []
    cs = report["cohort_phase_share"]
    if cs:
        worst = max(cs, key=cs.get)
        lines.append(
            f"p{report['pct']:g} cohort ({len(report['cohort'])} of "
            f"{report['complete']} requests, >= "
            f"{report['threshold_ms']:.1f} ms): spends "
            f"{cs[worst]:.0%} in {worst}")
    else:
        lines.append("no complete request chains")
    ps = report["population_phase_share"]
    if ps:
        lines.append("population: " + "  ".join(
            f"{ph} {frac:.0%}" for ph, frac in
            sorted(ps.items(), key=lambda kv: -kv[1])))
    lines.append(f"{'rid':>8} {'wall ms':>10} {'dominant':>16} "
                 f"{'share':>6}  phases")
    for row in report["cohort"][:max_rows]:
        dom_ms = row["phases_ms"].get(row["dominant_phase"], 0.0)
        share = dom_ms / row["wall_ms"] if row["wall_ms"] else 0.0
        detail = " ".join(f"{ph}={ms:.1f}" for ph, ms in
                          sorted(row["phases_ms"].items(),
                                 key=lambda kv: -kv[1])[:4])
        lines.append(f"{row['rid']:>8} {row['wall_ms']:>10.1f} "
                     f"{row['dominant_phase']:>16} {share:>6.0%}  "
                     f"{detail}")
    if report["incomplete"]:
        lines.append(f"incomplete (no terminal done): "
                     f"{report['incomplete']}")
    return "\n".join(lines)
