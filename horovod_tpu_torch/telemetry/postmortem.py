"""Black-box post-mortem: merge per-rank event-ring dumps into one
causal cross-rank fault timeline.

The port's own copy of ``horovod_tpu/telemetry/postmortem.py``. When
the lane records a typed fault (a lost peer: the port has no wire
corruption, ROADMAP.md L8) it dumps its event ring to a per-rank JSONL
file *before* any handle wakes a caller (``common/events.py
dump_blackbox``, the reference's ``DumpBlackBox``) — so even a job that
dies ugly leaves, per surviving rank, the causal window that led there.
This module is the offline half::

    python -m horovod_tpu_torch.telemetry.report --post-mortem \
        /tmp/hvdtpu_blackbox/blackbox-rank*.jsonl

Clock alignment reuses the CLOCK_SYNC contract of the Perfetto merge:
each dump's header carries a ``(unix_us, steady_us)`` pair sampled
together at dump time, so every rank's steady-clock event timestamps
map onto one wall-clock axis (up to NTP skew, same bound as the trace
merge).

Attribution separates **root-cause death from secondary timeouts**, the
same proof-vs-suspicion discipline as the elastic layer: a rank named by a *certain* fault record (EOF/RST/
probe sweep) is provably dead — root cause. A rank that is merely
*suspected* (timeout) but wrote its own black-box dump is demonstrably
alive — its naming was a secondary timeout (it was quiet because it was
itself blocked on the real casualty). The **first-stalled rank** is the
one whose last forward-progress event (wire chunk/span, response
launch, negotiation end) is earliest on the merged axis — among
survivors, that is the rank the stall propagated *from*.
"""

import heapq
import json
import os
from collections import defaultdict, deque

# Event types that constitute forward progress for first-stall analysis.
PROGRESS_TYPES = ("wire_chunk", "wire_span", "response_launch",
                  "negotiate_end")


def _fold_slo_breaches(timeline):
    """SLO breach events out of a merged timeline, folded ONCE per
    (source rank, ring seq): a process re-dumps its ring tail on every
    fault, so the same recorded breach can reach the merge several
    times — the verdict list must not multiply with the fault count.
    The port's ``telemetry/slo.py SloEngine.record`` writes them
    (``common/basics.py record_slo``)."""
    seen = set()
    out = []
    for e in timeline:
        if e.get("type") != "slo_breach":
            continue
        key = (e.get("rank"), e.get("seq"))
        if key in seen:
            continue
        seen.add(key)
        out.append({
            "source_rank": e.get("rank"),
            "objective": e.get("objective_name"),
            "breach_rank": e.get("breach_rank"),
            "value": e.get("value"),
            "phase": e.get("phase_name"),
            "t_ms": e.get("t_ms"),
        })
    return out


def default_blackbox_dir():
    """Where the lane's dumps land when ``HOROVOD_BLACKBOX_DIR`` is
    unset (``common/events.py blackbox_dir``)."""
    env = os.environ.get("HOROVOD_BLACKBOX_DIR", "")
    if env and env not in ("off", "none", "0"):
        return env
    return os.path.join(os.environ.get("TMPDIR") or "/tmp",
                        "hvdtpu_blackbox")


def load_blackbox(path):
    """Parse one per-rank black-box JSONL file into a list of dumps
    (a process appends one dump per fault): each is
    ``{"header": {...}, "events": [...]}``. Tolerates a truncated final
    line (the process may have died mid-write)."""
    dumps = []
    current = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a dying process
            if row.get("kind") == "blackbox_header":
                current = {"header": row, "events": []}
                dumps.append(current)
            elif current is not None:
                current["events"].append(row)
    return dumps


def collect_paths(paths_or_dir):
    """Expand a directory (or mixed list) into blackbox JSONL paths."""
    if isinstance(paths_or_dir, str):
        paths_or_dir = [paths_or_dir]
    out = []
    for p in paths_or_dir:
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.startswith("blackbox-") and f.endswith(".jsonl")))
        else:
            out.append(p)
    return out


def _wall_us(event, header):
    """Steady-clock event timestamp -> wall clock, via the header's
    (unix_us, steady_us) anchor pair (the CLOCK_SYNC contract)."""
    return event["ts_us"] - header["steady_us"] + header["unix_us"]


def merge_post_mortem(paths_or_dir, dump_index=-1):
    """Merge per-rank black-box dumps into one causal analysis.

    ``dump_index`` selects which dump per file when a process recorded
    several faults (-1 = the latest). Returns a dict with:

    - ``timeline``: every rank's events on one wall axis, sorted —
      each entry carries ``rank``, ``wall_us``, ``t_ms`` (relative to
      the earliest event) and the original event fields;
    - ``root_cause_ranks``: provably dead (or corrupting) ranks;
    - ``secondary_suspects``: ranks named only by timeout suspicion
      that demonstrably survived (wrote their own dump);
    - ``first_stalled_rank`` and ``last_progress_us`` per rank;
    - ``per_rank``: each survivor's fault record + event count.
    """
    paths = collect_paths(paths_or_dir)
    ranks = {}
    for path in paths:
        dumps = load_blackbox(path)
        if not dumps:
            continue
        dump = dumps[dump_index]
        rank = dump["header"].get("rank", -1)
        ranks[rank] = dump
    if not ranks:
        raise ValueError(f"no black-box dumps found in {paths_or_dir!r}")

    survivors = set(ranks)
    certain, suspected, corrupting = set(), set(), set()
    per_rank = {}
    for rank, dump in sorted(ranks.items()):
        fault = dump["header"].get("fault", {})
        named = set(fault.get("ranks", []))
        if fault.get("kind") == "corruption":
            # Corruption names a live-but-poisoning peer: root cause
            # of THIS fault even though the process survives (and may
            # itself have dumped, oblivious).
            corrupting |= named
        elif fault.get("certain"):
            certain |= named
        else:
            suspected |= named
        per_rank[rank] = {
            "epoch": dump["header"].get("epoch"),
            "fault": fault,
            "events": len(dump["events"]),
        }

    # A dump is proof of life at fault time, and it BEATS a peer's
    # "certain" EOF attribution: survivors tearing their sockets down
    # after recording their own fault feed late-classifying peers EOFs
    # on live ranks (the r12 ordering gotcha) — offline, the dump's
    # existence filters those artifacts out. What remains certain and
    # dump-less is provably dead: root cause.
    root_cause = sorted((certain - survivors) | corrupting)
    secondary = sorted(((certain | suspected) & survivors) - corrupting)
    if not root_cause:
        # No proof anywhere: the suspects that did NOT dump are the
        # best remaining explanation (they never noticed a fault —
        # consistent with being the casualty).
        root_cause = sorted(suspected - survivors)

    timeline = []
    for rank, dump in ranks.items():
        hdr = dump["header"]
        for ev in dump["events"]:
            entry = dict(ev)
            entry["rank"] = rank
            entry["wall_us"] = _wall_us(ev, hdr)
            timeline.append(entry)
    timeline.sort(key=lambda e: e["wall_us"])
    t0 = timeline[0]["wall_us"] if timeline else 0
    for e in timeline:
        e["t_ms"] = round((e["wall_us"] - t0) / 1000.0, 3)

    # First-stalled: progress only counts BEFORE the stall was first
    # noticed anywhere (the earliest retry-ladder window or fault on
    # the merged axis) — a SIGSTOPped rank that later resumes, retries,
    # and faults records plenty of late activity, but its last progress
    # *before the stall surfaced* is what betrays that it froze first
    # while its peers were still launching work against it.
    stall_marks = [e["wall_us"] for e in timeline
                   if e["type"] in ("retry_window", "fault", "crc_error")]
    cutoff = min(stall_marks) if stall_marks else None
    last_progress = {}
    for e in timeline:
        if e["type"] not in PROGRESS_TYPES:
            continue
        if cutoff is not None and e["wall_us"] > cutoff:
            continue
        rank = e["rank"]
        if e["wall_us"] > last_progress.get(rank, float("-inf")):
            last_progress[rank] = e["wall_us"]
    first_stalled = None
    if last_progress:
        first_stalled = min(last_progress, key=last_progress.get)
    for rank, us in last_progress.items():
        per_rank[rank]["last_progress_ms"] = round((us - t0) / 1000.0, 3)

    return {
        "ranks": sorted(survivors),
        "root_cause_ranks": root_cause,
        "secondary_suspects": secondary,
        "first_stalled_rank": first_stalled,
        "per_rank": per_rank,
        "timeline": timeline,
        "slo_breaches": _fold_slo_breaches(timeline),
    }


def _load_dump_at(path, dump_index=-1):
    """Parse ONE dump from a per-rank file without materializing the
    others: for the common ``dump_index=-1`` the file is scanned once
    and only events after the LAST header are retained — memory stays
    one-dump-bounded however many faults the process logged."""
    if dump_index != -1:
        dumps = load_blackbox(path)
        return dumps[dump_index] if dumps else None
    current = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a dying process
            if row.get("kind") == "blackbox_header":
                current = {"header": row, "events": []}
            elif current is not None:
                current["events"].append(row)
    return current


def _scan_last_dump(path):
    """One O(1)-memory pass over a per-rank file: locate the LAST dump
    and summarize it without retaining its events. Returns ``None`` if
    the file holds no dump, else a dict with the header, the byte
    offset of the first event line, the event count, whether the events
    are already ts-ordered (ring snapshots normally are), and this
    rank's contribution to the global stall cutoff (min wall time of
    retry/fault/crc events)."""
    info = None
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            s = line.strip()
            if not s:
                continue
            try:
                row = json.loads(s)
            except json.JSONDecodeError:
                continue  # torn tail of a dying process
            if row.get("kind") == "blackbox_header":
                info = {"path": path, "header": row, "offset": f.tell(),
                        "events": 0, "in_order": True, "cutoff": None,
                        "_last_ts": None}
            elif info is not None:
                info["events"] += 1
                ts = row.get("ts_us", 0)
                if info["_last_ts"] is not None and ts < info["_last_ts"]:
                    info["in_order"] = False
                info["_last_ts"] = ts
                if row.get("type") in ("retry_window", "fault",
                                       "crc_error"):
                    wall = _wall_us(row, info["header"])
                    info["cutoff"] = (wall if info["cutoff"] is None
                                      else min(info["cutoff"], wall))
    return info


def _iter_dump_events(info, rank):
    """Lazily re-read one rank's last-dump events from disk (the offset
    :func:`_scan_last_dump` found), yielding ``(wall_us, rank, event)``
    in file order — the sorted-stream contract ``heapq.merge`` needs.
    The rare unsorted snapshot falls back to materializing just this
    rank (bounded by one ring tail)."""
    if not info["in_order"]:
        events = []
        with open(info["path"]) as f:
            f.seek(info["offset"])
            for line in f:
                row = _event_row(line)
                if row is _STOP:
                    break
                if row is not None:
                    events.append(row)
        events.sort(key=lambda e: e.get("ts_us", 0))
        for ev in events:
            yield (_wall_us(ev, info["header"]), rank, ev)
        return
    with open(info["path"]) as f:
        f.seek(info["offset"])
        for line in f:
            row = _event_row(line)
            if row is _STOP:
                break
            if row is not None:
                yield (_wall_us(row, info["header"]), rank, row)


_STOP = object()


def _event_row(line):
    s = line.strip()
    if not s:
        return None
    try:
        row = json.loads(s)
    except json.JSONDecodeError:
        return None
    # A header can only follow the scanned offset if the scan raced a
    # NEW dump being appended; everything past it belongs to that later
    # dump, not the one being merged.
    if row.get("kind") == "blackbox_header":
        return _STOP
    return row


def merge_post_mortem_streaming(paths_or_dir, dump_index=-1, tail=512):
    """`merge_post_mortem` for LARGE worlds: same verdicts, streaming
    merge, bounded timeline.

    The eager merge materializes every rank's full event window as
    per-event dicts on one list and sorts it globally — fine at 2-8
    dumps, a multi-gigabyte sort at 256 ranks x 8k events with per-event
    wall/t_ms annotation. Here each file is scanned once in O(1) memory
    (header, event count, stall-cutoff contribution, sortedness), then
    the wall-aligned per-rank streams are re-read lazily from disk
    through one ``heapq.merge`` k-way pass (one open fd per rank):
    root-cause / secondary verdicts, per-rank last progress, and the
    newest ``tail`` timeline entries (annotated only on retention) are
    computed in that pass with O(ranks + tail) live memory — an
    unsorted snapshot (rare) materializes only that rank, bounded by
    one ring tail.

    Returns the `merge_post_mortem` dict with ``timeline`` holding only
    the newest ``tail`` entries plus ``timeline_total`` (the full
    merged event count); :func:`format_post_mortem` renders either.
    """
    paths = collect_paths(paths_or_dir)
    ranks = {}
    for path in paths:
        if dump_index == -1:
            info = _scan_last_dump(path)
        else:
            # Selecting an OLDER dump is a small-scale forensic move —
            # the eager loader is fine there; the scan path exists for
            # the latest-dump fleet merge.
            dump = _load_dump_at(path, dump_index)
            info = None
            if dump is not None:
                events = sorted(dump["events"],
                                key=lambda e: e.get("ts_us", 0))
                cut = None
                for ev in events:
                    if ev.get("type") in ("retry_window", "fault",
                                          "crc_error"):
                        wall = _wall_us(ev, dump["header"])
                        cut = wall if cut is None else min(cut, wall)
                info = {"header": dump["header"], "events": len(events),
                        "cutoff": cut, "_materialized": events}
        if info is None:
            continue
        ranks[info["header"].get("rank", -1)] = info
    if not ranks:
        raise ValueError(f"no black-box dumps found in {paths_or_dir!r}")

    survivors = set(ranks)
    certain, suspected, corrupting = set(), set(), set()
    per_rank = {}
    # Pass 0 came from the file scans: verdict sets off the headers,
    # the stall cutoff (a global MIN — order-free), per-rank event
    # counts. No event is resident yet.
    cutoff = None
    for rank, info in sorted(ranks.items()):
        hdr = info["header"]
        fault = hdr.get("fault", {})
        named = set(fault.get("ranks", []))
        if fault.get("kind") == "corruption":
            corrupting |= named
        elif fault.get("certain"):
            certain |= named
        else:
            suspected |= named
        per_rank[rank] = {
            "epoch": hdr.get("epoch"),
            "fault": fault,
            "events": info["events"],
        }
        if info["cutoff"] is not None:
            cutoff = (info["cutoff"] if cutoff is None
                      else min(cutoff, info["cutoff"]))
    root_cause = sorted((certain - survivors) | corrupting)
    secondary = sorted(((certain | suspected) & survivors) - corrupting)
    if not root_cause:
        root_cause = sorted(suspected - survivors)

    def rank_stream(rank, info):
        if "_materialized" in info:
            hdr = info["header"]
            return ((_wall_us(ev, hdr), rank, ev)
                    for ev in info["_materialized"])
        return _iter_dump_events(info, rank)

    merged = heapq.merge(*(rank_stream(r, i) for r, i in ranks.items()))
    last_progress = {}
    window = deque(maxlen=max(int(tail), 1))
    total = 0
    t0 = None
    # SLO breaches are collected DURING the pass, not from the bounded
    # tail window — a breach early in a long run is exactly the entry
    # the post-mortem must not age out (folding in _fold_slo_breaches).
    breach_rows = []
    for wall, rank, ev in merged:
        total += 1
        if t0 is None:
            t0 = wall
        window.append((wall, rank, ev))
        if ev.get("type") == "slo_breach":
            row = dict(ev)
            row["rank"] = rank
            row["t_ms"] = round((wall - t0) / 1000.0, 3)
            breach_rows.append(row)
        if ev.get("type") not in PROGRESS_TYPES:
            continue
        if cutoff is not None and wall > cutoff:
            continue
        if wall > last_progress.get(rank, float("-inf")):
            last_progress[rank] = wall
    first_stalled = None
    if last_progress:
        first_stalled = min(last_progress, key=last_progress.get)
    for rank, us in last_progress.items():
        per_rank[rank]["last_progress_ms"] = round(
            (us - (t0 or 0)) / 1000.0, 3)

    timeline = []
    for wall, rank, ev in window:
        entry = dict(ev)
        entry["rank"] = rank
        entry["wall_us"] = wall
        entry["t_ms"] = round((wall - (t0 or 0)) / 1000.0, 3)
        timeline.append(entry)

    return {
        "ranks": sorted(survivors),
        "root_cause_ranks": root_cause,
        "secondary_suspects": secondary,
        "first_stalled_rank": first_stalled,
        "per_rank": per_rank,
        "timeline": timeline,
        "timeline_total": total,
        "slo_breaches": _fold_slo_breaches(breach_rows),
    }


def format_post_mortem(analysis, tail=40):
    """Operator-facing text rendering of :func:`merge_post_mortem`."""
    lines = []
    rc = analysis["root_cause_ranks"]
    lines.append(
        f"root cause: rank(s) {rc}" if rc else
        "root cause: none provable (no certain attribution in any dump)")
    if analysis["secondary_suspects"]:
        lines.append("secondary timeouts (suspected but alive): "
                     f"{analysis['secondary_suspects']}")
    if analysis["first_stalled_rank"] is not None:
        lines.append(
            f"first stalled: rank {analysis['first_stalled_rank']} "
            "(earliest last-progress event)")
    for rank, d in sorted(analysis["per_rank"].items()):
        fault = d.get("fault", {})
        lines.append(
            f"  rank {rank}: epoch {d.get('epoch')}, "
            f"{d['events']} events, fault kind={fault.get('kind')} "
            f"certain={fault.get('certain')} ranks={fault.get('ranks')} "
            f"last progress {d.get('last_progress_ms', '-')} ms")
    for b in analysis.get("slo_breaches", []):
        lines.append(f"  slo breach [{b['objective']}] rank "
                     f"{b['breach_rank']} value={b['value']} "
                     f"phase={b['phase']} at {b['t_ms']} ms "
                     f"(recorded by rank {b['source_rank']})")
    total = analysis.get("timeline_total", len(analysis["timeline"]))
    lines.append(f"causal timeline (last {tail} of {total} events):")
    for e in analysis["timeline"][-tail:]:
        args = {k: v for k, v in e.items()
                if k not in ("rank", "wall_us", "t_ms", "ts_us", "seq",
                             "type")}
        lines.append(f"  {e['t_ms']:>10.3f} ms  rank {e['rank']}  "
                     f"{e['type']}  {args}")
    return "\n".join(lines)


# ---- events -> Perfetto -----------------------------------------------


def events_to_trace_events(dump, base_unix_us, tid=990, req_tid=2000):
    """Render one dump's ring events as Chrome-trace events on the
    merged axis (``ts = wall_us - base_unix_us``): ``wire_span``
    becomes a complete ('X') span ending at its record time, everything
    else an instant ('i') — so chunk-level wire activity and heal-ladder
    steps land on the same Perfetto timeline as the per-op spans.

    Serving ``request`` events get PER-REQUEST tracks instead: each
    rid's lifecycle transitions within this dump become named phase
    spans ('X', one row per rid at ``tid = req_tid + rid``) — a
    request's residency across queued/prefill/kv_ship/decode/requeue
    phases reads as one lane on the rank that observed it
    (cross-rank chains are :mod:`reqtrace`'s job; Perfetto shows each
    rank's view)."""
    hdr = dump["header"]
    rank = hdr.get("rank", -1)
    out = [{
        "name": "thread_name", "ph": "M", "pid": rank, "tid": tid,
        "args": {"name": "events"},
    }]
    requests = defaultdict(list)
    for ev in dump["events"]:
        wall = _wall_us(ev, hdr)
        ts = wall - base_unix_us
        args = {k: v for k, v in ev.items()
                if k not in ("ts_us", "seq", "type")}
        if ev.get("type") == "request":
            requests[ev.get("rid", -1)].append((ts, ev))
            continue
        if ev.get("type") == "wire_span":
            dur = max(int(ev.get("dur_us", 0)), 1)
            out.append({"name": f"wire_span p{ev.get('plane', 0)}",
                        "ph": "X", "ts": ts - dur, "dur": dur,
                        "pid": rank, "tid": tid, "args": args})
        else:
            out.append({"name": ev.get("type", "event"), "ph": "i",
                        "ts": ts, "pid": rank, "tid": tid, "s": "t",
                        "args": args})
    for rid, transitions in sorted(requests.items()):
        transitions.sort(key=lambda t: (t[0], t[1].get("seq", 0)))
        rid_tid = req_tid + (rid if isinstance(rid, int)
                             and rid >= 0 else 0)
        out.append({"name": "thread_name", "ph": "M", "pid": rank,
                    "tid": rid_tid, "args": {"name": f"rid {rid}"}})
        for (t0, ev0), (t1, _ev1) in zip(transitions, transitions[1:]):
            out.append({
                "name": ev0.get("phase_name", "request"), "ph": "X",
                "ts": t0, "dur": max(t1 - t0, 1), "pid": rank,
                "tid": rid_tid,
                "args": {"rid": rid, "aux": ev0.get("aux", 0)}})
        last_ts, last_ev = transitions[-1]
        out.append({"name": last_ev.get("phase_name", "request"),
                    "ph": "i", "ts": last_ts, "pid": rank,
                    "tid": rid_tid, "s": "t",
                    "args": {"rid": rid,
                             "aux": last_ev.get("aux", 0)}})
    return out
