"""Cross-rank timeline merge with straggler attribution.

The port's own copy of ``horovod_tpu/telemetry/report.py``. Each rank
records its own Chrome-trace timeline
(``hvd.start_timeline(f"/tmp/tl.{rank}.json")``, ``common/timeline.py``);
this module merges them into ONE Perfetto-loadable trace and attributes
negotiation stragglers::

    python -m horovod_tpu_torch.telemetry.report /tmp/tl.*.json \
        -o merged.json --skew-json skew.json

The merge reads a timeline's ``CLOCK_SYNC`` and ``NEGOTIATE`` events
alone and keeps every other event as it is, so the port's collective
names (``NCCL_ALLREDUCE``, ``GLOO_BCAST``...) merge as the reference's
``RING_*`` do. ``--fleet`` reads per-rank event dumps instead (black-box
or live ``critpath.write_event_dump`` files, or their directory) into
each rank's rank-seconds ledger, the fleet's utilization table and the
SLO verdicts (``telemetry/fleet.py analyze``; ``--slo`` replaces the
default objectives).

Clock alignment: per-rank timestamps are steady-clock-relative to each
rank's own start. The ``CLOCK_SYNC`` header event carries each trace's t=0 as wall-clock unix microseconds, which puts
all ranks on one axis up to NTP skew; without it (older traces) the
fallback aligns on ``NEGOTIATE`` end events — the coordinator's
response broadcast reaches every rank near-simultaneously, so the
median per-rank offset over matched events is a robust clock estimate.

Straggler attribution: a tensor's ``NEGOTIATE`` begin marks the moment
that rank submitted the request. After alignment, the last begin among
ranks for each (tensor, occurrence) is the rank the collective waited
for; aggregated, that is the per-rank skew table (the live counterpart
is the coordinator's ``straggler`` section in ``hvd.metrics()``).
"""

import argparse
import json
import statistics
import sys
from collections import defaultdict

# --post-mortem switches to the streaming k-way merge above this many
# dumps (large worlds).
_STREAM_THRESHOLD = 16


def load_timeline(path):
    """Load one rank's timeline; returns (rank, events). Tolerates the
    writer's trailing ``{}`` sentinel and in-progress traces (truncated
    final line)."""
    try:
        with open(path) as f:
            events = json.load(f)
    except json.JSONDecodeError:
        # Trace still being written (no closing "]"): recover line-wise.
        events = []
        with open(path) as f:
            for line in f:
                line = line.strip().rstrip(",")
                if not line or line in ("[", "]"):
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if ev:
                    events.append(ev)
    events = [e for e in events if e]  # drop the {} sentinel
    rank = None
    for e in events:
        if e.get("name") == "CLOCK_SYNC":
            rank = e.get("args", {}).get("rank")
            break
    if rank is None:
        ranks = {e.get("pid") for e in events if "pid" in e}
        rank = min(ranks) if ranks else 0
    return rank, events


def _clock_sync_us(events):
    for e in events:
        if e.get("name") == "CLOCK_SYNC":
            return e.get("args", {}).get("unix_us")
    return None


def _negotiate_occurrences(events, phase):
    """{(tensor, k): ts} for the k-th NEGOTIATE begin/end per tensor."""
    per_tensor = defaultdict(list)
    for e in events:
        if e.get("name") == "NEGOTIATE" and e.get("ph") == phase:
            tensor = e.get("args", {}).get("tensor")
            if tensor is not None:
                per_tensor[tensor].append(e["ts"])
    out = {}
    for tensor, times in per_tensor.items():
        for k, ts in enumerate(sorted(times)):
            out[(tensor, k)] = ts
    return out


def compute_offsets(traces):
    """Per-rank offsets (added to each rank's ts) onto a common axis.

    Returns ``{rank: offset_us}`` with the earliest-starting rank at
    its original coordinates. Prefers CLOCK_SYNC; falls back to the
    NEGOTIATE-end median match.
    """
    syncs = {rank: _clock_sync_us(events) for rank, events in traces}
    if all(s is not None for s in syncs.values()) and syncs:
        base = min(syncs.values())
        return {rank: s - base for rank, s in syncs.items()}

    ranks = [rank for rank, _ in traces]
    ref_rank = ranks[0]
    ref_ends = _negotiate_occurrences(dict(traces)[ref_rank], "E")
    offsets = {ref_rank: 0}
    for rank, events in traces:
        if rank == ref_rank:
            continue
        ends = _negotiate_occurrences(events, "E")
        deltas = [ref_ends[key] - ts for key, ts in ends.items()
                  if key in ref_ends]
        offsets[rank] = int(statistics.median(deltas)) if deltas else 0
    base = min(offsets.values(), default=0)
    return {rank: off - base for rank, off in offsets.items()}


def straggler_table(traces, offsets, top_n=10):
    """Per-rank skew aggregation over aligned NEGOTIATE begins.

    Returns ``{"per_rank": {rank: {last_count, mean_skew_us,
    max_skew_us, events}}, "worst_tensors": [...]}`` where a rank's
    skew on one collective is its submit time minus the earliest
    rank's.
    """
    begins = {rank: _negotiate_occurrences(events, "B")
              for rank, events in traces}
    keys = None
    for rank, occ in begins.items():
        keys = set(occ) if keys is None else keys & set(occ)
    keys = keys or set()

    per_rank = {rank: {"last_count": 0, "skews": []} for rank in begins}
    spreads = []
    for key in keys:
        arrivals = {rank: begins[rank][key] + offsets[rank]
                    for rank in begins}
        first = min(arrivals.values())
        last_rank = max(arrivals, key=arrivals.get)
        spread = arrivals[last_rank] - first
        per_rank[last_rank]["last_count"] += 1
        for rank, ts in arrivals.items():
            per_rank[rank]["skews"].append(ts - first)
        spreads.append((spread, key[0], key[1], last_rank))

    table = {}
    for rank, d in sorted(per_rank.items()):
        skews = d["skews"]
        table[rank] = {
            "last_count": d["last_count"],
            "events": len(skews),
            "mean_skew_us": (sum(skews) / len(skews)) if skews else 0.0,
            "max_skew_us": max(skews) if skews else 0,
        }
    spreads.sort(reverse=True)
    worst = [{"tensor": t, "occurrence": k, "spread_us": s,
              "last_rank": r} for s, t, k, r in spreads[:top_n]]
    return {"per_rank": table, "worst_tensors": worst,
            "matched_events": len(keys)}


def merge(paths, align=True, events_paths=None):
    """Merge per-rank timeline files.

    Returns ``(merged_events, skew)``: one Chrome-trace event list
    (per-rank ts shifted onto the common axis, pid = rank, process
    names labeled) and the straggler table. ``events_paths`` optionally
    folds per-rank event-ring dumps (black-box JSONL, see
    :mod:`horovod_tpu_torch.telemetry.postmortem`) in as extra per-rank
    tracks — chunk-level wire activity, heal-ladder steps, and fault
    milestones land on the same axis as the per-op spans, aligned
    through each dump's wall/steady anchor pair against the traces'
    CLOCK_SYNC anchors.
    """
    traces = [load_timeline(p) for p in paths]
    seen = set()
    for rank, _ in traces:
        if rank in seen:
            raise ValueError(f"duplicate rank {rank} across input "
                             "traces — pass one timeline per rank")
        seen.add(rank)
    offsets = compute_offsets(traces) if align else \
        {rank: 0 for rank, _ in traces}
    merged = []
    for rank, events in traces:
        named = False
        for e in events:
            e = dict(e)
            e["pid"] = rank
            if "ts" in e:
                e["ts"] = e["ts"] + offsets[rank]
            if e.get("name") == "process_name":
                named = True
            merged.append(e)
        if not named:
            merged.append({"name": "process_name", "ph": "M",
                           "pid": rank,
                           "args": {"name": f"rank {rank}"}})
    if events_paths:
        from horovod_tpu_torch.telemetry import postmortem

        # The merged axis puts rank r's trace event at
        # (wall - sync_r) + offsets[r], so the wall base that lands
        # rank r's ring events on ITS OWN trace rows is
        # sync_r - offsets[r]. Under full CLOCK_SYNC alignment that is
        # the same value for every rank (min(sync)); under --no-align
        # or the NEGOTIATE-median fallback the bases differ per rank,
        # and a single global anchor would shear the event tracks off
        # the op spans they annotate.
        syncs = {rank: _clock_sync_us(events) for rank, events in traces}
        bases = {rank: s - offsets[rank]
                 for rank, s in syncs.items() if s is not None}
        fallback = min(bases.values()) if bases else None
        for path in postmortem.collect_paths(events_paths):
            # A process appends one dump per fault and each dump is the
            # ring tail at that moment — successive dumps overlap, so
            # fold each event ONCE (seq is per-process monotonic):
            # rendering every dump verbatim would duplicate the shared
            # window at identical timestamps, while keeping only the
            # last would drop events that aged out of the ring between
            # faults.
            seen_seqs = set()
            for dump in postmortem.load_blackbox(path):
                hdr = dump["header"]
                fresh = [e for e in dump["events"]
                         if e.get("seq") not in seen_seqs]
                if not fresh:
                    continue
                seen_seqs.update(e.get("seq") for e in fresh)
                base = bases.get(hdr.get("rank"), fallback)
                if base is None:  # no anchored trace anywhere: events-
                    base = hdr["unix_us"]  # only, relative to dump time
                merged.extend(postmortem.events_to_trace_events(
                    {"header": hdr, "events": fresh}, base))
    merged.sort(key=lambda e: e.get("ts", 0))
    skew = straggler_table(traces, offsets)
    return merged, skew


def attach_fault_events(skew, snapshot_paths):
    """Fold per-rank metrics snapshots' ``elastic`` section into the
    straggler table: per rank, faults detected /
    recovered, ranks it saw blacklisted, its membership epoch, and its
    median detection latency. A rank that keeps re-detecting faults (or
    sits at a lower epoch than its peers) is the flaky host the
    straggler table alone cannot name — skew attributes slowness,
    fault events attribute churn.
    """
    per_rank = {}
    for path in snapshot_paths:
        with open(path) as f:
            snap = json.load(f)
        el = snap.get("elastic", {})
        per_rank[snap.get("rank", -1)] = {
            "epoch": el.get("epoch", 0),
            "faults_detected": el.get("faults_detected", 0),
            "faults_recovered": el.get("faults_recovered", 0),
            "ranks_blacklisted": el.get("ranks_blacklisted", 0),
            "detect_p50_us": el.get("detect_us", {}).get("p50_us", 0),
        }
    skew["fault_events"] = per_rank
    for rank, d in skew["per_rank"].items():
        if rank in per_rank:
            d["faults_detected"] = per_rank[rank]["faults_detected"]
            d["epoch"] = per_rank[rank]["epoch"]
    return skew


def format_skew_table(skew):
    faults = skew.get("fault_events") or {}
    hdr = (f"{'rank':>5} {'last':>7} {'events':>7} "
           f"{'mean skew us':>13} {'max skew us':>12}")
    if faults:
        hdr += f" {'epoch':>6} {'faults':>7} {'det p50 us':>11}"
    lines = [hdr]
    for rank, d in sorted(skew["per_rank"].items()):
        row = (f"{rank:>5} {d['last_count']:>7} {d['events']:>7} "
               f"{d['mean_skew_us']:>13.1f} {d['max_skew_us']:>12}")
        if faults:
            fe = faults.get(rank, {})
            row += (f" {fe.get('epoch', '-'):>6} "
                    f"{fe.get('faults_detected', '-'):>7} "
                    f"{fe.get('detect_p50_us', '-'):>11}")
        lines.append(row)
    for w in skew["worst_tensors"][:5]:
        lines.append(f"  worst: {w['tensor']}#{w['occurrence']} "
                     f"spread {w['spread_us']} us "
                     f"(last: rank {w['last_rank']})")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.report",
        description="Merge per-rank hvdtpu timelines into one "
                    "Perfetto-loadable trace with straggler attribution")
    ap.add_argument("timelines", nargs="+",
                    help="per-rank timeline JSON files (or, with "
                         "--post-mortem, black-box JSONL dumps / the "
                         "dump directory)")
    ap.add_argument("-o", "--output", default="merged_timeline.json",
                    help="merged trace output path")
    ap.add_argument("--skew-json", default=None,
                    help="also write the straggler table as JSON")
    ap.add_argument("--no-align", action="store_true",
                    help="skip clock alignment (trust raw timestamps)")
    ap.add_argument("--snapshots", nargs="*", default=None,
                    help="per-rank hvd.metrics() snapshot JSON files: "
                         "folds elastic fault events (epoch, faults, "
                         "detection latency) into the straggler table")
    ap.add_argument("--events", nargs="*", default=None,
                    help="per-rank event-ring dumps (black-box JSONL): "
                         "rendered as extra Perfetto tracks on the "
                         "merged timeline")
    ap.add_argument("--post-mortem", action="store_true",
                    help="positional args are black-box JSONL dumps "
                         "(or their directory): merge them into one "
                         "causal cross-rank fault timeline naming the "
                         "root-cause rank(s); -o writes the analysis "
                         "as JSON")
    ap.add_argument("--stream", action="store_true",
                    help="with --post-mortem: force the streaming "
                         "merge (bounded memory, timeline tail only). "
                         "Selected automatically above %d dumps."
                         % _STREAM_THRESHOLD)
    ap.add_argument("--requests", action="store_true",
                    help="positional args are per-rank event dumps "
                         "(black-box JSONL or live write_event_dump "
                         "traces, or their directory): stitch each "
                         "request's cross-rank span chain off the "
                         "`request` events and decompose the tail "
                         "latency band by lifecycle phase; -o writes "
                         "the analysis (report + per-rid chains) as "
                         "JSON")
    ap.add_argument("--pct", type=float, default=99.0,
                    help="with --requests: the percentile band to "
                         "attribute (default 99)")
    ap.add_argument("--critical-path", action="store_true",
                    help="positional args are per-rank event dumps "
                         "(black-box JSONL or live write_event_dump "
                         "traces, or their directory): merge the step "
                         "windows across ranks and name, per step, the "
                         "rank and phase (compute/negotiation/wire/"
                         "stall) that bounded it; -o writes the "
                         "analysis as JSON")
    ap.add_argument("--fleet", action="store_true",
                    help="positional args are per-rank event dumps (or "
                         "their directory): decompose every rank's "
                         "wall time into the rank-seconds buckets, "
                         "render the fleet utilization table with "
                         "worst-rank attribution, and report SLO "
                         "breaches: both breach events recorded in the "
                         "dumps and a re-evaluation of the ledger "
                         "signals; -o writes the analysis as JSON")
    ap.add_argument("--slo", default=None,
                    help="with --fleet: ';'-separated SLO objectives "
                         "to evaluate instead of the defaults (e.g. "
                         "'stall_ms < 500; serving_p99_ms < 250')")
    args = ap.parse_args(argv)

    if args.requests:
        from horovod_tpu_torch.telemetry import reqtrace

        chains = reqtrace.stitch(args.timelines)
        analysis = reqtrace.tail_report(chains, pct=args.pct)
        print(reqtrace.format_requests(analysis))
        if args.output != "merged_timeline.json":
            with open(args.output, "w") as f:
                json.dump({"report": analysis,
                           "chains": {str(r): c
                                      for r, c in sorted(chains.items())}},
                          f, indent=2)
            print(f"wrote {args.output}")
        return 0

    if args.critical_path:
        from horovod_tpu_torch.telemetry import critpath

        analysis = critpath.critical_path(args.timelines)
        print(critpath.format_critical_path(analysis))
        if args.output != "merged_timeline.json":
            with open(args.output, "w") as f:
                json.dump(analysis, f, indent=2)
            print(f"wrote {args.output}")
        return 0

    if args.fleet:
        from horovod_tpu_torch.telemetry import fleet

        analysis = fleet.analyze(args.timelines, objectives=args.slo)
        print(fleet.format_fleet(analysis))
        if args.output != "merged_timeline.json":
            with open(args.output, "w") as f:
                json.dump(analysis, f, indent=2)
            print(f"wrote {args.output}")
        return 0

    if args.post_mortem:
        from horovod_tpu_torch.telemetry import postmortem

        paths = postmortem.collect_paths(args.timelines)
        if args.stream or len(paths) > _STREAM_THRESHOLD:
            # Hundreds of dumps: the eager merge's global annotate+sort
            # is quadratic-feeling at fleet scale; the k-way streaming
            # pass returns identical verdicts in seconds.
            analysis = postmortem.merge_post_mortem_streaming(paths)
        else:
            analysis = postmortem.merge_post_mortem(paths)
        print(postmortem.format_post_mortem(analysis))
        if args.output != "merged_timeline.json":
            with open(args.output, "w") as f:
                json.dump(analysis, f, indent=2)
            print(f"wrote {args.output}")
        return 0

    merged, skew = merge(args.timelines, align=not args.no_align,
                         events_paths=args.events)
    if args.snapshots:
        attach_fault_events(skew, args.snapshots)
    with open(args.output, "w") as f:
        json.dump(merged, f)
    print(f"wrote {args.output} ({len(merged)} events, "
          f"{len(args.timelines)} ranks)")
    print(format_skew_table(skew))
    if args.skew_json:
        with open(args.skew_json, "w") as f:
            json.dump(skew, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
