"""Perf-regression sentinel over telemetry series.

The port's own copy of ``horovod_tpu/telemetry/perfwatch.py``.
``python -m horovod_tpu_torch.telemetry.perfwatch`` consumes either a
:class:`~horovod_tpu_torch.telemetry.exporters.MetricsScraper` JSONL
flight recorder or bench JSON rows (``BENCH_SCHEMA=1`` rows, one JSON
object a line, or a JSON array) and answers ONE question with an exit
code CI can gate on: did step time, bus bandwidth, or overlap
efficiency regress?

Two detectors, both deliberately simple enough to reason about:

- **EWMA baseline breach** (:func:`detect`): the baseline tracks the
  series with a slow EWMA that is FROZEN while a point breaches — the
  regression must not teach the baseline that slow is normal. A breach
  only counts after ``consecutive`` points in a row exceed the relative
  threshold in the bad direction, so a one-sample GC pause or a ±5%
  noise floor stays quiet (tests/single/test_perfwatch.py pins both).
- **Changepoint localization** (:func:`changepoint`): the two-segment
  split minimizing summed squared error — *where* the regime shifted,
  reported as the first row index of the new regime (the commit-range
  bisector's input).

``--budget`` turns the report into a gate: nonzero exit on any flagged
regression (exit 2 when nothing was watchable).

Rows carry a ``schema`` version (the bench's ``BENCH_SCHEMA``); mixed
schema versions in one input are refused loudly instead of mis-compared
(exit 2). The watched fields and the row identity are the JAX
package's, so both read the same rows alike.
"""

import argparse
import json
import sys

# Fields that IDENTIFY a row (the join/grouping key) rather than
# measure it — shared with bench.py's --diff so the two tools can never
# disagree about what distinguishes rows of one metric family.
ROW_IDENTITY_FIELDS = ("metric", "config", "name", "schedule", "bench",
                       "ranks", "bytes", "payload_bytes", "bucket_bytes",
                       "V", "accum", "dtype", "op",
                       # Multi-channel wire rows (ring_busbw striped
                       # lanes): the stripe width identifies a series —
                       # a K=1 and a K=4 row must never cross-join into
                       # one EWMA baseline.
                       "channels",
                       # Serving rows (serving_latency): the offered
                       # load and KV block geometry identify a series —
                       # interleaving different traces or block sizes
                       # into one EWMA baseline would flag every config
                       # transition as a regression.
                       "arrival_rps", "block_size")

# Watched series and their bad direction: step time up = slower,
# busbw/efficiency/MFU down = slower. Matched against the REAL bench
# row fields (`step_s`/`sec_per_step` on the loopback lanes,
# `busbw_gbps` inside flattened `points`, `value` on the MFU headline
# rows) AND the derived scraper series below.
DEFAULT_WATCH = {
    "mean_step_s": "up",
    "step_s": "up",
    "sec_per_step": "up",
    "step_time_ms": "up",
    "ms_per_step": "up",
    "busbw_gbps": "down",
    # Transport-time bus bandwidth of the same rows (the striping
    # acceptance number — busbw minus the fixed API-path overhead).
    "wire_gbps": "down",
    "overlap_efficiency": "down",
    "mfu": "down",
    # Serving rows (bench.py --serving / serving_latency family):
    # request latency percentiles regress UP, sustained decode
    # throughput regresses DOWN — watched from day one so the CI gate
    # covers the serving lane the moment it emits rows.
    "p50_ms": "up",
    "p99_ms": "up",
    "sustained_tok_s": "down",
    "tok_s": "down",
    # Instrumentation-cost rows (events_overhead, the r19
    # serving_trace_overhead lane): the flight recorder / request
    # tracing getting more expensive IS a perf regression.
    "overhead_pct": "up",
    # Fleet rank-seconds rows (bench.py --fleet-util, docs/fleet.md):
    # utilization falling, the unattributed share growing, breaches
    # appearing, or the aggregation itself slowing down at fleet scale
    # are each regressions in their own right.
    "utilization": "down",
    "unattributed_share": "up",
    "breaches": "up",
    "analyze_s": "up",
}


def field_direction(metric, field):
    """Bad direction for one (metric, field), or None = unwatched. The
    generic bench headline `value` is watchable only when the metric
    name says what it measures (MFU/busbw: down = regression)."""
    if field == "value":
        m = (metric or "").lower()
        return "down" if ("mfu" in m or "busbw" in m) else None
    return DEFAULT_WATCH.get(field)


def flatten_rows(rows):
    """Expand rows whose measurements live in a nested ``points`` list
    (the ring_busbw/hier_busbw shape) into one pseudo-row per point,
    carrying the parent's identity fields — so per-size busbw series
    are watchable and diffable like top-level fields."""
    out = []
    for row in rows:
        points = row.get("points")
        if not isinstance(points, list):
            out.append(row)
            continue
        ident = {f: row[f] for f in ROW_IDENTITY_FIELDS if f in row}
        ident["schema"] = row.get("schema", 0)
        for point in points:
            if isinstance(point, dict):
                out.append({**ident, **point})
    return out


def detect(series, direction="up", rel_threshold=0.25, alpha=0.2,
           consecutive=2, warmup=3):
    """EWMA-baseline breach detection over one series.

    Returns ``{"regressed", "index", "ratio", "baseline"}``: ``index``
    is the FIRST point of the flagged breach streak, ``ratio`` the
    worst point/baseline ratio seen, ``baseline`` the frozen baseline
    at flag time. The baseline absorbs only non-breaching points —
    otherwise a slow drift into the regression would mask it — and the
    first ``warmup`` points only feed the baseline (a cold EWMA flags
    its own second sample).
    """
    m = None
    streak_start = None
    streak = 0
    worst = 1.0
    flagged = None
    for i, x in enumerate(series):
        if m is None:
            m = x
            continue
        ratio = (x / m) if m else 1.0
        breach = (i >= warmup and m > 0
                  and (ratio > 1 + rel_threshold if direction == "up"
                       else ratio < 1 - rel_threshold))
        if breach:
            if streak == 0:
                streak_start = i
            streak += 1
            if direction == "up":
                worst = max(worst, ratio)
            else:
                worst = min(worst, ratio)
            if streak >= consecutive and flagged is None:
                flagged = streak_start
        else:
            streak = 0
            # A transient streak that never flagged must not leave its
            # magnitude behind: `ratio` reports the flagged regression,
            # not an unrelated earlier outlier.
            if flagged is None:
                worst = 1.0
            m = (1 - alpha) * m + alpha * x
    return {
        "regressed": flagged is not None,
        "index": flagged,
        "ratio": round(worst, 4),
        "baseline": round(m, 6) if m is not None else None,
    }


def changepoint(series):
    """Two-segment least-squares changepoint: the split index i (first
    point of the new regime) minimizing SSE(x[:i]) + SSE(x[i:]), plus
    the mean shift ratio across it. ``(None, 1.0)`` below 4 points."""
    n = len(series)
    if n < 4:
        return None, 1.0

    def sse(xs):
        if not xs:
            return 0.0
        mu = sum(xs) / len(xs)
        return sum((x - mu) ** 2 for x in xs)

    best_i, best_cost = None, None
    for i in range(1, n):
        cost = sse(series[:i]) + sse(series[i:])
        if best_cost is None or cost < best_cost:
            best_i, best_cost = i, cost
    before = sum(series[:best_i]) / best_i
    after = sum(series[best_i:]) / (n - best_i)
    shift = (after / before) if before else 1.0
    return best_i, round(shift, 4)


# ---- input readers ----------------------------------------------------


def load_rows(path):
    """Rows from a bench/scrape file: JSONL (one object per line, the
    bench and scraper formats), a JSON array, or a driver artifact
    whose ``tail`` string embeds JSON rows between log lines (the
    committed ``BENCH_r0*.json`` shape)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        if isinstance(doc, list):
            return doc
        if isinstance(doc, dict) and isinstance(doc.get("tail"), str):
            return _rows_from_lines(doc["tail"].splitlines())
        if isinstance(doc, dict):
            return [doc]
    except json.JSONDecodeError:
        pass
    return _rows_from_lines(text.splitlines())


def _rows_from_lines(lines):
    rows = []
    for line in lines:
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(row, dict):
            rows.append(row)
    return rows


def check_schema(rows, what="rows"):
    """One ``schema`` version per input, or refuse loudly: silently
    comparing rows whose field meanings moved between formats is how a
    regression hides inside a renamed column. Absent stamps (pre-schema
    rows) count as version 0 and stay comparable with each other."""
    versions = {int(r.get("schema", 0)) for r in rows}
    if len(versions) > 1:
        raise SystemExit(
            f"perfwatch: refusing to compare {what} with MIXED schema "
            f"versions {sorted(versions)} — re-emit with one bench/"
            "scraper generation (rows are stamped by bench.py emit())")
    return versions.pop() if versions else 0


def bench_series(rows):
    """``{(identity, field): [values...]}`` for every watched numeric
    field, in row order. Rows are grouped by their FULL identity
    (:data:`ROW_IDENTITY_FIELDS`), not just the metric name — one
    metric family emits one row per config/size (zero_sweep's
    replicated vs zero1, ring_busbw's per-payload points), and
    interleaving those regimes into one series would make the EWMA
    baseline oscillate and flag every config transition."""
    series = {}
    for row in flatten_rows(rows):
        ident = "/".join(str(row[f]) for f in ROW_IDENTITY_FIELDS
                         if f in row and row[f] is not None)
        for field, v in row.items():
            if field_direction(row.get("metric"), field) is None:
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series.setdefault((ident or "?", field),
                                  []).append(float(v))
    return series


def scraper_series(rows):
    """Derived interval series from MetricsScraper JSONL snapshots:

    - ``busbw_gbps``: wire tx rate between scrapes;
    - ``overlap_efficiency``: Δhidden / Δtotal of the overlap ledger
      (per-interval, so a late-run regression is not averaged away by
      the cumulative quotient);
    - ``step_time_ms``: Δwall / Δledger-steps while steps advance.
    """
    out = {("scrape", "busbw_gbps"): [],
           ("scrape", "overlap_efficiency"): [],
           ("scrape", "step_time_ms"): []}
    prev = None
    for row in rows:
        wire = row.get("wire", {})
        ov = wire.get("overlap", {})
        cur = {
            "ts": row.get("ts", 0.0),
            "tx": wire.get("tx_bytes", 0),
            "hidden": (ov.get("intra", {}).get("hidden_us", 0)
                       + ov.get("cross", {}).get("hidden_us", 0)),
            "total": (ov.get("intra", {}).get("total_us", 0)
                      + ov.get("cross", {}).get("total_us", 0)),
            "steps": ov.get("steps", 0),
        }
        if prev is not None:
            dt = cur["ts"] - prev["ts"]
            if dt > 0:
                out[("scrape", "busbw_gbps")].append(
                    (cur["tx"] - prev["tx"]) / dt / 1e9)
            dtot = cur["total"] - prev["total"]
            if dtot > 0:
                out[("scrape", "overlap_efficiency")].append(
                    (cur["hidden"] - prev["hidden"]) / dtot)
            dsteps = cur["steps"] - prev["steps"]
            if dsteps > 0 and dt > 0:
                out[("scrape", "step_time_ms")].append(
                    dt * 1000.0 / dsteps)
        prev = cur
    return {k: v for k, v in out.items() if v}


def watch(series_map, rel_threshold=0.25, consecutive=2, min_points=4):
    """Run both detectors over every watched series; returns a list of
    verdict dicts (one per series with enough points)."""
    verdicts = []
    for (metric, field), series in sorted(series_map.items()):
        if len(series) < min_points:
            continue
        direction = field_direction(metric, field) or "up"
        d = detect(series, direction=direction,
                   rel_threshold=rel_threshold, consecutive=consecutive)
        cp_index, cp_shift = changepoint(series)
        verdicts.append({
            "metric": metric, "field": field, "points": len(series),
            "direction": direction, **d,
            "changepoint_index": cp_index,
            "changepoint_shift": cp_shift,
        })
    return verdicts


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.perfwatch",
        description="EWMA-baseline + changepoint perf-regression "
                    "sentinel over scraper JSONL or bench JSON rows")
    ap.add_argument("--jsonl", default=None,
                    help="MetricsScraper JSONL flight recorder")
    ap.add_argument("--bench", nargs="*", default=None,
                    help="bench row files (JSONL / JSON array / "
                         "BENCH_r0*.json driver artifacts), "
                         "concatenated in order")
    ap.add_argument("--threshold", type=float, default=0.25,
                    help="relative breach threshold (default 0.25)")
    ap.add_argument("--consecutive", type=int, default=2,
                    help="breaches in a row before flagging")
    ap.add_argument("--budget", action="store_true",
                    help="gate mode: exit 1 on any flagged regression")
    ap.add_argument("--json", action="store_true",
                    help="emit verdicts as JSON rows")
    args = ap.parse_args(argv)

    if not args.jsonl and not args.bench:
        ap.error("need --jsonl and/or --bench input")
    series_map = {}
    if args.jsonl:
        rows = load_rows(args.jsonl)
        check_schema(rows, what=args.jsonl)
        series_map.update(scraper_series(rows))
    if args.bench:
        rows = []
        for path in args.bench:
            rows.extend(load_rows(path))
        check_schema(rows, what="bench rows")
        series_map.update(bench_series(rows))

    verdicts = watch(series_map, rel_threshold=args.threshold,
                     consecutive=args.consecutive)
    regressed = [v for v in verdicts if v["regressed"]]
    for v in verdicts:
        if args.json:
            print(json.dumps(v))
        else:
            flag = "REGRESSED" if v["regressed"] else "ok"
            where = (f" at row {v['index']} (changepoint "
                     f"{v['changepoint_index']}, shift "
                     f"{v['changepoint_shift']}x)"
                     if v["regressed"] else "")
            print(f"{v['metric']}.{v['field']}: {flag} "
                  f"[{v['points']} pts, worst {v['ratio']}x "
                  f"baseline]{where}")
    if not verdicts:
        print("perfwatch: no watchable series found "
              f"({len(series_map)} candidates below min points)")
        if args.budget:
            # A gate with nothing to gate on must FAIL, not pass: a
            # renamed field or a wrong path would otherwise ship a 2x
            # regression under a green check (the same fail-loud rule
            # as the schema guard). Distinct code so CI can tell
            # "misconfigured input" from "regression found".
            print("perfwatch: --budget with zero watchable series — "
                  "failing the gate (wrong path or renamed fields?)",
                  file=sys.stderr)
            return 2
    if args.budget and regressed:
        print(f"perfwatch: {len(regressed)} regression(s) over budget",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
