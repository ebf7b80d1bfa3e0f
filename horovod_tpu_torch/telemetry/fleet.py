"""Fleet observatory: the rank-seconds ledger and its live aggregation.

The port's own copy of ``horovod_tpu/telemetry/fleet.py``. It decomposes
each rank's wall time into the :data:`BUCKETS` below: train compute,
*exposed* wire (the overlap ledger's measure: wire under a caller's
wait), negotiation, the serving loop's prefill/decode/queued phases
(``telemetry/reqtrace.py``'s ``request`` events), stall evidence, idle
gaps between steps. **The buckets sum to the window to the
microsecond**; what the lane recorded no evidence for is booked
``unattributed``, never absorbed.

Three consumers:

- :func:`analyze` and ``report --fleet``: the fleet view over per-rank
  black-box dumps (``common/events.py dump_blackbox`` at a fault, or
  :func:`critpath.write_event_dump` of a live rank): per-rank
  utilization, fleet-wide rank-seconds, the worst rank through
  ``critpath``, and the SLO verdicts (breach events found in the dumps
  and a re-evaluation of the ledger's signals);
- :class:`FleetObservatory`: a live aggregator polling every rank's
  debug server (``/healthz`` and ``/events``) into a time series,
  served at ``/fleet`` (``telemetry/debug_server.py``); each poll
  evaluates the declared SLOs (``telemetry/slo.py``) per rank and
  records the breaches as ``slo_breach`` events;
- ``telemetry/autoscale.py read_fleet_signals``, which reads the
  observatory's last view.

Claiming is by PRIORITY (stall > exposed wire > negotiation > serving
decode > prefill > queued), each bucket taking only wall time no
higher-priority bucket covered (phases overlap on the wall clock: a
negotiation under a wire span). ``compute`` then takes the step
windows' remainder, ``idle`` the gaps BETWEEN step windows, and
``unattributed`` is the exact integer remainder.

Where the port's evidence differs from the reference's: the lane has no
socket wire (ROADMAP.md L8), so a stall is evidenced by a
``delay:<ms>`` injection's gap on the delayed rank's own lane thread
(``critpath.phase_intervals``) and by the coordinator's stall check
(``common/controller.py``, ``HOROVOD_STALL_CHECK_TIME``) on rank 0 when
its lane thread is free to run it; there are no ``retry_window``
events.
"""

import json
import os
import threading
import time
import urllib.request
from collections import deque

from horovod_tpu_torch.common.events import RANK_BUCKETS
from horovod_tpu_torch.telemetry import critpath, postmortem, slo

# The rank-seconds buckets, in the reference's order (``slo_breach``'s
# phase argument indexes them): also the claiming priority's source,
# with the three derived buckets (compute, idle, unattributed) computed
# afterwards.
BUCKETS = RANK_BUCKETS

# Claiming priority for the event-derived interval buckets.
_CLAIM_ORDER = ("stall", "exposed_wire", "negotiation", "serving_decode",
                "serving_prefill", "serving_queued")

# Serving request-lifecycle phase -> ledger bucket (REQUEST_PHASES,
# ``common/events.py``): active compute phases map to their own buckets,
# every waiting/transit phase is queued-idle. "done" closes the rid.
_SERVING_BUCKET = {
    "prefill": "serving_prefill",
    "decode_active": "serving_decode",
    "queued": "serving_queued",
    "kv_ship": "serving_queued",
    "decode_wait": "serving_queued",
    "evicted_requeue": "serving_queued",
    "fault_requeue": "serving_queued",
}


def _serving_intervals(dump):
    """Per-bucket wall intervals from the rid-tagged ``request`` events
    (each marks the instant a rid ENTERS a phase; the interval runs to
    its next transition, or to the dump's last event for a rid still
    open — the live truth at dump time)."""
    hdr = dump["header"]
    out = {"serving_prefill": [], "serving_decode": [],
           "serving_queued": []}
    open_phase = {}  # rid -> (bucket, start_wall)
    last_wall = None
    for ev in dump["events"]:
        wall = critpath._wall(ev, hdr)
        last_wall = wall
        if ev.get("type") != "request":
            continue
        rid = ev.get("rid")
        prev = open_phase.pop(rid, None)
        if prev is not None and wall > prev[1]:
            out[prev[0]].append((prev[1], wall))
        bucket = _SERVING_BUCKET.get(ev.get("phase_name"))
        if bucket is not None:
            open_phase[rid] = (bucket, wall)
    if last_wall is not None:
        for bucket, start in open_phase.values():
            if last_wall > start:
                out[bucket].append((start, last_wall))
    return out


def ledger_from_dump(dump, window=None):
    """Decompose one rank's dump into the rank-seconds BUCKETS.

    ``window`` is ``(lo_us, hi_us)`` on the dump's wall axis; the
    default is the rank's own observed span — opening at the FIRST STEP
    MARK when the rank is step-marked (startup before the first marked
    step — imports, rendezvous, debug-server binds — is not
    schedulable rank-time), else at the first event, and closing at the
    last event either way. That is what keeps ``unattributed`` honest:
    time outside the flight recorder's view is not in the window at
    all, and what IS in the window but carries no evidence stays
    visible as a remainder instead of being absorbed.

    Returns ``{"rank", "lo_us", "hi_us", "window_us", "buckets":
    {name: us}, "utilization"}`` with ``sum(buckets.values()) ==
    window_us`` EXACTLY (integer microseconds)."""
    hdr = dump["header"]
    events = dump["events"]
    walls = [critpath._wall(ev, hdr) for ev in events]
    steps = sorted(critpath.step_windows(dump).values())
    if window is not None:
        lo, hi = int(window[0]), int(window[1])
    elif walls:
        lo, hi = (steps[0][0] if steps else min(walls)), max(walls)
    else:
        lo = hi = 0
    window_us = max(hi - lo, 0)
    buckets = {name: 0 for name in BUCKETS}
    result = {
        "rank": hdr.get("rank", -1),
        "lo_us": lo,
        "hi_us": hi,
        "window_us": window_us,
        "buckets": buckets,
        "utilization": 0.0,
    }
    if window_us == 0:
        return result

    phases = critpath.phase_intervals(dump)
    intervals = {
        "stall": phases["stall"],
        "exposed_wire": phases["wire"],
        "negotiation": phases["negotiation"],
        **_serving_intervals(dump),
    }

    # Priority claiming: each bucket's contribution is the measure its
    # intervals add to the UNION of everything claimed so far — exact
    # integer math, no double counting (module docstring).
    covered = []
    claimed = 0

    def claim(new):
        nonlocal claimed
        covered.extend(new)
        total = critpath.union_measure(covered, lo, hi)
        delta = total - claimed
        claimed = total
        return delta

    for name in _CLAIM_ORDER:
        buckets[name] = claim(intervals[name])

    # compute: the in-step remainder; idle: the gaps BETWEEN steps.
    buckets["compute"] = claim(steps)
    gaps = [(steps[i][1], steps[i + 1][0])
            for i in range(len(steps) - 1)]
    buckets["idle"] = claim(gaps)
    buckets["unattributed"] = window_us - claimed

    useful = (buckets["compute"] + buckets["exposed_wire"]
              + buckets["negotiation"] + buckets["serving_prefill"]
              + buckets["serving_decode"])
    result["utilization"] = round(useful / window_us, 6)
    return result


def ledger_from_events(events, rank=-1, window=None):
    """The live twin of :func:`ledger_from_dump`: ring-event dicts
    straight from ``hvd.events()`` (axis = the process's own steady
    ``ts_us`` — no wall alignment needed within one rank)."""
    dump = {"header": {"rank": rank, "unix_us": 0, "steady_us": 0},
            "events": list(events)}
    return ledger_from_dump(dump, window=window)


def ledger_signals(ledger):
    """SLO signals derived from one rank's ledger (the names are the
    :data:`telemetry.slo.OBJECTIVES` vocabulary)."""
    w = ledger["window_us"]
    b = ledger["buckets"]
    return {
        "stall_ms": round(b["stall"] / 1000.0, 3),
        "queued_idle_share": round(b["serving_queued"] / w, 6)
        if w else 0.0,
    }


def dominant_phase(ledger):
    """The rank's dominant ATTRIBUTED bucket — the phase a breach names
    (idle/unattributed are absences of evidence, not phases)."""
    best, best_us = "", -1
    for name in BUCKETS:
        if name in ("idle", "unattributed"):
            continue
        if ledger["buckets"][name] > best_us:
            best, best_us = name, ledger["buckets"][name]
    return best if best_us > 0 else ""


def _breach_events(dumps):
    """slo_breach events recorded live, folded out of the dumps (once
    per (rank, seq) — re-dumps repeat ring tails)."""
    seen = set()
    out = []
    for rank, dump in sorted(dumps.items()):
        for ev in dump["events"]:
            if ev.get("type") != "slo_breach":
                continue
            key = (rank, ev.get("seq"))
            if key in seen:
                continue
            seen.add(key)
            out.append({
                "source_rank": rank,
                "objective": ev.get("objective_name"),
                "breach_rank": ev.get("breach_rank"),
                "value": ev.get("value"),
                "phase": ev.get("phase_name"),
                "wall_us": critpath._wall(ev, dump["header"]),
            })
    return out


def analyze(paths_or_dir, dump_index=-1, objectives=None, window=None):
    """Post-mortem fleet analysis over per-rank black-box dumps: the
    ``report --fleet`` engine.

    Per-rank ledgers use each rank's own observed window (cross-rank
    clock skew must not leak into reconciliation); the fleet aggregates
    are sums/means over them. Worst-rank attribution rides critpath's
    blocking-rank verdicts when step windows exist. SLO verdicts
    combine breach events found IN the dumps (recorded live) with a
    fresh evaluation of the ledger-derived signals, so a fleet whose
    live engine never ran still gets judged."""
    paths = postmortem.collect_paths(paths_or_dir)
    dumps = {}
    for path in paths:
        loaded = postmortem.load_blackbox(path)
        if loaded:
            dump = loaded[dump_index]
            dumps[dump["header"].get("rank", -1)] = dump
    if not dumps:
        raise ValueError(f"no event dumps found in {paths_or_dir!r}")

    ledgers = {r: ledger_from_dump(d, window=window)
               for r, d in sorted(dumps.items())}

    fleet_buckets = {name: sum(l["buckets"][name]
                               for l in ledgers.values())
                     for name in BUCKETS}
    total_us = sum(l["window_us"] for l in ledgers.values())

    # Worst-rank attribution via critpath (module docstring): the rank
    # that bounded the most steps. Dump sets without step windows
    # (pure serving lanes) fall back to lowest utilization.
    worst_rank, worst_via = None, "utilization"
    try:
        cp = critpath.critical_path(paths_or_dir, dump_index)
        if cp["blocking_counts"]:
            worst_rank = max(cp["blocking_counts"],
                             key=cp["blocking_counts"].get)
            worst_via = "critpath"
    except ValueError:
        cp = None
    if worst_rank is None and ledgers:
        worst_rank = min(ledgers, key=lambda r: ledgers[r]["utilization"])

    engine = slo.SloEngine(objectives if objectives is not None
                           else slo.DEFAULT_OBJECTIVES)
    per_rank_signals = {r: ledger_signals(l) for r, l in ledgers.items()}
    phases = {r: dominant_phase(l) for r, l in ledgers.items()}
    evaluated = engine.evaluate(per_rank_signals, phases)

    return {
        "ranks": sorted(ledgers),
        "per_rank": ledgers,
        "fleet": {
            "window_us": total_us,
            "rank_seconds": {name: round(us / 1e6, 6)
                             for name, us in fleet_buckets.items()},
            "utilization": round(
                sum(l["utilization"] * l["window_us"]
                    for l in ledgers.values()) / total_us, 6)
            if total_us else 0.0,
            "worst_rank": worst_rank,
            "worst_via": worst_via,
        },
        "slo": {
            "objectives": [f"{o.name} {o.op} {o.threshold:g}"
                           for o in engine.objectives],
            "breach_events": _breach_events(dumps),
            "evaluated": [vars(b) for b in evaluated],
        },
        "critpath": {k: cp[k] for k in ("blocking_counts",
                                        "phase_counts")} if cp else None,
    }


def format_fleet(analysis, max_ranks=64):
    """Operator-facing rendering: the per-rank utilization table, the
    fleet rank-seconds line, worst-rank attribution, and the SLO
    verdicts."""
    lines = []
    fleet = analysis["fleet"]
    rs = fleet["rank_seconds"]
    occupied = {k: v for k, v in rs.items() if v > 0}
    lines.append(
        f"fleet: {len(analysis['ranks'])} ranks, "
        f"{fleet['window_us'] / 1e6:.3f} rank-seconds observed, "
        f"utilization {fleet['utilization']:.1%}")
    lines.append("rank-seconds: " + ", ".join(
        f"{k}={v:.3f}s" for k, v in sorted(
            occupied.items(), key=lambda kv: -kv[1])))
    if fleet["worst_rank"] is not None:
        lines.append(f"worst rank: {fleet['worst_rank']} "
                     f"(via {fleet['worst_via']})")
    header = (f"{'rank':>5} {'window ms':>10} {'util':>6} "
              + " ".join(f"{name:>15}" for name in BUCKETS))
    lines.append(header)
    for rank in analysis["ranks"][:max_ranks]:
        l = analysis["per_rank"][rank]
        lines.append(
            f"{rank:>5} {l['window_us'] / 1000.0:>10.1f} "
            f"{l['utilization']:>6.1%} "
            + " ".join(f"{l['buckets'][name] / 1000.0:>13.1f}ms"
                       for name in BUCKETS))
    if len(analysis["ranks"]) > max_ranks:
        lines.append(f"... {len(analysis['ranks']) - max_ranks} more "
                     f"ranks")
    breaches = analysis["slo"]["breach_events"]
    evaluated = analysis["slo"]["evaluated"]
    if breaches or evaluated:
        lines.append(f"slo: {len(breaches)} recorded breach event(s), "
                     f"{len(evaluated)} from re-evaluation")
        for b in breaches:
            lines.append(f"  breach [{b['objective']}] rank "
                         f"{b['breach_rank']} value={b['value']} "
                         f"phase={b['phase']}")
        for b in evaluated:
            lines.append(f"  breach [{b['objective']}] rank {b['rank']} "
                         f"value={b['value']:g} phase={b['phase']}")
    else:
        lines.append("slo: no breaches")
    return "\n".join(lines)


# ---- live aggregation -------------------------------------------------


def _http_json(url, timeout):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class FleetObservatory:
    """Live fleet aggregator: poll every rank's debug server into one
    time series, evaluate the declared SLOs per poll, and serve the
    combined view (the ``/fleet`` endpoint payload).

    ``endpoints`` is ``{rank: "host:port"}``; when omitted it is
    derived the way the debug servers themselves bind:
    ``HOROVOD_DEBUG_PORT + rank`` for ``HOROVOD_SIZE`` ranks on
    loopback. Ephemeral-port worlds (``HOROVOD_DEBUG_PORT=0``) must
    pass explicit endpoints — there is nothing to derive.

    Each poll fetches ``/healthz`` (the autoscaler signal set) and the
    ``/events`` tail (the per-rank ledger input). SLOs are evaluated
    per rank over healthz signals + ledger-derived signals; breaches
    are recorded into the LOCAL ring via ``basics.record_slo`` when a
    ``basics`` was given (rank 0's black box then carries the fleet's
    verdicts), and always kept on ``engine.breaches``.
    """

    def __init__(self, endpoints=None, basics=None, objectives=None,
                 timeout=2.0, events_tail=4096, history=256):
        self.endpoints = dict(endpoints) if endpoints else None
        self.basics = basics
        self.timeout = float(timeout)
        self.events_tail = int(events_tail)
        if objectives is None:
            objectives = os.environ.get("HOROVOD_SLO") or \
                slo.DEFAULT_OBJECTIVES
        self.engine = slo.SloEngine(objectives)
        self.history = deque(maxlen=int(history))
        # Last /fleet view, read (not recomputed) by
        # autoscale.read_fleet_signals — an autoscaler observation
        # must never trigger a fleet-wide HTTP sweep.
        self.last_view = None

    def resolve_endpoints(self):
        if self.endpoints is not None:
            return self.endpoints
        base = int(os.environ.get("HOROVOD_DEBUG_PORT", "0") or 0)
        size = int(os.environ.get("HOROVOD_SIZE", "0") or 0)
        if base <= 0 or size <= 0:
            return {}
        host = os.environ.get("HOROVOD_DEBUG_HOST", "127.0.0.1")
        if host == "0.0.0.0":  # bind-all is not a dial-able address
            host = "127.0.0.1"
        self.endpoints = {r: f"{host}:{base + r}" for r in range(size)}
        return self.endpoints

    def poll(self):
        """One fleet sweep. Unreachable ranks are reported, not fatal —
        a fleet view that dies with its sickest rank is useless."""
        sample = {"ts": time.time(), "ranks": {}, "breaches": []}
        per_rank_signals, phases = {}, {}
        for rank, addr in sorted(self.resolve_endpoints().items()):
            entry = {"endpoint": addr}
            try:
                health = _http_json(f"http://{addr}/healthz",
                                    self.timeout)
                events = _http_json(
                    f"http://{addr}/events?n={self.events_tail}",
                    self.timeout)
                ledger = ledger_from_events(events, rank=rank)
                entry["healthz"] = health
                entry["ledger"] = ledger
                signals = {
                    name: health[name] for name in slo.OBJECTIVES
                    if name in health
                }
                signals.update(ledger_signals(ledger))
                per_rank_signals[rank] = signals
                phases[rank] = dominant_phase(ledger)
            except Exception as e:  # noqa: BLE001 — sick ranks stay rows
                entry["error"] = f"{type(e).__name__}: {e}"
            sample["ranks"][rank] = entry
        breaches = self.engine.evaluate(per_rank_signals, phases)
        if breaches and self.basics is not None:
            self.engine.record(self.basics, breaches)
        sample["breaches"] = [vars(b) for b in breaches]
        self.history.append(sample)
        return sample

    def fleet_json(self):
        """The ``/fleet`` payload: a fresh poll plus the aggregate view
        and the utilization series polled so far."""
        sample = self.poll()
        ledgers = {r: e["ledger"] for r, e in sample["ranks"].items()
                   if "ledger" in e}
        total_us = sum(l["window_us"] for l in ledgers.values())
        view = {
            "ts": sample["ts"],
            "size": len(sample["ranks"]),
            "reachable": len(ledgers),
            "ranks": sample["ranks"],
            "fleet": {
                "window_us": total_us,
                "rank_seconds": {
                    name: round(sum(l["buckets"][name]
                                    for l in ledgers.values()) / 1e6, 6)
                    for name in BUCKETS
                },
                "utilization": round(
                    sum(l["utilization"] * l["window_us"]
                        for l in ledgers.values()) / total_us, 6)
                if total_us else 0.0,
                "worst_rank": min(
                    ledgers, key=lambda r: ledgers[r]["utilization"])
                if ledgers else None,
            },
            "slo": {
                "objectives": [f"{o.name} {o.op} {o.threshold:g}"
                               for o in self.engine.objectives],
                "breaches": sample["breaches"],
                "breaches_total": len(self.engine.breaches),
            },
            "series": {
                "utilization": [
                    {str(r): e["ledger"]["utilization"]
                     for r, e in s["ranks"].items() if "ledger" in e}
                    for s in self.history
                ],
            },
        }
        self.last_view = view
        return view


_observatory = None
_observatory_lock = threading.Lock()


def maybe_observatory(basics):
    """The process-wide observatory the ``/fleet`` debug endpoint
    serves from (lazy — a fleet poll costs one HTTP round per rank, so
    nothing happens until someone asks)."""
    global _observatory
    with _observatory_lock:
        if _observatory is None:
            _observatory = FleetObservatory(basics=basics)
        return _observatory


def reset_observatory():
    """Test isolation: drop the process-wide observatory (endpoint
    derivation caches env)."""
    global _observatory
    with _observatory_lock:
        _observatory = None
