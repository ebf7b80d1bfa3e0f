"""Declarative SLO engine over per-rank fleet signals.

The port's own copy of ``horovod_tpu/telemetry/slo.py``. An *objective*
is one line of grammar::

    serving_p99_ms < 250        # breach when the signal rises past 250
    overlap_efficiency > 0.4    # breach when it falls below 0.4
    step_time_ewma_ms drift> 1.5  # breach when it exceeds 1.5x the
                                  # engine's own frozen EWMA baseline
    stall_ms < 500              # ledger stall bucket per window

The signal names are the :data:`OBJECTIVES` vocabulary, in the order of
the reference's ``csrc/events.h SloObjective`` (``common/events.py
SLO_OBJECTIVES``), because a breach enters the event ring by id:
:meth:`SloEngine.record` writes one ``slo_breach`` event per breach
(``common/basics.py record_slo``) naming the breaching rank and its
dominant rank-seconds bucket, which a black-box or live dump carries
into the post-mortem fold (``telemetry/postmortem.py``) and
``report --fleet``, and which ``telemetry/autoscale.py Signals`` reads
live (``slo_breaches``, ``slo_breach_rate``).

Evaluation is PER RANK: each objective is judged against each rank's
own signal value, so the breaching rank is the rank whose signal
breached, never a fleet average. The engine is a pure function of the
observation stream and its own drift baselines: no lane, no processes,
deterministic under replay.
"""

from dataclasses import dataclass

from horovod_tpu_torch.common.events import RANK_BUCKETS, SLO_OBJECTIVES

# Objective (signal) names, the event's ids by index. Breach values are
# integral on the ring: *_ms objectives record rounded milliseconds,
# ratio objectives permille.
OBJECTIVES = SLO_OBJECTIVES

_RATIO_OBJECTIVES = frozenset(("overlap_efficiency", "queued_idle_share"))

# Drift baselines need this many samples before judging: a cold engine
# must not flag the first observation against an empty baseline.
_DRIFT_WARMUP = 3


@dataclass(frozen=True)
class Objective:
    """One parsed objective. ``op`` is ``"<"`` (breach when the signal
    rises past ``threshold``), ``">"`` (breach when it falls below), or
    ``"drift>"`` (breach when it exceeds ``threshold`` x the engine's
    per-rank EWMA baseline of the same signal)."""

    name: str
    op: str
    threshold: float

    def breached(self, value, baseline=None):
        if self.op == "<":
            return value > self.threshold
        if self.op == ">":
            return value < self.threshold
        # drift>: None (still warming up) is never a breach.
        if baseline is None or baseline <= 0:
            return False
        return value > self.threshold * baseline


@dataclass(frozen=True)
class Breach:
    """One breach: objective name, the breaching rank, the observed
    value, and the rank's dominant rank-seconds bucket (``""`` when no
    ledger rode along)."""

    objective: str
    rank: int
    value: float
    phase: str = ""


def parse(spec):
    """Parse one objective line. Raises ``ValueError`` on an unknown
    signal name or operator: a mistyped SLO must fail loudly, not
    silently never breach."""
    parts = spec.split()
    if len(parts) != 3:
        raise ValueError(f"SLO objective {spec!r}: expected "
                         f"'<signal> <op> <threshold>'")
    name, op, thr = parts
    if name not in OBJECTIVES:
        raise ValueError(f"SLO objective {spec!r}: unknown signal "
                         f"{name!r} (one of {', '.join(OBJECTIVES)})")
    if op not in ("<", ">", "drift>"):
        raise ValueError(f"SLO objective {spec!r}: unknown operator "
                         f"{op!r} (one of <, >, drift>)")
    return Objective(name, op, float(thr))


def parse_all(specs):
    """Parse an iterable of objective lines (or one ``;``/newline-
    separated string) into a tuple of :class:`Objective`."""
    if isinstance(specs, str):
        specs = [s for chunk in specs.splitlines()
                 for s in chunk.split(";")]
    out = []
    for s in specs:
        s = s.strip()
        if s:
            out.append(parse(s))
    return tuple(out)


# What the fleet observatory evaluates when the operator declares
# nothing (``HOROVOD_SLO`` overrides): loose on purpose, to flag a
# pathology (a multi-second stall, a halved step time), not headroom.
DEFAULT_OBJECTIVES = (
    "serving_p99_ms < 2000",
    "step_time_ewma_ms drift> 2.0",
    "stall_ms < 500",
)


class SloEngine:
    """Evaluate declared objectives against per-rank signal dicts and
    (optionally) record the breaches into the event ring."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES, baseline_alpha=0.3):
        self.objectives = parse_all(objectives)
        self.baseline_alpha = float(baseline_alpha)
        # (rank, signal) -> [ewma, samples] for drift> objectives. The
        # baseline learns from non-breaching observations only: a
        # sustained regression must not teach the engine that slow is
        # normal.
        self._baselines = {}
        self.breaches = []  # every breach evaluated, in order

    def _baseline(self, rank, name):
        ent = self._baselines.get((rank, name))
        if ent is None or ent[1] < _DRIFT_WARMUP:
            return None
        return ent[0]

    def _learn(self, rank, name, value):
        ent = self._baselines.setdefault((rank, name), [float(value), 0])
        a = self.baseline_alpha
        ent[0] = (1 - a) * ent[0] + a * float(value)
        ent[1] += 1

    def evaluate(self, per_rank, phases=None):
        """Judge every objective against every rank's signals.

        ``per_rank`` is ``{rank: {signal_name: value}}`` (a missing
        signal is not judged: a train-only rank carries no
        ``serving_p99_ms``); ``phases`` optionally maps a rank to its
        dominant rank-seconds bucket (``fleet.dominant_phase``). Returns
        the new :class:`Breach` list (also appended to
        ``self.breaches``)."""
        out = []
        for rank in sorted(per_rank):
            signals = per_rank[rank]
            phase = (phases or {}).get(rank, "")
            for obj in self.objectives:
                if obj.name not in signals:
                    continue
                value = float(signals[obj.name])
                if obj.op == "drift>":
                    hit = obj.breached(value, self._baseline(rank, obj.name))
                    if not hit:
                        self._learn(rank, obj.name, value)
                else:
                    hit = obj.breached(value)
                if hit:
                    out.append(Breach(obj.name, int(rank), value, phase))
        self.breaches.extend(out)
        return out

    def record(self, basics, breaches):
        """Write one ``slo_breach`` event per breach through
        ``basics.record_slo`` (``horovod_tpu_torch.common.basics``, or
        anything with its signature). Safe before ``init()``."""
        for b in breaches:
            value = (int(round(b.value * 1000))
                     if b.objective in _RATIO_OBJECTIVES
                     else int(round(b.value)))
            bucket = (RANK_BUCKETS.index(b.phase)
                      if b.phase in RANK_BUCKETS else -1)
            basics.record_slo(OBJECTIVES.index(b.objective), b.rank,
                              value, bucket)
        return len(breaches)
