"""Telemetry-driven autoscaler: elastic as capacity management.

The port's own copy of ``horovod_tpu/telemetry/autoscale.py``. The
elastic machinery treats a world-size change as a fault response (a
peer dies, the survivors shrink; a joiner knocks, the parole door grows
the world). This module drives the same rejoin and shrink the other way
round, from the signals the lane already serves (queue depth, straggler
skew, step-time trend, fault rates, joiners at the door, the serving
and fleet fields of ``/healthz``). Three layers:

- :class:`Signals`, one observation; :func:`collect_signals` fills it
  from the live lane (the fields ``/healthz`` serves, so an autoscaler
  polling HTTP decides the same);
- :class:`AutoscalePolicy`, a PURE decision function over an
  observation stream (no clock reads, no side effects): consecutive-
  breach streaks, an up/down deadband and a post-action cooldown keep a
  flapping signal from oscillating the world size;
- :class:`Autoscaler`, the glue that applies a decision through
  ``grow``/``shrink`` callbacks: a joiner that enters through the parole
  door (``hvd.elastic.rejoin``, absorbed at the next commit) and
  ``hvd.elastic.shrink``.

:data:`SERVING_SIGNAL_DEFAULTS` is the one literal every consumer of the
serving fields shares (``/healthz``, ``serving/service.py
serving_signals``): ``kv_blocks_*`` -1 means no pool in this process,
distinct from a pool momentarily empty; zeros elsewhere mean no service
live or nothing measured yet. :func:`read_fleet_signals` reads the fleet
observatory's last view (``telemetry/fleet.py``).
"""

import sys
import time
from collections import deque
from dataclasses import dataclass, field

SERVING_SIGNAL_DEFAULTS = {
    "serving_queue_depth": 0,
    "inflight_sequences": 0,
    "kv_blocks_free": -1,
    "kv_blocks_total": -1,
    "serving_p50_ms": 0.0,
    "serving_p99_ms": 0.0,
    "requests_served": 0,
    "recomputed_prefill_tokens": 0,
    "useful_tokens": 0,
    "eviction_amplification": 0.0,
}


def read_serving_signals():
    """The live serving loop's signals, or the defaults. The serving
    module is looked up, not imported: a process that serves nothing
    never imports it for a health check."""
    svc = sys.modules.get("horovod_tpu_torch.serving.service")
    if svc is not None:
        try:
            return svc.serving_signals()
        except Exception:  # noqa: BLE001: the health check must answer
            pass
    return dict(SERVING_SIGNAL_DEFAULTS)


def read_fleet_signals():
    """The fleet observatory's signal dict, or zeros. Looked up as
    :func:`read_serving_signals` is: a process that never served
    ``/fleet`` never imports the fleet module, and a live observatory is
    read from its LAST poll (an observation never starts a fleet-wide
    HTTP sweep)."""
    out = {"slo_breaches": 0, "fleet_utilization": 0.0,
           "rank_seconds_unattributed_share": 0.0}
    fleet = sys.modules.get("horovod_tpu_torch.telemetry.fleet")
    if fleet is None or fleet._observatory is None:
        return out
    try:
        obs = fleet._observatory
        out["slo_breaches"] = len(obs.engine.breaches)
        view = obs.last_view
        if view:
            out["fleet_utilization"] = view["fleet"]["utilization"]
            total_s = view["fleet"]["window_us"] / 1e6
            if total_s > 0:
                out["rank_seconds_unattributed_share"] = round(
                    view["fleet"]["rank_seconds"]["unattributed"]
                    / total_s, 6)
    except Exception:  # noqa: BLE001: the signals must come back
        pass
    return out


@dataclass
class Signals:
    """One autoscaler observation. Every field after ``world_size`` has
    a default, so an older observation source (a recorded trace, a
    ``/healthz`` without some fields) still constructs one."""

    t: float                       # observation time, seconds (any
    #                                monotonic origin; the policy only
    #                                differences it for cooldowns)
    world_size: int
    queue_depth: int = 0           # pending collectives in the lane
    straggler_skew_ms: float = 0.0  # negotiation skew p90
    step_time_ms: float = 0.0      # step-time EWMA (0 = unknown)
    heal_rate: float = 0.0         # wire heals since last observation
    fault_rate: float = 0.0        # faults since last observation
    pending_rejoiners: int = 0     # paroled joiners waiting at the door
    # The overlap ledger's hidden/total wire fraction and cumulative
    # exposed wire time (``common/metrics.py OverlapLedger``).
    overlap_efficiency: float = 0.0
    exposed_wire_ms: float = 0.0
    # The serving loop's /healthz fields (SERVING_SIGNAL_DEFAULTS);
    # kv_blocks_* -1 = no pool in this process. The policy reads none of
    # the serving or fleet fields yet: they make a latency-pressured or
    # breaching fleet visible to a later policy.
    serving_queue_depth: int = 0
    inflight_sequences: int = 0
    kv_blocks_free: int = -1
    kv_blocks_total: int = -1
    serving_p50_ms: float = 0.0
    serving_p99_ms: float = 0.0
    requests_served: int = 0
    recomputed_prefill_tokens: int = 0
    useful_tokens: int = 0
    eviction_amplification: float = 0.0
    # The fleet observatory's view (read_fleet_signals): SLO breaches it
    # evaluated, breaches since the last observation, the fleet's
    # utilization at its last poll (0 = no fleet view in this process)
    # and the share of the rank-seconds the ledger could not attribute.
    slo_breaches: int = 0
    slo_breach_rate: float = 0.0
    fleet_utilization: float = 0.0
    rank_seconds_unattributed_share: float = 0.0


@dataclass
class Decision:
    action: str                    # "up" | "down" | "hold"
    target_size: int
    reason: str


@dataclass
class AutoscalePolicy:
    """Pure hysteresis policy: ``decide`` maps an observation stream to
    scale decisions, deterministically.

    Scale-up pressure: ``queue_depth > up_queue_depth`` or the
    step-time EWMA exceeding ``up_step_time_ratio`` x its own slow
    baseline. Scale-down pressure: queue at/below ``down_queue_depth``
    AND straggler skew under ``down_skew_ms`` (an idle world that is
    also not limping). A breach only becomes a decision after
    ``up_consecutive``/``down_consecutive`` observations in a row, any
    decision opens a ``cooldown_s`` window of forced holds, and the
    deadband between the up and down conditions means a signal flapping
    around either threshold resets the opposite streak instead of
    reversing the world — the three stabilizers that make oscillation
    structurally impossible.

    Instability gates scaling entirely: while faults/heals are moving
    (``fault_rate``/``heal_rate`` > 0) the policy holds — resizing a
    world that is mid-recovery would race the elastic machinery it
    drives.
    """

    min_size: int = 1
    max_size: int = 256
    step: int = 1                  # ranks per decision
    up_queue_depth: int = 8
    up_step_time_ratio: float = 1.5
    down_queue_depth: int = 0
    down_skew_ms: float = 50.0
    up_consecutive: int = 3
    down_consecutive: int = 6
    cooldown_s: float = 30.0
    baseline_alpha: float = 0.05   # slow step-time baseline EWMA

    _up_streak: int = field(default=0, repr=False)
    _down_streak: int = field(default=0, repr=False)
    _cooldown_until: float = field(default=float("-inf"), repr=False)
    _baseline_ms: float = field(default=0.0, repr=False)

    def _overloaded(self, s):
        if s.queue_depth > self.up_queue_depth:
            return f"queue_depth {s.queue_depth} > {self.up_queue_depth}"
        if (self._baseline_ms > 0.0 and s.step_time_ms
                > self.up_step_time_ratio * self._baseline_ms):
            return (f"step_time {s.step_time_ms:.1f}ms > "
                    f"{self.up_step_time_ratio:.2f}x baseline "
                    f"{self._baseline_ms:.1f}ms")
        return None

    def _idle(self, s):
        return (s.queue_depth <= self.down_queue_depth
                and s.straggler_skew_ms <= self.down_skew_ms)

    def decide(self, s):
        """One observation -> one :class:`Decision` (pure; mutates only
        the policy's own streak/cooldown/baseline state)."""
        # The baseline tracks step time through every observation —
        # including holds — so "1.5x slower than usual" means usual for
        # THIS model/world, not a configured absolute.
        if s.step_time_ms > 0.0:
            self._baseline_ms = (
                s.step_time_ms if self._baseline_ms == 0.0
                else (1 - self.baseline_alpha) * self._baseline_ms
                + self.baseline_alpha * s.step_time_ms)

        if s.fault_rate > 0 or s.heal_rate > 0:
            self._up_streak = self._down_streak = 0
            return Decision("hold", s.world_size,
                            "unstable: faults/heals in flight")
        if s.t < self._cooldown_until:
            return Decision("hold", s.world_size,
                            "cooldown after last resize")

        overload = self._overloaded(s)
        if overload is not None:
            self._down_streak = 0
            self._up_streak += 1
            if (self._up_streak >= self.up_consecutive
                    and s.world_size < self.max_size):
                self._up_streak = 0
                self._cooldown_until = s.t + self.cooldown_s
                target = min(s.world_size + self.step, self.max_size)
                return Decision("up", target, overload)
            return Decision("hold", s.world_size,
                            f"overload streak {self._up_streak}/"
                            f"{self.up_consecutive}: {overload}")
        if self._idle(s):
            self._up_streak = 0
            self._down_streak += 1
            if (self._down_streak >= self.down_consecutive
                    and s.world_size > self.min_size):
                self._down_streak = 0
                self._cooldown_until = s.t + self.cooldown_s
                target = max(s.world_size - self.step, self.min_size)
                return Decision("down", target, "idle: queue drained, "
                                "skew low")
            return Decision("hold", s.world_size,
                            f"idle streak {self._down_streak}/"
                            f"{self.down_consecutive}")
        # Deadband: neither overloaded nor idle — both streaks reset,
        # so a signal flapping across one threshold can never bank
        # progress toward the opposite action.
        self._up_streak = self._down_streak = 0
        return Decision("hold", s.world_size, "in deadband")


def collect_signals(basics=None, t=None):
    """Fill a :class:`Signals` from the live lane: the values ``/healthz``
    serves, so in-process and HTTP-polling autoscalers see one truth.
    Rate fields are differences against the previous call. ``basics`` is
    ``horovod_tpu_torch.common.basics`` unless given (a stand-in with
    its ``metrics``, ``is_initialized``, ``size`` and ``lane``)."""
    from horovod_tpu_torch.telemetry.step_timer import step_time_ewma_ms

    global _last_counters
    if basics is None:
        from horovod_tpu_torch.common import basics
    snap = basics.metrics()
    elastic = snap.get("elastic", {})
    fleet = read_fleet_signals()
    faults = int(elastic.get("faults_detected", 0))
    # The lane has no wire heals (ROADMAP.md L8): 0 unless a snapshot
    # carries them.
    heals = int(elastic.get("heals", 0))
    breaches = int(fleet["slo_breaches"])
    prev = _last_counters or {"faults": faults, "heals": heals,
                              "breaches": breaches}
    _last_counters = {"faults": faults, "heals": heals,
                      "breaches": breaches}
    live = basics.is_initialized()
    overlap = snap.get("wire", {}).get("overlap", {})
    serving = read_serving_signals()
    return Signals(
        t=time.monotonic() if t is None else t,
        world_size=basics.size() if live else 1,
        queue_depth=basics.lane().queue.depth() if live else 0,
        straggler_skew_ms=float(snap.get("straggler", {}).get(
            "skew_us", {}).get("p90_us", 0)) / 1000.0,
        step_time_ms=step_time_ewma_ms() or 0.0,
        heal_rate=float(heals - prev["heals"]),
        fault_rate=float(faults - prev["faults"]),
        pending_rejoiners=pending_rejoiners(),
        overlap_efficiency=float(overlap.get("overlap_efficiency", 0.0)),
        exposed_wire_ms=float(overlap.get("exposed_wire_ms", 0.0)),
        serving_queue_depth=int(serving["serving_queue_depth"]),
        inflight_sequences=int(serving["inflight_sequences"]),
        kv_blocks_free=int(serving["kv_blocks_free"]),
        kv_blocks_total=int(serving["kv_blocks_total"]),
        serving_p50_ms=float(serving["serving_p50_ms"]),
        serving_p99_ms=float(serving["serving_p99_ms"]),
        requests_served=int(serving["requests_served"]),
        recomputed_prefill_tokens=int(
            serving["recomputed_prefill_tokens"]),
        useful_tokens=int(serving["useful_tokens"]),
        eviction_amplification=float(serving["eviction_amplification"]),
        slo_breaches=breaches,
        slo_breach_rate=float(breaches - prev["breaches"]),
        fleet_utilization=float(fleet["fleet_utilization"]),
        rank_seconds_unattributed_share=float(
            fleet["rank_seconds_unattributed_share"]),
    )


def pending_rejoiners():
    """The joiners held at rank 0's parole door (0 elsewhere, and in a
    process that never imported the elastic module)."""
    elastic = sys.modules.get("horovod_tpu_torch.common.elastic")
    door = None if elastic is None else elastic._door
    return 0 if door is None else door.pending_count()


_last_counters = None


class Autoscaler:
    """Driver glue: observe -> decide -> act.

    ``grow(decision)`` / ``shrink(decision)`` apply the resize: in a
    driverless world, grow starts (or admits) a worker that enters
    through the parole door (``hvd.elastic.rejoin``) and is absorbed at
    the next commit, shrink calls ``hvd.elastic.shrink``
    (``common/elastic.py``). Both default to no-ops, so an observe-only
    autoscaler can log its decisions first.

    IMPORTANT (SPMD): when every rank runs its own Autoscaler, the
    DECISION must be rank-uniform — feed the policy rank-0's signals
    (broadcast them) or run the autoscaler on rank 0 / the driver only;
    a per-rank decision from per-rank signals would desynchronize the
    world (the same agreement rule as the rejoin-poll collective).
    """

    def __init__(self, policy=None, collect=None, grow=None, shrink=None,
                 history=256):
        self.policy = policy or AutoscalePolicy()
        self.collect = collect or collect_signals
        self.grow = grow
        self.shrink = shrink
        # Bounded: a driver polling every few seconds for weeks must not
        # grow without limit; the newest window is what debugging wants.
        self.history = deque(maxlen=history)

    def step(self):
        """One observe/decide/act cycle; returns the Decision."""
        s = self.collect()
        d = self.policy.decide(s)
        self.history.append((s, d))
        if d.action == "up" and self.grow is not None:
            self.grow(d)
        elif d.action == "down" and self.shrink is not None:
            self.shrink(d)
        return d
