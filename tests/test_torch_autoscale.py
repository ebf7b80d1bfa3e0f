"""The port's autoscaler against the JAX package's.

- ``AutoscalePolicy`` is held to ``horovod_tpu.telemetry.autoscale``'s
  on every signal trace of ``tests/single/test_autoscale.py`` (ramp,
  spike, flap, idle, trend, instability, max size, the older field
  sets): the same ``Decision`` at every step, and the same streaks,
  cooldown and baseline after it.
- ``Autoscaler`` drives its callbacks as JAX's does, and
  ``collect_signals`` reads the port's lane (before ``init`` here).
- The autoscaler grows a gloo world through the parole door and shrinks
  it back (``tests/parallel/test_autoscale_chaos.py:186``): two ranks,
  a joiner knocking, an offered-load trace that overloads steps 0-1 and
  idles after; the world runs 2, 3, then 2 ranks, every rank on the
  reference trajectory, no fault.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_elastic_rejoin import _api, _await_knock, run_world
from tests.test_torch_mp import free_port, lazy_module

jas = lazy_module("horovod_tpu.telemetry.autoscale")


def _port():
    from horovod_tpu_torch.telemetry import autoscale

    return autoscale


def _sig(mod, t, size=4, queue=0, skew=0.0, step=0.0, faults=0.0,
         heals=0.0, **extra):
    """``tests/single/test_autoscale.py _sig`` on either package."""
    return mod.Signals(t=float(t), world_size=size, queue_depth=queue,
                       straggler_skew_ms=skew, step_time_ms=step,
                       fault_rate=faults, heal_rate=heals, **extra)


def _policy(mod, **kw):
    """``tests/single/test_autoscale.py _policy``'s defaults."""
    kw.setdefault("up_consecutive", 3)
    kw.setdefault("down_consecutive", 4)
    kw.setdefault("cooldown_s", 10.0)
    kw.setdefault("min_size", 2)
    kw.setdefault("max_size", 8)
    return mod.AutoscalePolicy(**kw)


# Each trace of tests/single/test_autoscale.py: (policy knobs, the
# observations as _sig keyword sets).
TRACES = {
    "ramp": ({}, [dict(t=t, queue=20) for t in range(8)]
             + [dict(t=13 + t, size=5, queue=20) for t in range(4)]),
    "spike": ({}, [dict(t=0, queue=0), dict(t=1, queue=100)]
              + [dict(t=2 + t, queue=0, skew=0.1) for t in range(3)]),
    "flap": ({}, [dict(t=t, queue=100 if t % 2 == 0 else 0,
                       skew=0.0 if t % 2 == 0 else 200.0)
                  for t in range(40)]),
    "idle": (dict(cooldown_s=2.0),
             [dict(t=t, size=3, queue=0, skew=1.0) for t in range(30)]),
    "idle_at_min": ({}, [dict(t=t, size=2, queue=0) for t in range(10)]),
    "trend": (dict(up_consecutive=2, baseline_alpha=0.0),
              [dict(t=t, step=100.0, queue=5, skew=100.0) for t in range(5)]
              + [dict(t=10 + t, step=220.0, queue=0, skew=100.0)
                 for t in range(3)]),
    "instability": (dict(up_consecutive=1, down_consecutive=1),
                    [dict(t=0, queue=100, faults=1.0),
                     dict(t=1, queue=0, heals=2.0), dict(t=2, queue=100)]),
    "max_size": (dict(up_consecutive=1), [dict(t=0, size=8, queue=100)]),
    "older_fields": ({}, [dict(t=0), dict(t=1, overlap_efficiency=0.8,
                                          exposed_wire_ms=123.4)]),
    "fleet_fields": ({}, [dict(t=0), dict(
        t=1, slo_breaches=7, slo_breach_rate=2.0, fleet_utilization=0.42,
        rank_seconds_unattributed_share=0.03)]),
    "default_policy": (dict(up_consecutive=3, down_consecutive=6,
                            cooldown_s=30.0, min_size=1, max_size=256),
                       [dict(t=t, size=4, queue=q, skew=s, step=st)
                        for t, (q, s, st) in enumerate(
                            [(9, 0.0, 100.0)] * 4 + [(0, 10.0, 120.0)] * 8
                            + [(4, 60.0, 300.0)] * 4
                            + [(0, 0.0, 100.0)] * 40)]),
}


def _state(policy):
    return (policy._up_streak, policy._down_streak,
            policy._cooldown_until, policy._baseline_ms)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_policy_decides_as_the_jax_policy(name):
    knobs, trace = TRACES[name]
    port, ref = _policy(_port(), **knobs), _policy(jas, **knobs)
    for obs in trace:
        d_port = port.decide(_sig(_port(), **obs))
        d_ref = ref.decide(_sig(jas, **obs))
        assert dataclasses.asdict(d_port) == dataclasses.asdict(d_ref), obs
        assert _state(port) == _state(ref), obs


def test_the_jax_tests_traces_give_their_actions():
    """The traces above are the JAX tests' own: their pinned actions
    hold on the port's policy."""
    port = _port()
    p = _policy(port)
    actions = [p.decide(_sig(port, **o)).action
               for o in TRACES["ramp"][1]]
    assert actions[:3] == ["hold", "hold", "up"]
    assert actions[8:11] == ["hold", "hold", "up"]
    p = _policy(port, cooldown_s=2.0)
    downs = [d for d in (p.decide(_sig(port, **o))
                         for o in TRACES["idle"][1]) if d.action == "down"]
    assert downs[0].target_size == 2
    p = _policy(port)
    assert all(p.decide(_sig(port, **o)).action == "hold"
               for o in TRACES["flap"][1])


def test_signals_fields_match_the_jax_package():
    port = _port()
    assert [(f.name, f.default) for f in dataclasses.fields(port.Signals)] \
        == [(f.name, f.default) for f in dataclasses.fields(jas.Signals)]
    assert [(f.name, f.default)
            for f in dataclasses.fields(port.AutoscalePolicy)] == \
        [(f.name, f.default) for f in dataclasses.fields(jas.AutoscalePolicy)]
    assert port.SERVING_SIGNAL_DEFAULTS == jas.SERVING_SIGNAL_DEFAULTS


def test_autoscaler_applies_decisions_via_callbacks():
    """``test_autoscale.py::test_autoscaler_driver_applies_decisions_via_
    callbacks`` on both packages: the same calls, the same history."""
    got = {}
    for key, mod in (("port", _port()), ("ref", jas)):
        calls = []
        feed = iter([_sig(mod, t, queue=20) for t in range(3)]
                    + [_sig(mod, 20 + t, size=5, queue=0, skew=0.0)
                       for t in range(6)])
        a = mod.Autoscaler(
            policy=_policy(mod, up_consecutive=3, down_consecutive=4,
                           cooldown_s=1.0),
            collect=lambda feed=feed: next(feed),
            grow=lambda d, calls=calls: calls.append(("grow", d.target_size)),
            shrink=lambda d, calls=calls: calls.append(
                ("shrink", d.target_size)),
            history=4)
        decisions = [dataclasses.asdict(a.step()) for _ in range(9)]
        got[key] = (calls, decisions, len(a.history))
    assert got["port"] == got["ref"]
    assert got["port"][0] == [("grow", 5), ("shrink", 4)]
    assert got["port"][2] == 4


def test_collect_signals_before_init_and_fleet_signals():
    port = _port()
    from horovod_tpu_torch.telemetry import fleet

    fleet.reset_observatory()
    s = port.collect_signals(t=5.0)
    assert (s.t, s.world_size, s.queue_depth, s.pending_rejoiners) == \
        (5.0, 1, 0, 0)
    assert (s.slo_breaches, s.fleet_utilization) == (0, 0.0)
    assert port.read_fleet_signals() == {
        "slo_breaches": 0, "fleet_utilization": 0.0,
        "rank_seconds_unattributed_share": 0.0}
    # A live observatory's last view is read, never polled again.
    obs = fleet.maybe_observatory(None)
    obs.engine.breaches.append(object())
    obs.last_view = {"fleet": {"utilization": 0.5, "window_us": 2_000_000,
                               "rank_seconds": {"unattributed": 0.5}}}
    try:
        assert port.read_fleet_signals() == {
            "slo_breaches": 1, "fleet_utilization": 0.5,
            "rank_seconds_unattributed_share": 0.25}
        s2 = port.collect_signals(t=6.0)
        assert (s2.slo_breaches, s2.slo_breach_rate) == (1, 1.0)
        assert s2.fleet_utilization == 0.5
    finally:
        fleet.reset_observatory()


# ---- the autoscaler drives the parole door and shrink ------------------

_AS_STEPS = 8
_AS_DIM = 97
_AS_LR = 0.1
_AS_BASE = 2
_AS_MAX = 3


def _offered_load(step):
    return 100 if step <= 1 else 0


def _worlds_by_step(step):
    # The up streak completes at step 1's commit, the idle streak at
    # step 5's.
    if step <= 1:
        return (1, 2)
    if step <= 5:
        return (1, 2, 3)
    return (1, 2)


def _reference(through_step=_AS_STEPS):
    p = np.zeros(_AS_DIM, np.float64)
    for s in range(through_step):
        world = _worlds_by_step(s)
        p = p - _AS_LR * 0.01 * (s + 1) * sum(world) / len(world)
    return p


class _Evicted(Exception):
    pass


def _as_train(api, state, epochs_seen, sizes_seen):
    from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
    from horovod_tpu_torch.telemetry import autoscale

    at = {}

    def collect():
        # The live lane's signals, with the offered-load trace as the
        # queue: every rank decides the same at the same commit.
        live = autoscale.collect_signals(t=float(at["step"]))
        return dataclasses.replace(live, queue_depth=_offered_load(
            at["step"]), straggler_skew_ms=0.0)

    def grow(decision):
        # A healthy commit's epoch transition absorbs the joiner.
        raise HostsUpdatedInterrupt(False)

    def shrink(decision):
        if not api.el.shrink(set(range(decision.target_size,
                                       api.b.size()))):
            raise _Evicted()

    scaler = autoscale.Autoscaler(
        policy=autoscale.AutoscalePolicy(
            min_size=_AS_BASE, max_size=_AS_MAX, step=1, up_queue_depth=8,
            up_consecutive=2, down_consecutive=4, down_skew_ms=50.0,
            cooldown_s=0.5),
        collect=collect, grow=grow, shrink=shrink)

    @api.el.run_fn
    def train(state):
        epochs_seen.append(api.b.epoch())
        while state.step < _AS_STEPS:
            g = np.full(_AS_DIM, 0.01 * (state.step + 1)
                        * (api.b.rank() + 1), np.float32)
            mean = api.average(g, f"as.{state.step}.{api.b.epoch()}")
            state.params = state.params - _AS_LR * mean
            sizes_seen.append((state.step, api.b.size()))
            state.step += 1
            state.commit()
            at["step"] = state.step - 1
            scaler.step()
        return state.params

    return train(state), scaler


def _as_run(api, expect_epochs):
    state = api.el.ObjectState(step=0, params=np.zeros(_AS_DIM, np.float32))
    epochs_seen, sizes_seen = [], []
    try:
        params, scaler = _as_train(api, state, epochs_seen, sizes_seen)
    except _Evicted:
        np.testing.assert_allclose(
            state.params, _reference(max(s for s, _ in sizes_seen) + 1),
            rtol=1e-5, atol=1e-7)
        assert not api.b.is_initialized()
        return "evicted"
    np.testing.assert_allclose(params, _reference(), rtol=1e-5, atol=1e-7)
    assert epochs_seen == expect_epochs, epochs_seen
    worlds = set(sizes_seen)
    assert {(0, _AS_BASE), (7, _AS_BASE), (2, _AS_MAX), (5, _AS_MAX)} <= \
        worlds, worlds
    assert (api.b.size(), api.b.epoch()) == (_AS_BASE, 2)
    actions = [d.action for _, d in scaler.history]
    assert actions.count("up") == 1 and actions.count("down") == 1, actions
    el = api.elastic()
    assert el["faults_detected"] == 0 and el["ranks_rejoined"] == 1, el
    api.b.shutdown()
    return "ok"


def _as_survivor(rank, size):
    api = _api("port")
    api.init()
    if rank == 0:
        _await_knock(api)
    return _as_run(api, [0, 1])


def _as_joiner(rank, size):
    import time

    api = _api("port")
    deadline = time.monotonic() + 60
    while True:
        try:
            asg = api.rejoin()
            break
        except (OSError, ConnectionError):
            assert time.monotonic() < deadline, "the door never opened"
            time.sleep(0.2)
    # The joiner is rank 2: the shrink's victim once the load drops.
    assert (asg["rank"], asg["size"]) == (_AS_MAX - 1, _AS_MAX), asg
    return _as_run(api, [1])


def test_autoscaler_grows_through_the_parole_door_then_shrinks_back():
    got = run_world(
        _as_survivor, _AS_BASE,
        env={"HOROVOD_REJOIN_PORT": str(free_port()),
             # Growth is the autoscaler's call, not the commit poll's.
             "HOROVOD_REJOIN_POLL": "0"},
        extra=[(_as_joiner, {"HOROVOD_WORKER_ID": "as-parolee:1"})])
    assert got == {0: "ok", 1: "ok", _AS_BASE: "evicted"}, got
