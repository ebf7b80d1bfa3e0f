"""The port's fleet observatory and SLO engine against the JAX package's.

- **The ledger**: ``ledger_from_dump``, ``analyze`` and ``format_fleet``
  of ``horovod_tpu_torch.telemetry.fleet`` are held to
  ``horovod_tpu.telemetry.fleet``'s, equal to the integer microsecond,
  on three kinds of dump: the hand-built dumps of
  ``tests/single/test_fleet.py`` (its builders), the dumps a two-rank
  gloo world of the port writes (a ``delay`` stall, a serving request,
  breaches recorded through the port's ring), and the JAX simworld
  harness's 64- and 256-rank step dumps.
- **The SLO engine**: the same breaches, encoded values and drift
  baselines as JAX's ``SloEngine`` on seeded observation streams; the
  grammar's rejections with the same messages; the ``slo_breach``
  event's arguments and name tables against ``csrc/events.cc``.
- **The endpoints**: on the live lane, ``/healthz``'s fleet fields
  (zeros, then the observatory's last view), ``/fleet`` (a ledger a rank
  that reconciles) and the 404's route list; the observatory's endpoint
  derivation and its sick-rank rows against JAX's.
- **The readers**: a recorded breach folds once in the post-mortem
  (also when a rank re-dumps its ring) and in ``report --fleet``, the
  CLI run as a process.
"""

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.simworld import harness
from horovod_tpu.telemetry import fleet as jfleet
from horovod_tpu.telemetry import postmortem as jpm
from horovod_tpu.telemetry import report as jreport
from horovod_tpu.telemetry import slo as jslo
from horovod_tpu.telemetry.autoscale import read_fleet_signals
from horovod_tpu_torch.common import events as tevents
from horovod_tpu_torch.telemetry import fleet as tfleet
from horovod_tpu_torch.telemetry import postmortem as tpm
from horovod_tpu_torch.telemetry import report as treport
from horovod_tpu_torch.telemetry import slo as tslo
from tests.single import test_fleet as fleet_cases
from tests.test_torch_mp import free_port, run_ranks

REPO = Path(__file__).resolve().parent.parent
_at = fleet_cases._at


def _same_analysis(path, **kw):
    """``analyze`` and ``format_fleet`` of both packages over ``path``;
    returns the port's analysis."""
    got, want = tfleet.analyze(path, **kw), jfleet.analyze(path, **kw)
    assert got == want
    for max_ranks in (8, 64):
        assert tfleet.format_fleet(got, max_ranks) == \
            jfleet.format_fleet(want, max_ranks)
    return got


def _same_ledgers(path, window=None):
    """Each dump's ledger from both packages; returns the port's."""
    out = []
    for p in sorted(Path(path).glob("blackbox-rank*.jsonl")):
        dump = tpm.load_blackbox(str(p))[-1]
        got = tfleet.ledger_from_dump(dump, window=window)
        assert got == jfleet.ledger_from_dump(dump, window=window)
        assert sum(got["buckets"].values()) == got["window_us"]
        assert tfleet.ledger_signals(got) == jfleet.ledger_signals(got)
        assert tfleet.dominant_phase(got) == jfleet.dominant_phase(got)
        out.append(got)
    return out


# ---- hand-built dumps: tests/single/test_fleet.py's --------------------


def _lead_in():
    """``test_default_window_opens_at_first_step_mark``'s step-marked
    dump with an unmarked lead-in."""
    return [{"ts_us": _at(-30_000), "type": "epoch", "epoch": 1},
            *fleet_cases._known_events()]


def _bare_serving():
    """The same test's unmarked serving rank."""
    return [{"ts_us": _at(5_000), "type": "request", "phase": 0, "rid": 1,
             "aux": 0, "phase_name": "queued"},
            {"ts_us": _at(25_000), "type": "request", "phase": 7, "rid": 1,
             "aux": 0, "phase_name": "done"}]


def _overlap():
    """``test_overlapping_evidence_claims_by_priority_without_double_
    count``'s retry window over a wire span."""
    return [{"ts_us": _at(0), "type": "step_begin", "step": 1},
            {"ts_us": _at(80_000), "type": "retry_window", "attempt": 1,
             "window_ms": 40},
            {"ts_us": _at(90_000), "type": "wire_span", "plane": 0,
             "dur_us": 40_000, "tx_bytes": 1, "rx_bytes": 1},
            {"ts_us": _at(100_000), "type": "step_end", "step": 1,
             "dur_us": 100_000}]


def _two_ranks():
    """The known dump on rank 0 beside a lead-in dump on rank 1 (its
    clock anchored elsewhere) carrying a recorded breach: a fleet."""
    return {0: fleet_cases._known_events(),
            1: [*_lead_in(), {"ts_us": _at(151_000), "type": "slo_breach",
                              "objective": 4, "breach_rank": 1,
                              "value": 900, "phase": 6,
                              "objective_name": "stall_ms",
                              "phase_name": "stall"}]}


HAND_BUILT = {"known": lambda: {0: fleet_cases._known_events()},
              "lead_in": lambda: {0: _lead_in()},
              "bare_serving": lambda: {0: _bare_serving()},
              "overlap": lambda: {0: _overlap()},
              "two_ranks": _two_ranks}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_dumps_match_the_jax_ledger(tmp_path, case):
    for rank, events in HAND_BUILT[case]().items():
        fleet_cases._write_dump(str(tmp_path / f"blackbox-rank{rank}.jsonl"),
                                rank, events, steady0=1000 * rank)
    _same_ledgers(tmp_path)
    # test_explicit_window_books_unseen_time_as_unattributed's window.
    window = (_at(0) + fleet_cases._UNIX0, _at(200_000) + fleet_cases._UNIX0)
    _same_ledgers(tmp_path, window=window)
    _same_analysis(str(tmp_path))
    _same_analysis(str(tmp_path), objectives="stall_ms < 5; "
                   "queued_idle_share < 0.01; serving_p99_ms < 250")
    _same_analysis(str(tmp_path), window=window)


def test_known_dump_books_the_jax_tests_exact_buckets(tmp_path):
    path = fleet_cases._write_dump(str(tmp_path / "blackbox-rank0.jsonl"),
                                   0, fleet_cases._known_events())
    ledger = tfleet.ledger_from_dump(tpm.load_blackbox(path)[-1])
    assert ledger["buckets"] == {
        "compute": 90_000, "exposed_wire": 10_000, "negotiation": 0,
        "serving_prefill": 10_000, "serving_decode": 0,
        "serving_queued": 10_000, "stall": 20_000, "idle": 10_000,
        "unattributed": 0}
    assert ledger["utilization"] == round(110_000 / 150_000, 6)


def test_live_twin_and_derived_signals_match():
    """``ledger_from_events`` on ring dicts, and the hand ledgers of
    ``test_dominant_phase_and_ledger_signals``."""
    events = [
        {"seq": 0, "ts_us": 1_000, "type": "step_begin", "step": 1},
        {"seq": 1, "ts_us": 5_000, "type": "wire_span", "plane": 0,
         "dur_us": 2_000, "tx_bytes": 1, "rx_bytes": 1},
        {"seq": 2, "ts_us": 9_000, "type": "step_end", "step": 1,
         "dur_us": 8_000},
    ]
    got = tfleet.ledger_from_events(events, rank=3)
    assert got == jfleet.ledger_from_events(events, rank=3)
    assert (got["window_us"], got["buckets"]["compute"]) == (8_000, 6_000)
    assert tfleet.ledger_from_events([], rank=2) == \
        jfleet.ledger_from_events([], rank=2)
    for buckets in ({"stall": 30_000, "compute": 20_000, "idle": 50_000},
                    {}, {"serving_queued": 7, "idle": 3}):
        window = 100_000 if buckets else 0
        ledger = {"window_us": window,
                  "buckets": {n: buckets.get(n, 0) for n in tfleet.BUCKETS}}
        assert tfleet.dominant_phase(ledger) == jfleet.dominant_phase(ledger)
        assert tfleet.ledger_signals(ledger) == jfleet.ledger_signals(ledger)


def test_no_dumps_raises_as_the_jax_package(tmp_path):
    with pytest.raises(ValueError) as port:
        tfleet.analyze(str(tmp_path))
    with pytest.raises(ValueError) as ref:
        jfleet.analyze(str(tmp_path))
    assert str(port.value) == str(ref.value)


# ---- the JAX simworld harness's fleets ---------------------------------


@pytest.mark.parametrize("ranks,slow", [(64, 21), (256, 85)])
def test_simworld_fleets_match_the_jax_ledger(tmp_path, ranks, slow):
    harness.write_sim_step_dumps(
        str(tmp_path), ranks=ranks, steps=4, slow_rank=slow, waits=True,
        serving=True,
        breach={"objective": 4, "rank": slow, "value": 750, "phase": 6,
                "objective_name": "stall_ms", "phase_name": "stall"})
    t0 = time.perf_counter()
    got = _same_analysis(str(tmp_path))
    assert time.perf_counter() - t0 < 10.0
    assert got["ranks"] == list(range(ranks))
    assert all(l["buckets"]["unattributed"] == 0
               for l in got["per_rank"].values())
    assert got["fleet"]["worst_rank"] == slow
    (breach,) = got["slo"]["breach_events"]
    assert (breach["breach_rank"], breach["phase"]) == (slow, "stall")


def test_report_fleet_matches_the_jax_cli(tmp_path, capsys):
    harness.write_sim_step_dumps(str(tmp_path / "dumps"), ranks=4, steps=2,
                                 slow_rank=2, waits=True)
    outs = []
    for side, main in (("ref", jreport.main), ("port", treport.main)):
        rc = main(["--fleet", "--slo", "stall_ms < 500",
                   str(tmp_path / "dumps"), "-o",
                   str(tmp_path / f"{side}.json")])
        outs.append((rc, capsys.readouterr().out.replace(
            f"{side}.json", "OUT")))
    assert outs[0] == outs[1] and outs[0][0] == 0
    with open(tmp_path / "ref.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(g) == json.load(f)


# ---- the SLO engine ----------------------------------------------------


@pytest.mark.parametrize("spec", [
    "serving_p99 < 250", "stall_ms <= 500", "stall_ms<500",
    "stall_ms < 500 ms", "overlap_efficiency > high", ""])
def test_slo_grammar_rejects_as_the_jax_engine(spec):
    with pytest.raises(ValueError) as port:
        tslo.parse(spec)
    with pytest.raises(ValueError) as ref:
        jslo.parse(spec)
    assert str(port.value) == str(ref.value)


def test_slo_tables_and_parse_all_match():
    assert tslo.OBJECTIVES == jslo.OBJECTIVES
    assert tfleet.BUCKETS == jfleet.BUCKETS
    assert tfleet._CLAIM_ORDER == jfleet._CLAIM_ORDER
    assert tslo.DEFAULT_OBJECTIVES == jslo.DEFAULT_OBJECTIVES
    assert tslo._DRIFT_WARMUP == jslo._DRIFT_WARMUP
    for specs in ("stall_ms < 500; serving_p99_ms < 2000",
                  "overlap_efficiency > 0.4\nstep_time_ewma_ms drift> 1.5",
                  list(jslo.DEFAULT_OBJECTIVES), ";;"):
        assert [vars(o) for o in tslo.parse_all(specs)] == \
            [vars(o) for o in jslo.parse_all(specs)]


class _Recorder:
    def __init__(self):
        self.calls = []

    def record_slo(self, objective, rank, value, bucket=-1):
        self.calls.append((objective, rank, value, bucket))


OBJECTIVE_SETS = {
    "defaults": ("serving_p99_ms < 2000", "step_time_ewma_ms drift> 2.0",
                 "stall_ms < 500"),
    "every_signal": ("serving_p99_ms < 120", "step_time_ewma_ms drift> 1.3",
                     "overlap_efficiency > 0.5", "queued_idle_share < 0.2",
                     "stall_ms < 40"),
    "drift_only": ("step_time_ewma_ms drift> 1.1",
                   "serving_p99_ms drift> 1.2"),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("objectives", sorted(OBJECTIVE_SETS))
def test_slo_engine_matches_the_jax_engine(objectives, seed):
    """Seeded per-rank observation streams (signals missing at random,
    regressions that come and go): the same breaches, the same drift
    baselines after every observation, the same encoded events."""
    rng = np.random.default_rng(seed)
    specs = OBJECTIVE_SETS[objectives]
    port, ref = tslo.SloEngine(specs), jslo.SloEngine(specs)
    scale = {"serving_p99_ms": 100.0, "step_time_ewma_ms": 300.0,
             "overlap_efficiency": 0.6, "queued_idle_share": 0.15,
             "stall_ms": 30.0}
    rec_port, rec_ref = _Recorder(), _Recorder()
    for _ in range(60):
        per_rank, phases = {}, {}
        for rank in range(4):
            signals = {}
            for name, s in scale.items():
                if rng.random() < 0.8:
                    slow = 2.5 if rng.random() < 0.15 else 1.0
                    signals[name] = float(s * slow * rng.uniform(0.8, 1.2))
            per_rank[rank] = signals
            phases[rank] = str(rng.choice(list(tfleet.BUCKETS) + [""]))
        got = port.evaluate(per_rank, phases)
        want = ref.evaluate(per_rank, phases)
        assert [vars(b) for b in got] == [vars(b) for b in want]
        assert port._baselines == ref._baselines
        tslo.SloEngine.record(port, rec_port, got)
        jslo.SloEngine.record(ref, rec_ref, want)
    assert rec_port.calls == rec_ref.calls
    assert len(port.breaches) == len(ref.breaches)


def test_slo_breach_event_matches_the_core_tables():
    """``slo_breach``'s arguments and decoded names as
    ``csrc/events.cc`` prints them."""
    src = (REPO / "csrc" / "events.cc").read_text()
    spec = re.search(r'\{"slo_breach", ([^}]*)\}', src).group(1)
    assert tuple(re.findall(r'"([^"]*)"', spec)) == \
        tevents.SPECS["slo_breach"]

    def table(name):
        body = re.search(name + r"[^=]*= \{([^}]*)\}", src).group(1)
        return tuple(re.findall(r'"([^"]*)"', body))

    assert table("kSloObjectiveNames") == tevents.SLO_OBJECTIVES
    assert table("kRankBucketNames") == tevents.RANK_BUCKETS
    ring = tevents.EventRing()
    ring.record("slo_breach", 4, 3, 1234, 6)
    ring.record("slo_breach", 2, 1, 250, -1)
    first, second = ring.peek()
    assert {k: v for k, v in first.items() if k not in ("seq", "ts_us")} \
        == {"type": "slo_breach", "objective": 4, "breach_rank": 3,
            "value": 1234, "phase": 6, "objective_name": "stall_ms",
            "phase_name": "stall"}
    assert (second["objective_name"], second["phase_name"]) == \
        ("overlap_efficiency", "unknown")


def test_record_slo_writes_the_ring_before_init():
    from horovod_tpu_torch.common import basics

    assert not basics.is_initialized()
    engine = tslo.SloEngine()
    engine.record(basics, [tslo.Breach("stall_ms", 3, 1234.4, "stall"),
                           tslo.Breach("queued_idle_share", 1, 0.25, "")])
    got = [e for e in basics.events(2) if e["type"] == "slo_breach"]
    assert [(e["objective_name"], e["breach_rank"], e["value"],
             e["phase_name"]) for e in got] == \
        [("stall_ms", 3, 1234, "stall"), ("queued_idle_share", 1, 250,
                                          "unknown")]


# ---- the live observatory ----------------------------------------------


def test_observatory_endpoints_match(monkeypatch):
    monkeypatch.setenv("HOROVOD_DEBUG_PORT", "9400")
    monkeypatch.setenv("HOROVOD_SIZE", "3")
    monkeypatch.setenv("HOROVOD_DEBUG_HOST", "0.0.0.0")
    assert tfleet.FleetObservatory().resolve_endpoints() == \
        jfleet.FleetObservatory().resolve_endpoints() == \
        {r: f"127.0.0.1:{9400 + r}" for r in range(3)}
    monkeypatch.setenv("HOROVOD_DEBUG_PORT", "0")
    assert tfleet.FleetObservatory().resolve_endpoints() == {}
    monkeypatch.setenv("HOROVOD_SLO", "stall_ms < 100")
    assert [vars(o) for o in tfleet.FleetObservatory().engine.objectives] \
        == [vars(o) for o in jfleet.FleetObservatory().engine.objectives]


def test_observatory_keeps_sick_ranks_as_rows():
    views = []
    for mod in (tfleet, jfleet):
        obs = mod.FleetObservatory(endpoints={0: "127.0.0.1:9",
                                              1: "127.0.0.1:9"},
                                   timeout=0.2)
        view = obs.fleet_json()
        assert obs.last_view is view and len(obs.history) == 1
        views.append({k: v for k, v in view.items() if k != "ts"})
    assert views[0] == views[1]
    assert views[0]["reachable"] == 0
    tfleet.reset_observatory()
    try:
        assert tfleet.maybe_observatory(None) is tfleet.maybe_observatory(None)
    finally:
        tfleet.reset_observatory()


# ---- a two-rank world of the port --------------------------------------

DELAY_MS = 300
STEPS = 4


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=20) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _await_file(path):
    deadline = time.monotonic() + 60
    while not os.path.exists(path):
        assert time.monotonic() < deadline, path
        time.sleep(0.02)


def _fleet_rank(rank, size, tmpdir):
    """Step-marked allreduces, a ``delay`` stall on rank 1, a served
    request on rank 0, the endpoints polled mid-run on rank 0, then each
    rank's own SLO check recorded in its ring and a live dump."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.telemetry import critpath, fleet, reqtrace, slo

    hvd.init(device="cpu")
    if rank == 1:
        basics.set_fault_inject_spec(f"1:{STEPS - 1}:delay:{DELAY_MS}")
    x = torch.full((1024,), float(rank + 1))
    out = {"rank": rank}
    base = int(os.environ["HOROVOD_DEBUG_PORT"])
    try:
        for step in range(STEPS):
            basics.step_mark(True)
            if rank == 0 and step == 1:
                for phase in ("queued", "prefill", "decode_active"):
                    reqtrace.record_request(phase, 7)
                    time.sleep(0.005)
                reqtrace.record_request("done", 7)
            hvd.allreduce(x, name=f"s.{step}", op=hvd.Sum)
            basics.step_mark(False)
            if step == STEPS - 2:
                # Between steps: rank 0 reads the live fleet.
                open(os.path.join(tmpdir, f"ready.{rank}"), "w").close()
                if rank == 0:
                    _await_file(os.path.join(tmpdir, "ready.1"))
                    out["health0"] = _get(base, "/healthz")
                    out["fleet"] = _get(base, "/fleet")
                    out["health1"] = _get(base, "/healthz")
                    out["missing"] = _get(base, "/nope")
                    open(os.path.join(tmpdir, "go"), "w").close()
                else:
                    _await_file(os.path.join(tmpdir, "go"))
        ledger = fleet.ledger_from_events(basics.events(), rank=rank)
        engine = slo.SloEngine(("stall_ms < 100",))
        breaches = engine.evaluate({rank: fleet.ledger_signals(ledger)},
                                   {rank: fleet.dominant_phase(ledger)})
        engine.record(basics, breaches)
        out.update(ledger=ledger, breaches=[vars(b) for b in breaches])
        critpath.write_event_dump(
            os.path.join(tmpdir, "dumps", f"blackbox-rank{rank}.jsonl"),
            rank, size, basics.events())
        hvd.barrier()
    finally:
        hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmpdir = tmp_path_factory.mktemp("fleet_world")
    results = run_ranks(functools.partial(_fleet_rank, tmpdir=str(tmpdir)),
                        2, env={"HOROVOD_DEBUG_PORT": str(free_port())})
    return str(tmpdir), results


def test_port_dumps_match_the_jax_ledger(world):
    tmpdir, results = world
    dumps = os.path.join(tmpdir, "dumps")
    ledgers = _same_ledgers(dumps)
    for rank, ledger in enumerate(ledgers):
        assert ledger["buckets"]["unattributed"] < 0.01 * ledger["window_us"]
        # The live ledger each rank took before its breach event: the
        # same evidence on the steady axis.
        live = results[rank]["ledger"]
        assert live["buckets"]["stall"] == ledger["buckets"]["stall"]
    assert ledgers[1]["buckets"]["stall"] >= DELAY_MS * 1000
    assert ledgers[0]["buckets"]["serving_prefill"] > 0
    assert ledgers[0]["buckets"]["serving_decode"] > 0
    analysis = _same_analysis(dumps)
    _same_analysis(dumps, objectives="stall_ms < 100")
    assert [(b["breach_rank"], b["phase"])
            for b in analysis["slo"]["breach_events"]] == [(1, "stall")]


def test_live_endpoints(world):
    _, results = world
    r0 = results[0]
    fields = set(read_fleet_signals())
    status, before = r0["health0"]
    assert status == 200 and fields <= set(before)
    assert {k: before[k] for k in fields} == {
        "slo_breaches": 0, "fleet_utilization": 0.0,
        "rank_seconds_unattributed_share": 0.0}
    assert {"overlap_efficiency", "exposed_wire_ms"} <= set(before)
    status, view = r0["fleet"]
    assert status == 200
    assert (view["size"], view["reachable"]) == (2, 2)
    for r in ("0", "1"):
        ledger = view["ranks"][r]["ledger"]
        assert sum(ledger["buckets"].values()) == ledger["window_us"] > 0
        assert view["ranks"][r]["healthz"]["rank"] == int(r)
    assert view["fleet"]["utilization"] > 0
    status, after = r0["health1"]
    assert after["fleet_utilization"] == view["fleet"]["utilization"]
    assert after["slo_breaches"] == view["slo"]["breaches_total"]
    status, missing = r0["missing"]
    assert status == 404 and "/fleet" in missing["endpoints"]


def test_recorded_breach_folds_once(world, tmp_path):
    tmpdir, _ = world
    dumps = os.path.join(tmpdir, "dumps")
    want = jpm.merge_post_mortem(dumps)["slo_breaches"]
    got = tpm.merge_post_mortem(dumps)["slo_breaches"]
    assert got == want
    assert [(b["breach_rank"], b["objective"]) for b in got] == \
        [(1, "stall_ms")]
    # A rank re-dumps its ring at every fault: the same (rank, seq)
    # reaches the merge twice and still folds once.
    twice = tmp_path / "twice"
    shutil.copytree(dumps, twice)
    path = twice / "blackbox-rank1.jsonl"
    path.write_text(path.read_text() * 2)
    assert tpm.merge_post_mortem(str(twice))["slo_breaches"] == got
    assert tpm.merge_post_mortem_streaming(str(twice))["slo_breaches"] \
        == jpm.merge_post_mortem_streaming(str(twice))["slo_breaches"]
    cli = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.telemetry.report",
         "--fleet", "--slo", "stall_ms < 100", str(twice)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert cli.returncode == 0, cli.stderr[-2000:]
    assert "slo: 1 recorded breach event(s)" in cli.stdout, cli.stdout
    value = got[0]["value"]
    assert cli.stdout.splitlines().count(
        f"  breach [stall_ms] rank 1 value={value} phase=stall") >= 1
