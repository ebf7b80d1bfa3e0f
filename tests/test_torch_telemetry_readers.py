"""The port's offline telemetry readers against the JAX package's.

The synthetic timelines, event dumps, black-box files, request dumps and
bench/scraper rows that ``tests/single/test_{telemetry,critpath,events,
postmortem_stream,reqtrace,perfwatch}.py`` build (their builders, called
here) go through ``horovod_tpu.telemetry``'s readers and through
``horovod_tpu_torch.telemetry``'s: the results must be equal (dicts
equal, the CLIs' exit codes and files equal, printed text equal but for
the package's name). Pure Python on both sides, no lane.
"""

import json
import os

import pytest

from horovod_tpu.simworld import write_sim_dumps
from horovod_tpu.telemetry import critpath as jcrit
from horovod_tpu.telemetry import perfwatch as jpw
from horovod_tpu.telemetry import postmortem as jpm
from horovod_tpu.telemetry import report as jreport
from horovod_tpu.telemetry import reqtrace as jreq
from horovod_tpu_torch.telemetry import critpath as tcrit
from horovod_tpu_torch.telemetry import perfwatch as tpw
from horovod_tpu_torch.telemetry import postmortem as tpm
from horovod_tpu_torch.telemetry import report as treport
from horovod_tpu_torch.telemetry import reqtrace as treq
from tests.single import test_critpath as crit_cases
from tests.single import test_events as event_cases
from tests.single import test_perfwatch as pw_cases
from tests.single import test_reqtrace as req_cases
from tests.single import test_telemetry as tl_cases


def _same_text(ref, port):
    assert port.replace("horovod_tpu_torch", "horovod_tpu") == ref


def _cli(capsys, main, argv):
    """(exit code, stdout) of one CLI call."""
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both_cli(capsys, tmp_path, jmain, tmain, argv, out_name=None):
    """Both CLIs on the same input: equal codes, text and ``-o`` file."""
    outs = []
    for side, main in (("ref", jmain), ("port", tmain)):
        extra = ["-o", str(tmp_path / f"{side}.{out_name}")] \
            if out_name else []
        rc, text = _cli(capsys, main, argv + extra)
        outs.append((rc, text.replace(f"{side}.{out_name}", "OUT")))
    (rc_j, text_j), (rc_t, text_t) = outs
    assert rc_j == rc_t
    _same_text(text_j, text_t)
    if out_name:
        with open(tmp_path / f"ref.{out_name}") as f:
            want = json.load(f)
        with open(tmp_path / f"port.{out_name}") as f:
            assert json.load(f) == want
    return rc_t, text_t


# ---- report: timeline merge and straggler table -----------------------


@pytest.mark.parametrize("with_sync", [True, False])
def test_merge_and_straggler_table(tmp_path, with_sync):
    paths = tl_cases._write_traces(tmp_path, with_sync=with_sync)
    assert treport.merge(paths) == jreport.merge(paths)
    traces = [treport.load_timeline(p) for p in paths]
    assert traces == [jreport.load_timeline(p) for p in paths]
    offsets = treport.compute_offsets(traces)
    assert offsets == jreport.compute_offsets(traces)
    assert treport.straggler_table(traces, offsets, top_n=3) == \
        jreport.straggler_table(traces, offsets, top_n=3)


def test_truncated_timeline_loads(tmp_path):
    """A trace still being written (no closing bracket) reads line by
    line on both sides."""
    path = tl_cases._write_traces(tmp_path)[0]
    with open(path) as f:
        events = json.load(f)
    cut = tmp_path / "cut.json"
    cut.write_text("[\n" + ",\n".join(json.dumps(e) for e in events[:7])
                   + ",\n")
    assert treport.load_timeline(str(cut)) == \
        jreport.load_timeline(str(cut))


def test_fault_events_and_cli(tmp_path, capsys):
    paths = tl_cases._write_traces(tmp_path)
    snaps = []
    for rank in range(4):
        p = tmp_path / f"snap.{rank}.json"
        p.write_text(json.dumps({"rank": rank, "elastic": {
            "epoch": 1, "faults_detected": 3 if rank == 2 else 1,
            "faults_recovered": 1, "ranks_blacklisted": 1,
            "detect_us": {"count": 1, "p50_us": 2048}}}))
        snaps.append(str(p))
    skews = []
    for report in (jreport, treport):
        _, skew = report.merge(paths)
        skews.append(report.attach_fault_events(skew, snaps))
    assert skews[1] == skews[0]
    assert treport.format_skew_table(skews[1]) == \
        jreport.format_skew_table(skews[0])
    for side, report in (("ref", jreport), ("port", treport)):
        assert report.main([*paths, "-o", str(tmp_path / f"{side}.json"),
                            "--skew-json", str(tmp_path / f"{side}.s"),
                            "--snapshots", *snaps]) == 0
    text = capsys.readouterr().out
    assert text.count("faults") == 2
    for ext in ("json", "s"):
        assert json.loads((tmp_path / f"port.{ext}").read_text()) == \
            json.loads((tmp_path / f"ref.{ext}").read_text())


def test_events_fold_into_the_merged_trace(tmp_path):
    """``--events``: black-box dumps rendered as extra tracks on the
    trace's axis (``postmortem.events_to_trace_events``)."""
    paths = tl_cases._write_traces(tmp_path)
    dumps = crit_cases._two_rank_traces(tmp_path / "dumps")
    assert treport.merge(paths, events_paths=[dumps]) == \
        jreport.merge(paths, events_paths=[dumps])
    assert treport.merge(paths, align=False, events_paths=[dumps]) == \
        jreport.merge(paths, align=False, events_paths=[dumps])


# ---- critical path ------------------------------------------------------


@pytest.mark.parametrize("case", [
    ([], None, None), ([(0, 10), (5, 15)], None, None),
    ([(0, 10), (10, 20)], None, None), ([(0, 30), (5, 10)], None, None),
    ([(5, 5), (3, 1)], None, None), ([(0, 10), (20, 30)], 5, 25),
    ([(-5, 100)], 0, 50)])
def test_union_measure(case):
    iv, lo, hi = case
    assert tcrit.union_measure(iv, lo, hi) == \
        jcrit.union_measure(iv, lo, hi)
    assert tcrit.intersect_intervals(iv, [(2, 12), (25, 40)]) == \
        jcrit.intersect_intervals(iv, [(2, 12), (25, 40)])


def _ring_wrap(tmp_path):
    return crit_cases._write_dump(
        str(tmp_path / "blackbox-rank0.jsonl"), 0, [
            {"ts_us": crit_cases._at(50_000), "type": "wire_span",
             "plane": 0, "dur_us": 10_000, "tx_bytes": 1, "rx_bytes": 1},
            {"ts_us": crit_cases._at(100_000), "type": "step_end",
             "step": 7, "dur_us": 90_000}])


def _delay(tmp_path):
    at = crit_cases._at
    return crit_cases._write_dump(
        str(tmp_path / "blackbox-rank0.jsonl"), 0, [
            {"ts_us": at(0), "type": "step_begin", "step": 1},
            {"ts_us": at(5_000), "type": "inject", "action": 4,
             "op_index": 3},
            {"ts_us": at(50_000), "type": "wait", "dur_us": 20_000},
            {"ts_us": at(95_000), "type": "wire_span", "plane": 0,
             "dur_us": 10_000, "tx_bytes": 1, "rx_bytes": 1},
            {"ts_us": at(100_000), "type": "step_end", "step": 1,
             "dur_us": 100_000}])


@pytest.mark.parametrize("build", ["ring_wrap", "two_ranks", "delay"])
def test_critical_path(tmp_path, capsys, build):
    if build == "two_ranks":
        d = crit_cases._two_rank_traces(tmp_path / "dumps")
    else:
        path = {"ring_wrap": _ring_wrap, "delay": _delay}[build](
            tmp_path / "dumps")
        d = os.path.dirname(path)
    for path in tpm.collect_paths(d):
        dump = tpm.load_blackbox(path)[-1]
        assert dump == jpm.load_blackbox(path)[-1]
        assert tcrit.step_windows(dump) == jcrit.step_windows(dump)
        assert tcrit.phase_intervals(dump) == jcrit.phase_intervals(dump)
    analysis = tcrit.critical_path(d)
    assert analysis == jcrit.critical_path(d)
    assert tcrit.format_critical_path(analysis, max_steps=2) == \
        jcrit.format_critical_path(analysis, max_steps=2)
    _both_cli(capsys, tmp_path, jreport.main, treport.main,
              ["--critical-path", d], out_name="cp.json")


def test_write_event_dump(tmp_path):
    """A live rank's dump: the same header keys and event lines."""
    events = [{"seq": 0, "ts_us": 5, "type": "step_begin", "step": 1}]
    for side, mod in (("ref", jcrit), ("port", tcrit)):
        mod.write_event_dump(str(tmp_path / side / "d.jsonl"), 1, 2,
                             events, epoch=3)
    got, want = (tpm.load_blackbox(str(tmp_path / s / "d.jsonl"))[-1]
                 for s in ("port", "ref"))
    assert got["events"] == want["events"] == events
    for key in ("unix_us", "steady_us"):
        got["header"].pop(key), want["header"].pop(key)
    assert got["header"] == want["header"]


# ---- post-mortem --------------------------------------------------------


def _postmortem_dumps(tmp_path):
    """``tests/single/test_events.py``'s root-cause scenario: rank 3
    killed, ranks 0/1 certain of it, rank 2 suspecting rank 1."""
    tmp_path.mkdir()
    w = event_cases._write_dump
    launch = {"op_class": 0, "device": 0, "tensors": 1, "bytes": 64}
    w(tmp_path / "blackbox-rank0.jsonl", 0,
      {"kind": "peer", "certain": True, "ranks": [3]},
      [(1000, "response_launch", launch),
       (2000, "fault", {"kind": 0, "certain": 1, "epoch": 0,
                        "fault_rank": 3})])
    w(tmp_path / "blackbox-rank1.jsonl", 1,
      {"kind": "peer", "certain": True, "ranks": [3]},
      [(900, "negotiate_end", {"responses": 1, "shutdown": 0}),
       (2100, "fault", {"kind": 0, "certain": 1, "epoch": 0,
                        "fault_rank": 3})])
    w(tmp_path / "blackbox-rank2.jsonl", 2,
      {"kind": "peer", "certain": False, "ranks": [1]},
      [(1500, "negotiate_end", {"responses": 1, "shutdown": 0}),
       (2500, "wire_span", {"dur_us": 300, "tx_bytes": 0, "rx_bytes": 0,
                            "plane": 0, "channels": 1}),
       (2600, "slo_breach", {"objective": 4, "breach_rank": 2,
                             "value": 900, "phase": 1,
                             "objective_name": "stall_ms",
                             "phase_name": "stall"})])
    # A second fault of rank 0, appended: the merge reads the last.
    w(tmp_path / "blackbox-rank0.jsonl", 0,
      {"kind": "corruption", "certain": True, "ranks": [2]},
      [(3000, "fault", {"kind": 1, "certain": 1, "epoch": 1,
                        "fault_rank": 2})], epoch=1, append=True)
    return str(tmp_path)


@pytest.mark.parametrize("scenario", ["events", "sim8", "sim24"])
def test_post_mortem(tmp_path, capsys, scenario):
    if scenario == "events":
        d = _postmortem_dumps(tmp_path / "bb")
    else:
        d = str(tmp_path / "bb")
        n = 8 if scenario == "sim8" else 24
        write_sim_dumps(d, n, 5, events_per_rank=32)
    for index in (-1, 0):
        eager = tpm.merge_post_mortem(d, dump_index=index)
        assert eager == jpm.merge_post_mortem(d, dump_index=index)
        stream = tpm.merge_post_mortem_streaming(d, dump_index=index,
                                                 tail=16)
        assert stream == jpm.merge_post_mortem_streaming(
            d, dump_index=index, tail=16)
        assert tpm.format_post_mortem(stream, tail=6) == \
            jpm.format_post_mortem(stream, tail=6)
    assert tpm.format_post_mortem(eager) == jpm.format_post_mortem(eager)
    for path in tpm.collect_paths(d):
        for dump in tpm.load_blackbox(path):
            assert tpm.events_to_trace_events(dump, 1000) == \
                jpm.events_to_trace_events(dump, 1000)
    _both_cli(capsys, tmp_path, jreport.main, treport.main,
              ["--post-mortem", d], out_name="pm.json")
    _both_cli(capsys, tmp_path, jreport.main, treport.main,
              ["--post-mortem", "--stream", d])


# ---- requests -----------------------------------------------------------


def _request_dumps(tmp_path):
    """``tests/single/test_reqtrace.py``'s dumps: a rid across two
    ranks with skewed clocks, an orphan re-queued after a fault, an
    incomplete rid."""
    tmp_path.mkdir()
    w = req_cases._write_dump
    w(tmp_path / "blackbox-rank0.jsonl", 0, 10_000, [
        (0, "queued", 1, 8), (100, "prefill", 1, 8),
        (300, "kv_ship", 1, 4096), (1000, "done", 1, 5),
        (0, "queued", 2, 0), (10, "prefill", 2, 0), (20, "kv_ship", 2, 0),
        (520, "fault_requeue", 2, 0), (530, "prefill", 2, 0),
        (560, "decode_wait", 2, 0), (600, "done", 2, 0),
        (5, "queued", 3, 0), (50, "queued", 3, 0), (50, "prefill", 3, 0),
        (0, "queued", 9, 0), (10, "prefill", 9, 0)])
    w(tmp_path / "blackbox-rank1.jsonl", 1, 5_000_000, [
        (500, "decode_wait", 1, 2), (600, "decode_active", 1, 9)])
    return str(tmp_path)


def test_stitch_and_tail_report(tmp_path, capsys):
    d = _request_dumps(tmp_path / "dumps")
    chains = treq.stitch_requests(d)
    assert chains == jreq.stitch_requests(d)
    for c in chains.values():
        assert treq.chain_gaps(c) == jreq.chain_gaps(c) == []
    for pct in (50.0, 99.0):
        rep = treq.tail_report(chains, pct=pct)
        assert rep == jreq.tail_report(chains, pct=pct)
        assert treq.format_requests(rep) == jreq.format_requests(rep)
    _both_cli(capsys, tmp_path, jreport.main, treport.main,
              ["--requests", "--pct", "90", d], out_name="req.json")


@pytest.mark.parametrize("pct", [90.0, 50.0])
def test_tail_report_on_chains(pct):
    """The cohort decomposition on ``test_reqtrace.py``'s hand-built
    chains: nine fast decode-bound requests and one slow evicted one."""
    chains = {i: req_cases._chain(i, {"queued": 10, "prefill": 20,
                                      "decode_active": 100 + i})
              for i in range(9)}
    chains[9] = req_cases._chain(9, {"queued": 10, "prefill": 20,
                                     "evicted_requeue": 900,
                                     "decode_active": 120})
    chains[10] = req_cases._chain(10, {"queued": 5}, complete=False)
    rep = treq.tail_report(chains, pct=pct)
    assert rep == jreq.tail_report(chains, pct=pct)
    assert treq.format_requests(rep, max_rows=3) == \
        jreq.format_requests(rep, max_rows=3)
    empty = treq.tail_report({10: chains[10]})
    assert empty == jreq.tail_report({10: chains[10]})
    assert treq.format_requests(empty) == jreq.format_requests(empty)


# ---- perfwatch ----------------------------------------------------------


def _series():
    noisy = pw_cases._noisy
    return [noisy(0.1, 12, 0.03, 3) + noisy(0.2, 8, 0.03, 4),
            noisy(0.1, 40, 0.05, 11),
            noisy(0.1, 10, 0.02, 5) + [0.3] + noisy(0.1, 10, 0.02, 6),
            [1.0] * 6 + [3.0] + [1.0] * 6 + [1.4] * 3, [1.0, 2.0], []]


@pytest.mark.parametrize("direction", ["up", "down"])
def test_detect_and_changepoint(direction):
    for s in _series():
        assert tpw.detect(s, direction=direction) == \
            jpw.detect(s, direction=direction)
        assert tpw.detect(s, direction, rel_threshold=0.1, alpha=0.5,
                          consecutive=1, warmup=1) == \
            jpw.detect(s, direction, rel_threshold=0.1, alpha=0.5,
                       consecutive=1, warmup=1)
        assert tpw.changepoint(s) == jpw.changepoint(s)


def _bench_rows():
    rows = []
    for r in range(6):
        rows.append({"metric": "ring_busbw", "config": "overlap",
                     "ranks": 2, "schema": 1, "points": [
                         {"payload_bytes": 1 << 24, "step_s": 0.05,
                          "busbw_gbps": 0.66 if r < 4 else 0.22},
                         {"payload_bytes": 1 << 20, "busbw_gbps": 0.30,
                          "step_s": 0.007}]})
        rows.append({"metric": "llama_train_step_mfu", "schema": 1,
                     "value": 0.69, "vs_baseline": 1.7})
        rows.append({"metric": "serving_latency", "schema": 1,
                     "arrival_rps": 50.0, "p99_ms": 20.0 + 10 * (r > 3),
                     "tok_s": 150.0})
    return rows


def _scrape_rows():
    rows = []
    for i in range(6):
        rows.append({"ts": 10.0 * i, "wire": {
            "tx_bytes": int(5e9) * i * (1 if i < 4 else 0.5),
            "overlap": {"steps": 100 * i,
                        "intra": {"hidden_us": 600_000 * i,
                                  "total_us": 1_000_000 * i},
                        "cross": {"hidden_us": 0, "total_us": 0}}}})
    return rows


def test_series_and_watch():
    rows = _bench_rows()
    assert tpw.flatten_rows(rows) == jpw.flatten_rows(rows)
    assert tpw.check_schema(rows) == jpw.check_schema(rows)
    for series in (tpw.bench_series(rows), tpw.scraper_series(
            _scrape_rows())):
        assert series in (jpw.bench_series(rows),
                          jpw.scraper_series(_scrape_rows()))
        assert tpw.watch(series, min_points=3) == \
            jpw.watch(series, min_points=3)
    for metric, field in (("llama_update_sweep", "value"),
                          ("x_mfu", "value"), ("m", "p99_ms"),
                          ("m", "renamed")):
        assert tpw.field_direction(metric, field) == \
            jpw.field_direction(metric, field)
    mixed = [{"metric": "a", "schema": 1}, {"metric": "a"}]
    for pw in (tpw, jpw):
        with pytest.raises(SystemExit, match="MIXED"):
            pw.check_schema(mixed)


@pytest.mark.parametrize("kind", ["regression", "quiet", "renamed",
                                  "json", "scrape", "tail"])
def test_perfwatch_cli(tmp_path, capsys, kind):
    if kind == "regression":
        argv = ["--bench", pw_cases._write_rows(
            tmp_path / "r.jsonl", [0.1] * 10 + [0.2] * 5), "--budget"]
    elif kind == "quiet":
        argv = ["--bench", pw_cases._write_rows(
            tmp_path / "q.jsonl", pw_cases._noisy(0.1, 20, 0.05, 9)),
            "--budget"]
    elif kind == "renamed":
        p = tmp_path / "renamed.jsonl"
        p.write_text(json.dumps({"metric": "eager", "renamed": 0.1,
                                 "schema": 1}) + "\n")
        argv = ["--bench", str(p), "--budget"]
    elif kind == "json":
        argv = ["--bench", pw_cases._write_rows(
            tmp_path / "j.jsonl", [1.0] * 8 + [2.5] * 4), "--json"]
    elif kind == "scrape":
        p = tmp_path / "scrape.jsonl"
        p.write_text("".join(json.dumps(r) + "\n" for r in _scrape_rows()))
        argv = ["--jsonl", str(p), "--budget", "--threshold", "0.2"]
    else:
        # A driver artifact whose "tail" embeds rows between log lines.
        p = tmp_path / "artifact.json"
        p.write_text(json.dumps({"tail": "log line\n" + "\n".join(
            json.dumps(r) for r in _bench_rows()) + "\nmore log"}))
        argv = ["--bench", str(p), "--consecutive", "1"]
    assert tpw.load_rows(argv[1]) == jpw.load_rows(argv[1])
    rc_j, text_j = _cli(capsys, jpw.main, argv)
    rc_t, text_t = _cli(capsys, tpw.main, argv)
    assert rc_t == rc_j
    _same_text(text_j, text_t)
    assert rc_t == {"regression": 1, "quiet": 0, "renamed": 2, "json": 0,
                    "scrape": 1, "tail": 0}[kind]
