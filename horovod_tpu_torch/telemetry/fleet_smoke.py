"""Two-rank fleet-observatory smoke of the port.

    python -m horovod_tpu_torch.telemetry.fleet_smoke [--cpu]

The port's copy of ``horovod_tpu/telemetry/fleet_smoke.py``: two ranks
(gloo with ``--cpu``, else NCCL with a card a rank, which needs two
cards) run step-marked train loops with the debug server up on both,
and ``HOROVOD_FAULT_INJECT``'s ``delay:<ms>`` stalls rank 1's lane for
``STALL_MS`` at the top of one step's collective. It checks:

1. live fleet aggregation mid-run: rank 0's ``/fleet`` answers while
   both ranks are training, with a ledger a rank that reconciles;
2. exact reconciliation: every rank's rank-seconds buckets sum to its
   window to the microsecond, with ``unattributed`` under 1%;
3. SLO attribution: each rank judges ``stall_ms < 500`` over its own
   ledger, the delayed rank breaches with phase ``stall`` and records a
   ``slo_breach`` event naming itself, every recorded breach names the
   rank whose own ledger breached, and ``report --fleet`` over the
   ranks' dumps shows the breach again, folded once (so does the
   post-mortem's fold).

Where it differs from the reference's: the reference SIGSTOPs rank 1
(``stop:<ms>``) and heals through its socket wire's retry ladder, which
the port does not have (ROADMAP.md L8). The port's ``delay`` sleeps
rank 1's lane thread after negotiation, at the top of the collective,
so the stall's evidence is the injection's gap on rank 1's own ring
(``critpath.phase_intervals``); rank 0, inside the same collective,
books the wait as exposed wire. The coordinator's stall check
(``HOROVOD_STALL_CHECK_TIME``) cannot run then: its lane thread is in
that collective too.
"""

import json
import os
import sys
import tempfile
import time
import urllib.request

STALL_MS = 1200
WARMUP_STEPS = 3
SMOKE_SLO = ("stall_ms < 500",)
ELEMS = 2048


def _get_json(url, timeout=20):
    return json.loads(urllib.request.urlopen(url, timeout=timeout).read())


def _await_file(path, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"{what} never came"
        time.sleep(0.02)


def _reconciles(ledger):
    assert sum(ledger["buckets"].values()) == ledger["window_us"], ledger
    assert ledger["buckets"]["unattributed"] < 0.01 * ledger["window_us"], \
        ledger["buckets"]


def worker(rank, size, tmpdir, device="cpu"):
    """One rank: the warm-up steps, ``/fleet`` on rank 0, the stalled
    step, then this rank's ledger and SLO check over its own ring and a
    live dump; returns what the parent checks."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.telemetry import critpath, fleet, slo, smoke

    dev = smoke.open_lane(hvd, device)
    if rank == 1:
        # The op after the warm-up steps' (one op a step).
        basics.set_fault_inject_spec(f"1:{WARMUP_STEPS}:delay:{STALL_MS}")
    x = torch.full((ELEMS,), float(rank + 1), device=dev)

    def step(name):
        basics.step_mark(True)
        out = hvd.allreduce(x, name=name, op=hvd.Sum)
        assert float(out[0]) == 3.0, float(out[0])
        basics.step_mark(False)

    view = None
    try:
        for i in range(WARMUP_STEPS):
            step(f"warm.{i}")
        # The handshake sits between step windows: the ledger books it
        # idle. Rank 0 polls the live fleet, both ranks' servers up.
        open(os.path.join(tmpdir, f"ready.{rank}"), "w").close()
        if rank == 0:
            _await_file(os.path.join(tmpdir, "ready.1"), "rank 1's ready")
            base = int(os.environ["HOROVOD_DEBUG_PORT"])
            view = _get_json(f"http://127.0.0.1:{base}/fleet")
            assert (view["size"], view["reachable"]) == (size, size), view
            for r in range(size):
                _reconciles(view["ranks"][str(r)]["ledger"])
            assert view["fleet"]["window_us"] > 0, view
            open(os.path.join(tmpdir, "go"), "w").close()
        else:
            _await_file(os.path.join(tmpdir, "go"), "rank 0's go")
        step("stall")
        step("post")

        ledger = fleet.ledger_from_events(basics.events(), rank=rank)
        _reconciles(ledger)
        engine = slo.SloEngine(SMOKE_SLO)
        breaches = engine.evaluate({rank: fleet.ledger_signals(ledger)},
                                   {rank: fleet.dominant_phase(ledger)})
        if rank == 1:
            assert [(b.objective, b.phase) for b in breaches] == \
                [("stall_ms", "stall")], (breaches, ledger)
        engine.record(basics, breaches)
        critpath.write_event_dump(
            os.path.join(tmpdir, "dumps", f"blackbox-rank{rank}.jsonl"),
            rank, size, basics.events())
        hvd.barrier()
    finally:
        hvd.shutdown()
    return {"rank": rank, "window_us": ledger["window_us"],
            "buckets": ledger["buckets"],
            "breaches": [vars(b) for b in breaches],
            "fleet": None if view is None else view["fleet"]}


def check(tmpdir, results, size=2):
    """The parent's checks over the ranks' dumps; returns the analysis."""
    import contextlib
    import io

    from horovod_tpu_torch.telemetry import fleet, postmortem, report

    assert [r["rank"] for r in results] == list(range(size)), results
    assert results[0]["fleet"] is not None
    dump_dir = os.path.join(tmpdir, "dumps")
    analysis = fleet.analyze(dump_dir, objectives=SMOKE_SLO)
    for ledger in analysis["per_rank"].values():
        _reconciles(ledger)
    recorded = analysis["slo"]["breach_events"]
    # Each rank recorded its own ledger's breaches only.
    assert all(b["breach_rank"] == b["source_rank"] for b in recorded), \
        recorded
    for b in recorded:
        stall = analysis["per_rank"][b["breach_rank"]]["buckets"]["stall"]
        assert b["objective"] == "stall_ms" and stall > 500_000, (b, stall)
    ones = [b for b in recorded if b["breach_rank"] == 1]
    assert [(b["objective"], b["phase"]) for b in ones] == \
        [("stall_ms", "stall")], recorded
    # The post-mortem folds the same event once.
    folded = postmortem.merge_post_mortem(dump_dir)["slo_breaches"]
    assert [(b["breach_rank"], b["objective"]) for b in folded] == \
        [(b["breach_rank"], b["objective"]) for b in recorded], folded
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert report.main(["--fleet", "--slo", SMOKE_SLO[0], dump_dir]) == 0
    text = out.getvalue()
    print(text)
    assert f"slo: {len(recorded)} recorded breach event(s)" in text, text
    line = (f"  breach [stall_ms] rank 1 value={ones[0]['value']} "
            "phase=stall")
    assert line in text.splitlines(), text
    return analysis


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    device = smoke.pick_device(argv, "fleet_smoke", 2)
    if device is None:
        return 2
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmpdir:
        env = {"HOROVOD_DEBUG_PORT": str(smoke._free_port()),
               smoke.DEVICE_ENV: device}
        results = smoke.run_workers(
            "horovod_tpu_torch.telemetry.fleet_smoke", 2, tmpdir, env=env)
        analysis = check(tmpdir, results)
    print(f"fleet smoke: OK (2 ranks on {device}: /fleet live mid-run, "
          f"every ledger reconciled to the µs, rank 1's stall_ms breach "
          f"recorded and reported once; fleet utilization "
          f"{analysis['fleet']['utilization']:.1%}, "
          f"{time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
