"""Two-rank step-anatomy smoke of the port's telemetry.

    python -m horovod_tpu_torch.telemetry.perf_smoke

The port's copy of ``horovod_tpu/telemetry/perf_smoke.py``: two ranks
on gloo run allreduces under a :class:`StepTimer` (whose marks open and
close the lane's step windows) while ``HOROVOD_FAULT_INJECT``'s
``delay:<ms>`` makes rank 1 a straggler on one step. It checks:

1. the overlap ledger: a plane's exposed + hidden is its total exactly,
   and the ledger's totals (plus the span time it booked unattributed,
   the warm-up's) are the ``wire_us`` histogram's sum within 1%;
2. the critical path: over the ranks' live event dumps
   (``critpath.write_event_dump``; ``report --critical-path``), the
   delayed step is blamed on rank 1, phase ``stall``, and no other step
   is a stall.

Where it differs from the reference's: the lane is the port's
(``hvd.init(device="cpu")``), whose delay sleeps its lane thread at the
top of the chosen response, as the reference's background loop does;
the wire spans are the gloo calls' host times.
"""

import os
import sys
import tempfile
import time

DELAY_MS = 300
DELAY_AT_OP = 9  # the collective the delay fires at, on rank 1
STEPS = 8
OPS_PER_STEP = 2
WARMUP_OPS = 2
ELEMS = 1 << 18  # 1 MiB of f32 an op: wire spans of milliseconds


def worker(rank, size, tmpdir):
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.telemetry import critpath

    hvd.init(device="cpu")
    if rank == 1:
        basics.set_fault_inject_spec(f"1:{DELAY_AT_OP}:delay:{DELAY_MS}")
    x = torch.full((ELEMS,), float(rank + 1))
    for i in range(WARMUP_OPS):  # outside any window: unattributed
        hvd.allreduce(x, name=f"warm.{i}", op=hvd.Sum)

    snap0 = telemetry.snapshot()
    timer = telemetry.StepTimer()
    for s in range(STEPS):
        with timer.step():
            for i in range(OPS_PER_STEP):
                out = hvd.allreduce(x, name=f"step.{s}.{i}", op=hvd.Sum)
        assert float(out[0]) == 3.0, float(out[0])
    snap1 = telemetry.snapshot()

    ov0, ov1 = (s["wire"]["overlap"] for s in (snap0, snap1))
    for plane in ("intra", "cross"):
        p = ov1[plane]
        assert p["exposed_us"] + p["hidden_us"] == p["total_us"], ov1
    ledger_us = sum(ov1[p]["total_us"] - ov0[p]["total_us"]
                    for p in ("intra", "cross"))
    ledger_us += ov1["unattributed_us"] - ov0["unattributed_us"]
    wire_us = snap1["wire_us"]["sum_us"] - snap0["wire_us"]["sum_us"]
    drift = abs(ledger_us - wire_us) / max(wire_us, 1)
    assert drift < 0.01, (
        f"overlap ledger against wire_us drift {drift:.4f} (ledger "
        f"{ledger_us} us, wire_us {wire_us} us)")
    assert ov1["steps"] - ov0["steps"] == STEPS, (ov0, ov1)
    assert len(timer.overlap_per_step) == STEPS

    critpath.write_event_dump(
        os.path.join(tmpdir, "dumps", f"blackbox-rank{rank}.jsonl"),
        rank, size, telemetry.events())
    hvd.barrier()
    hvd.shutdown()
    return {"rank": rank, "drift": drift, "ledger_ms": ledger_us / 1000.0,
            "summary": timer.summary()}


def check(tmpdir, results, size=2):
    """The parent's checks over the dumps; returns the blamed step."""
    from horovod_tpu_torch.telemetry import critpath, postmortem, report

    assert [r["rank"] for r in results] == list(range(size)), results
    dump_dir = os.path.join(tmpdir, "dumps")
    analysis = critpath.critical_path(dump_dir)
    assert len(analysis["steps"]) == STEPS, analysis["steps"]
    dumps = {r: postmortem.load_blackbox(
        os.path.join(dump_dir, f"blackbox-rank{r}.jsonl"))[-1]
        for r in range(size)}
    inject = [e for e in dumps[1]["events"] if e.get("type") == "inject"]
    assert inject, "the delay never fired"
    wall = critpath._wall(inject[0], dumps[1]["header"])
    windows = critpath.step_windows(dumps[1])
    delayed = [sid for sid, (lo, hi) in windows.items() if lo <= wall <= hi]
    assert delayed, (wall, windows)
    hit = delayed[0]
    by_step = {s["step"]: s for s in analysis["steps"]}
    assert by_step[hit]["blocking_rank"] == 1, by_step[hit]
    assert by_step[hit]["phase"] == "stall", by_step[hit]
    healthy = [s for s in analysis["steps"] if s["step"] != hit]
    assert len(healthy) == STEPS - 1
    assert all(s["phase"] != "stall" for s in healthy), healthy
    assert all(by_step[hit]["wall_ms"] > s["wall_ms"] + DELAY_MS / 2
               for s in healthy), analysis["steps"]
    print(critpath.format_critical_path(analysis))
    assert report.main(["--critical-path", dump_dir]) == 0
    return hit


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmpdir:
        results = smoke.run_workers(
            "horovod_tpu_torch.telemetry.perf_smoke", 2, tmpdir)
        hit = check(tmpdir, results)
    print(f"perf smoke: OK (step {hit} blamed on rank 1 / stall; the "
          f"ledger within 1% of wire_us on both ranks; "
          f"{time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
