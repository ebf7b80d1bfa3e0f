"""Two-rank metrics smoke of the port's telemetry.

    python -m horovod_tpu_torch.telemetry.smoke

The port's copy of ``horovod_tpu/telemetry/smoke.py``: two ranks on
gloo (CPU tensors) drive a few steps of named allreduces and check each
rank's snapshot (exact byte accounting, the response cache's hits in
the steady state, live cycle and latency counters); each rank records a
timeline, and the parent merges the two through ``telemetry.report``
into one trace with a straggler table covering both ranks. Where it
differs from the reference's: the ranks run the port's lane
(``hvd.init(device="cpu")``), whose collectives are gloo's and appear in
the timeline as ``GLOO_ALLREDUCE``; the merge must find them.

:func:`run_workers` starts the ranks of this smoke and of
``perf_smoke.py``, ``obs_smoke.py``, ``fleet_smoke.py`` and
``torch/{zero,elastic,fusion}_smoke.py``, as ``torch/reshard_smoke.py``
starts its ranks; a test runs :func:`worker` on its own ranks and hands
their results to :func:`check`. :func:`pick_device` and
:func:`open_lane` give the last four their ``--cpu`` rule: gloo on the
CPU with it, else NCCL with a card a rank when enough cards are visible.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

STEPS = 6
TENSORS = 4
ELEMS = 1024  # float32
RESULT = "SMOKE_RESULT "
DEVICE_ENV = "HVD_TORCH_SMOKE_DEVICE"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(rank, size, tmpdir):
    """One rank: the steps, the snapshot's checks, a scrape; returns
    what the parent checks."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry

    hvd.init(device="cpu")
    assert (hvd.rank(), hvd.size()) == (rank, size)
    snap0 = telemetry.snapshot()
    hvd.start_timeline(os.path.join(tmpdir, f"tl.{rank}.json"))
    try:
        for step in range(STEPS):
            handles = [hvd.allreduce_async(
                torch.full((ELEMS,), float(rank + step)),
                name=f"grad.{i}", op=hvd.Sum) for i in range(TENSORS)]
            for i, h in enumerate(handles):
                out = h.synchronize()
                expect = sum(r + step for r in range(size))
                assert out[0] == expect, (i, float(out[0]), expect)
        hvd.barrier()
        snap = telemetry.snapshot()
        ar = snap["ops"]["allreduce"]
        ar0 = snap0["ops"].get("allreduce", {"tensors": 0, "bytes": 0})
        want_bytes = STEPS * TENSORS * ELEMS * 4
        # Exact byte accounting: every allreduce this rank executed.
        assert ar["tensors"] - ar0["tensors"] == STEPS * TENSORS, ar
        assert ar["bytes"] - ar0["bytes"] == want_bytes, (ar, want_bytes)
        assert snap["cycle"]["count"] > 0
        assert snap["queue_us"]["count"] >= STEPS * TENSORS
        assert snap["wire_us"]["count"] > 0
        # No codec: the wire bytes are the full-width bytes, and the ring
        # moved at least 2(N-1)/N of the payload.
        wire = snap["wire"]
        assert wire["tx_bytes"] == wire["tx_logical_bytes"], wire
        assert wire["tx_bytes"] >= 2 * (size - 1) * want_bytes // size, (
            wire, want_bytes)
        # The steady state rides the response cache.
        assert snap["cache"]["hits"] > 0, snap["cache"]
        assert snap["cache"]["hit_rate"] > 0
        scraper = telemetry.MetricsScraper(
            interval_s=3600,
            jsonl_path=os.path.join(tmpdir, f"metrics.{rank}.jsonl"),
            prom_path=os.path.join(tmpdir, f"metrics.{rank}.prom"))
        scraper.scrape_once()
    finally:
        hvd.stop_timeline()
        hvd.shutdown()
    return {"rank": rank, "bytes": ar["bytes"] - ar0["bytes"],
            "cache_hits": snap["cache"]["hits"]}


def check(tmpdir, results, size=2):
    """The parent's checks over the ranks' files; returns a summary."""
    from horovod_tpu_torch.telemetry import report

    assert [r["rank"] for r in results] == list(range(size)), results
    paths = [os.path.join(tmpdir, f"tl.{r}.json") for r in range(size)]
    merged, skew = report.merge(paths)
    assert merged, "empty merged trace"
    assert set(skew["per_rank"]) == set(range(size)), skew
    assert skew["matched_events"] > 0, skew
    assert {e["pid"] for e in merged if e.get("name") == "GLOO_ALLREDUCE"} \
        == set(range(size)), "no rank's gloo allreduces in the merge"
    for r in range(size):
        with open(os.path.join(tmpdir, f"metrics.{r}.jsonl")) as f:
            row = json.loads(f.read().splitlines()[-1])
        assert row["ops"]["allreduce"]["tensors"] > 0, row
        assert "serving" in row and "overlap" in row["wire"], row.keys()
        with open(os.path.join(tmpdir, f"metrics.{r}.prom")) as f:
            assert "hvdtpu_overlap_steps_total" in f.read()
    return {"matched_events": skew["matched_events"],
            "merged_events": len(merged)}


def run_workers(module, size, tmpdir, env=None, victims=(), timeout=180):
    """Run ``python -m <module> --worker`` as ranks ``0..size-1`` of one
    world (``tmpdir`` in ``HVD_TORCH_SMOKE_TMP``, ``env`` over the
    layout, a device in its ``DEVICE_ENV``); return the ranks' results,
    None for a rank in ``victims``, which must die by SIGKILL. Prints
    every rank's output."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for rank in range(size):
        penv = dict(os.environ, HOROVOD_RANK=str(rank),
                    HOROVOD_SIZE=str(size), HOROVOD_LOCAL_RANK=str(rank),
                    HOROVOD_LOCAL_SIZE=str(size),
                    HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                    HOROVOD_CONTROLLER_PORT=str(port),
                    HVD_TORCH_SMOKE_TMP=tmpdir, **(env or {}),
                    PYTHONPATH=repo + os.pathsep + os.environ.get(
                        "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, "--worker"], env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo))
    results, failed = [], []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\nTIMEOUT"
        print(out.strip(), flush=True)
        lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
        if rank in victims:
            ok = p.returncode == -9
            results.append(None)
        else:
            ok = p.returncode == 0 and bool(lines)
            results.append(json.loads(lines[-1][len(RESULT):])
                           if lines else None)
        if not ok:
            failed.append((rank, p.returncode))
    if failed:
        raise RuntimeError(f"{module}: ranks failed (rank, rc): {failed}")
    return results


def worker_main(worker_fn):
    """A ``--worker`` process: ``worker_fn`` on this rank (with
    ``device=`` when :func:`run_workers` was given one in
    ``DEVICE_ENV``), its result printed for :func:`run_workers`."""
    kwargs = ({"device": os.environ[DEVICE_ENV]}
              if os.environ.get(DEVICE_ENV) else {})
    out = worker_fn(int(os.environ["HOROVOD_RANK"]),
                    int(os.environ["HOROVOD_SIZE"]),
                    os.environ["HVD_TORCH_SMOKE_TMP"], **kwargs)
    print(RESULT + json.dumps(out), flush=True)
    return 0


def pick_device(argv, prog, size):
    """``"cpu"`` under ``--cpu``; ``"cuda"`` when ``size`` cards are
    visible (NCCL refuses two ranks on one card); else None, with the
    reason on stderr."""
    import torch

    if "--cpu" in argv:
        return "cpu"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards >= size:
        return "cuda"
    print(f"{prog}: {cards} CUDA device(s) visible, {size} needed (use "
          "--cpu for gloo)", file=sys.stderr)
    return None


def open_lane(hvd, device):
    """``hvd.init`` on ``device`` (``"cpu"``: a gloo lane; ``"cuda"``:
    this rank's card); returns the torch device its tensors live on."""
    import torch

    from horovod_tpu_torch.common import basics

    if device == "cpu":
        hvd.init(device="cpu")
        return torch.device("cpu")
    hvd.init()
    return basics.device()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker_main(worker)
    with tempfile.TemporaryDirectory() as tmpdir:
        results = run_workers("horovod_tpu_torch.telemetry.smoke", 2, tmpdir)
        summary = check(tmpdir, results)
    print(f"metrics smoke: OK (2 gloo ranks, {summary['matched_events']} "
          f"matched negotiate events, merged trace "
          f"{summary['merged_events']} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
