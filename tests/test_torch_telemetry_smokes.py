"""The port's three telemetry smokes, two gloo ranks each, started from
``tests/test_torch_mp.py``'s fork server (``python -m
horovod_tpu_torch.telemetry.<smoke>`` runs the same workers and checks
as separate processes):

- ``smoke``: exact byte accounting, the cache's steady-state hits, a
  scrape, and the merge of the two ranks' real timelines;
- ``perf_smoke``: a ``delay:<ms>`` straggler on one step; the overlap
  ledger reconciles with ``wire_us`` and the critical path blames the
  delayed rank on that step alone;
- ``obs_smoke``: ``/healthz`` on both ranks mid-run, then rank 1 killed;
  the survivor's black box names it in the post-mortem.
"""

import functools
import queue
import signal
import time

from horovod_tpu_torch.telemetry import obs_smoke, perf_smoke, smoke
from tests.test_torch_mp import (
    context,
    free_port,
    parent_state,
    rank_entry,
    run_ranks,
)


def test_metrics_smoke(tmp_path):
    results = run_ranks(functools.partial(smoke.worker,
                                          tmpdir=str(tmp_path)), 2)
    summary = smoke.check(str(tmp_path), results)
    assert summary["matched_events"] > 0
    assert all(r["cache_hits"] > 0 for r in results)


def test_perf_smoke(tmp_path):
    results = run_ranks(functools.partial(perf_smoke.worker,
                                          tmpdir=str(tmp_path)), 2)
    assert all(r["drift"] < 0.01 for r in results)
    assert perf_smoke.check(str(tmp_path), results) >= 1


def _run_with_victim(fn, size, victim, env, timeout=90):
    """``fn`` on ``size`` forked ranks, ``victim`` expected to die by
    SIGKILL; the survivors' results by rank (None for the victim)."""
    ctx = context()
    port = free_port()
    q = ctx.Queue()
    parent = parent_state()
    procs = [ctx.Process(target=rank_entry,
                         args=(fn, r, size, port, q, env, parent))
             for r in range(size)]
    for p in procs:
        p.start()
    results, errors = [None] * size, {}
    deadline = time.monotonic() + timeout
    try:
        for _ in range(size - 1):
            rank, err, res = q.get(timeout=max(deadline - time.monotonic(),
                                               1))
            if err is not None:
                errors[rank] = err
            results[rank] = res
    except queue.Empty:
        errors["timeout"] = f"survivors hung: {results}"
    finally:
        for p in procs:
            p.join(timeout=15)
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, errors
    assert procs[victim].exitcode == -signal.SIGKILL, procs[victim].exitcode
    return results


def test_obs_smoke(tmp_path):
    env = {"HOROVOD_DEBUG_PORT": str(free_port()),
           "HOROVOD_BLACKBOX_DIR": str(tmp_path / "blackbox")}
    results = _run_with_victim(
        functools.partial(obs_smoke.worker, tmpdir=str(tmp_path)), 2, 1,
        env)
    assert [h["rank"] for h in results[0]["health"]] == [0, 1]
    analysis = obs_smoke.check(str(tmp_path), results)
    assert analysis["root_cause_ranks"] == [1]
