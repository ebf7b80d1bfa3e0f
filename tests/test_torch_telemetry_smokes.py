"""The port's telemetry smokes and the lane's smokes, two gloo ranks
each, started from ``tests/test_torch_mp.py``'s fork server (``python -m
horovod_tpu_torch.telemetry.<smoke>`` and ``python -m
horovod_tpu_torch.torch.<smoke> --cpu`` run the same workers and checks
as separate processes):

- ``smoke``: exact byte accounting, the cache's steady-state hits, a
  scrape, and the merge of the two ranks' real timelines;
- ``perf_smoke``: a ``delay:<ms>`` straggler on one step; the overlap
  ledger reconciles with ``wire_us`` and the critical path blames the
  delayed rank on that step alone;
- ``obs_smoke``: ``/healthz`` on both ranks mid-run, then rank 1 killed;
  the survivor's black box names it in the post-mortem;
- ``fleet_smoke``: ``/fleet`` on rank 0 mid-run, every rank-seconds
  ledger reconciled to the microsecond, rank 1's ``delay`` stall breaching
  ``stall_ms < 500`` and reported once by ``report --fleet``;
- ``torch.zero_smoke``: ZeRO-1 against the replicated Adam, 1/N state,
  reduce-scatter and allgather bytes against the layout's;
- ``torch.elastic_smoke``: rank 1 killed mid-training, rank 0 re-formed
  in place onto the reference trajectory;
- ``torch.fusion_smoke``: the overlap ledger's invariant with hidden wire
  under the fused schedule, and the fused and unfused steps' same bits.

Then what the elastic smoke found on two cards, held on the CPU with
fakes: a failed lane aborts its NCCL communicators once, and a commit on
the card raises the failed lane's error before it overwrites the last
commit.
"""

import functools
import queue
import signal
import time

import pytest

from horovod_tpu_torch.telemetry import (
    fleet_smoke,
    obs_smoke,
    perf_smoke,
    smoke,
)
from horovod_tpu_torch.torch import elastic_smoke, fusion_smoke, zero_smoke
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


def test_fleet_smoke(tmp_path):
    env = {"HOROVOD_DEBUG_PORT": str(free_port())}
    results = run_ranks(functools.partial(fleet_smoke.worker,
                                          tmpdir=str(tmp_path)), 2, env=env)
    assert results[0]["fleet"]["window_us"] > 0
    assert [b["phase"] for b in results[1]["breaches"]] == ["stall"]
    analysis = fleet_smoke.check(str(tmp_path), results)
    assert 1 in {b["breach_rank"] for b in analysis["slo"]["breach_events"]}


def test_zero_smoke(tmp_path):
    results = run_ranks(functools.partial(zero_smoke.worker,
                                          tmpdir=str(tmp_path)), 2)
    r = zero_smoke.check(results)
    assert r["moved"] == r["predicted"]
    assert r["opt_bytes"] < r["replicated"] / 2 * 1.10


def test_elastic_smoke(tmp_path):
    results = _run_with_victim(
        functools.partial(elastic_smoke.worker, tmpdir=str(tmp_path)), 2, 1,
        {})
    assert results[0]["rank"] == 0 and results[0]["epoch"] == 1
    assert results[0]["blacklisted"] == 1


def test_fusion_smoke(tmp_path):
    results = run_ranks(functools.partial(fusion_smoke.worker,
                                          tmpdir=str(tmp_path)), 2)
    assert all(r["steps"] >= fusion_smoke.STEPS for r in results)
    assert all(r["hidden_us"] > 0 for r in results)
    assert results[0]["loss"] == results[1]["loss"]


def test_a_failed_lane_aborts_its_nccl_communicators_once():
    """What the elastic smoke found on two cards: NCCL queues a collective
    whatever its peers do, so the lane aborts its communicators (its
    sets' and its hierarchy's) when it fails, once, not only at the
    re-formation that a commit hung on them would never reach."""
    import threading
    import types

    from horovod_tpu_torch.common.operations import Runtime, SetGroups

    class _Group:
        aborted = 0

        def abort(self):
            self.aborted += 1

    world, local, cross, gloo = _Group(), _Group(), _Group(), _Group()
    rt = types.SimpleNamespace(
        _fault_lock=threading.Lock(), _cuda_aborted=False,
        sets={0: SetGroups([0, 1], 0, {"cpu": gloo, "cuda": world})},
        data_plane=types.SimpleNamespace(hier_groups={2: (
            SetGroups([0, 1], 0, {"cuda": local}),
            SetGroups([0], 0, {"cuda": cross}))}))
    Runtime.abort_cuda(rt)
    Runtime.abort_cuda(rt)
    assert [g.aborted for g in (world, local, cross, gloo)] == [1, 1, 1, 0]


def test_a_commit_on_a_failed_card_lane_raises_before_saving(monkeypatch):
    """A commit on the card waits for the queued work, then raises the
    failed lane's error before it overwrites the last commit (whose host
    buffers a save reuses)."""
    import torch

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import elastic as ce
    from horovod_tpu_torch.common.exceptions import HorovodPeerFailureError
    from horovod_tpu_torch.torch import elastic as te

    state = te.TreeState(params=torch.ones(4), step=0)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(basics, "device", lambda: "cuda:0")
    monkeypatch.setattr(basics, "loop_failed", lambda: True)

    class _Lane:
        def _later_error(self, name):
            return HorovodPeerFailureError(f"cannot enqueue {name}", [1], 0,
                                           5)

    monkeypatch.setattr(basics, "lane", lambda: _Lane())
    state.params = torch.full((4,), 7.0)
    state.step = 1
    with pytest.raises(HorovodPeerFailureError, match="a commit"):
        state.commit()
    assert synced == ["cuda:0"]
    state.restore()
    assert state.step == 0 and torch.equal(state.params, torch.ones(4))
    # On the CPU there is nothing to wait for: the commit saves.
    monkeypatch.setattr(basics, "device", lambda: None)
    monkeypatch.setattr(ce, "_poll_rejoiners", lambda: 0)
    state.params = torch.full((4,), 3.0)
    state.commit()
    state.restore()
    assert torch.equal(state.params, torch.full((4,), 3.0))
