"""Two-rank observability smoke of the port's telemetry.

    python -m horovod_tpu_torch.telemetry.obs_smoke

The port's copy of ``horovod_tpu/telemetry/obs_smoke.py``: two ranks on
gloo with the debug server up on both (``HOROVOD_DEBUG_PORT``) run a
few timed steps, then ``HOROVOD_FAULT_INJECT`` kills rank 1 at the top
of a collective. It checks:

1. live introspection mid-run: rank 0 reads ``/healthz`` of both ranks
   (each with its ``step_time_ewma_ms`` above 0), its own ``/stacks``
   and its ``/events``;
2. the black box: the survivor dumps its ring at the fault, before its
   caller wakes (``HOROVOD_BLACKBOX_DIR``), with the reference's header,
   and the merged post-mortem (``report --post-mortem``, whole and
   streaming) names the killed rank as the root cause.

Where it differs from the reference's: the reference stalls rank 1 with
``stop:<ms>`` (SIGSTOP, a timeout that both ranks survive and dump,
naming the stalled rank first-stalled with no root cause); the port's
lane has no wire deadline to stall against (``stop`` waits for
ROADMAP.md L8), so rank 1 is killed, only rank 0 dumps, and the
post-mortem names rank 1 the root cause.
"""

import json
import os
import sys
import tempfile
import urllib.request

KILL_AT_OP = 3
ELEMS = 2048


def _get(url, timeout=10):
    return urllib.request.urlopen(url, timeout=timeout).read()


def worker(rank, size, tmpdir):
    """One rank; rank 1 dies at collective ``KILL_AT_OP``."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import HorovodPeerFailureError

    hvd.init(device="cpu")
    if rank == 1:
        basics.set_fault_inject(1, KILL_AT_OP)
    x = torch.full((ELEMS,), float(rank + 1))
    timer = telemetry.StepTimer()
    for i in range(KILL_AT_OP):
        with timer.step():
            out = hvd.allreduce(x, name=f"warm.{i}", op=hvd.Sum)
        assert float(out[0]) == 3.0, float(out[0])
    health = None
    if rank == 0:
        # Rank 1 has finished its steps (it enqueued the last warm-up op)
        # and waits in negotiation for the op it dies at.
        base = int(os.environ["HOROVOD_DEBUG_PORT"])
        health = [json.loads(_get(f"http://127.0.0.1:{base + r}/healthz"))
                  for r in range(size)]
        for r, h in enumerate(health):
            assert h["rank"] == r and h["initialized"], h
            assert h["epoch"] == 0 and not h["loop_failed"], h
            assert h["step_time_ewma_ms"] > 0, h
        stacks = _get(f"http://127.0.0.1:{base}/stacks")
        assert b"File" in stacks or b"Thread" in stacks
        evs = json.loads(_get(f"http://127.0.0.1:{base}/events?n=64"))
        assert any(e["type"] == "response_launch" for e in evs), evs
    try:
        hvd.allreduce(x, name="fatal", op=hvd.Sum)
        raise AssertionError(f"rank {rank}: the fatal op did not fault")
    except HorovodPeerFailureError as e:
        fault = {"ranks": list(e.fault_ranks),
                 "certain": basics.last_fault()["certain"]}
    hvd.shutdown()
    return {"rank": rank, "health": health, "fault": fault}


def check(tmpdir, results):
    """The parent's checks over the survivor's dump; returns the
    post-mortem."""
    from horovod_tpu_torch.telemetry import postmortem, report

    assert results[0]["fault"]["ranks"] == [1], results[0]
    bb_dir = os.path.join(tmpdir, "blackbox")
    assert sorted(os.listdir(bb_dir)) == ["blackbox-rank0.jsonl"], \
        os.listdir(bb_dir)
    dump = postmortem.load_blackbox(
        os.path.join(bb_dir, "blackbox-rank0.jsonl"))[-1]
    hdr = dump["header"]
    assert set(hdr) == {"kind", "rank", "size", "epoch", "unix_us",
                        "steady_us", "fault"}, hdr
    assert set(hdr["fault"]) == {"kind", "certain", "ranks", "detect_ms",
                                 "reason"}, hdr
    assert (hdr["rank"], hdr["size"], hdr["fault"]["ranks"]) == (0, 2, [1])
    assert any(e["type"] == "fault" for e in dump["events"]), dump["events"]
    analysis = postmortem.merge_post_mortem(bb_dir)
    assert analysis["root_cause_ranks"] == [1], analysis["root_cause_ranks"]
    stream = postmortem.merge_post_mortem_streaming(bb_dir)
    assert stream["root_cause_ranks"] == [1], stream["root_cause_ranks"]
    print(postmortem.format_post_mortem(analysis, tail=12))
    assert report.main(["--post-mortem", bb_dir]) == 0
    return analysis


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    with tempfile.TemporaryDirectory() as tmpdir:
        env = {"HOROVOD_DEBUG_PORT": str(smoke._free_port()),
               "HOROVOD_BLACKBOX_DIR": os.path.join(tmpdir, "blackbox")}
        results = smoke.run_workers(
            "horovod_tpu_torch.telemetry.obs_smoke", 2, tmpdir, env=env,
            victims=(1,))
        analysis = check(tmpdir, results)
    print(f"obs smoke: OK (/healthz on both ranks mid-run; the survivor's "
          f"black box names rank {analysis['root_cause_ranks'][0]} the root "
          f"cause, {len(analysis['timeline'])} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
