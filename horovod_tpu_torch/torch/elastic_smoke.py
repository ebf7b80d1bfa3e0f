"""Two-rank elastic smoke of the port's lane.

    python -m horovod_tpu_torch.torch.elastic_smoke [--cpu]

The port's copy of ``horovod_tpu/jax/elastic_smoke.py``: two ranks
(gloo with ``--cpu``, else NCCL with a card a rank, which needs two
cards) train under ``hvd.elastic.run`` with a committed
``hvd.elastic.TreeState``, and ``HOROVOD_FAULT_INJECT`` kills rank 1 at
the top of step ``FAIL_STEP``'s allreduce. It proves:

- rank 0 gets the typed recoverable error, re-forms a one-rank world in
  place (no process restart, no checkpoint round trip), restores the
  last commit and finishes training;
- its final params land on the reference trajectory: the two-rank mean
  gradients through the last commit, its own after;
- the metrics snapshot books the fault: detected, recovered, one rank
  left out, the epoch bumped, a detection latency.
"""

import sys
import tempfile
import time

STEPS = 6
FAIL_STEP = 3
DIM = 129
LR = 0.1
# state.sync() costs 2 broadcasts (ops 0-1); step s's allreduce is op
# 2 + s, so rank 1 dies at the top of step FAIL_STEP.
KILL_OP = 2 + FAIL_STEP


def worker(rank, size, tmpdir, device="cpu"):
    """One rank of the elastic run; only rank 0 returns (rank 1 dies)."""
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.telemetry import smoke

    del tmpdir
    dev = smoke.open_lane(hvd, device)
    start_rank = hvd.rank()
    if start_rank == 1:
        basics.set_fault_inject(1, KILL_OP)

    def grad(step, r):
        return torch.full((DIM,), 0.01 * (step + 1) * (r + 1), device=dev)

    state = hvd.elastic.TreeState(params=torch.zeros(DIM, device=dev),
                                  step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < STEPS:
            mean = hvd.allreduce(grad(state.step, hvd.rank()),
                                 name=f"g.{state.step}.{basics.epoch()}",
                                 op=hvd.Average)
            state.params = state.params - LR * mean
            state.step += 1
            state.commit()
        return state.params

    try:
        params = train(state).cpu().numpy()
        # Rank 1 dies inside the loop; only rank 0 gets here.
        assert start_rank == 0, start_rank
        assert (hvd.size(), basics.epoch()) == (1, 1), \
            (hvd.size(), basics.epoch())
        fault = basics.last_fault()
        assert fault is not None and fault["ranks"] == [1], fault
        assert fault["recovered"] is True, fault

        ref = np.zeros(DIM, np.float64)
        for s in range(STEPS):
            world = (1, 2) if s < FAIL_STEP else (1,)
            ref -= LR * 0.01 * (s + 1) * sum(world) / len(world)
        np.testing.assert_allclose(params, ref, rtol=1e-5, atol=1e-7)

        el = hvd.metrics()["elastic"]
        assert el["epoch"] == 1, el
        assert el["faults_detected"] >= 1, el
        assert el["faults_recovered"] == 1, el
        assert el["ranks_blacklisted"] == 1, el
        assert el["detect_us"]["count"] >= 1, el
    finally:
        hvd.shutdown()
    return {"rank": start_rank, "epoch": el["epoch"],
            "detected": el["faults_detected"],
            "detect_p50_us": el["detect_us"]["p50_us"],
            "blacklisted": el["ranks_blacklisted"]}


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    device = smoke.pick_device(argv, "elastic_smoke", 2)
    if device is None:
        return 2
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmpdir:
        results = smoke.run_workers(
            "horovod_tpu_torch.torch.elastic_smoke", 2, tmpdir,
            env={smoke.DEVICE_ENV: device}, victims=(1,))
    r = results[0]
    print(f"elastic smoke: OK (2 -> 1 on {device}: rank 1 killed at op "
          f"{KILL_OP}, the survivor re-formed in place at epoch "
          f"{r['epoch']}, resumed from its last commit onto the reference "
          f"trajectory, fault detected in {r['detect_p50_us']} us; "
          f"{time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
