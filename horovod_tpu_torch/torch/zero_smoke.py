"""Two-rank ZeRO-1 smoke of the port's eager lane.

    python -m horovod_tpu_torch.torch.zero_smoke [--cpu]

The port's copy of ``horovod_tpu/jax/zero_smoke.py``: two ranks (gloo
with ``--cpu``, else NCCL with a card a rank, which needs two cards)
step ``hvd.DistributedFusedAdam(zero=True)`` on rank-varying gradients
and prove the ZeRO lane end to end:

- its params land on the replicated ``parallel.precision.fused_adam``
  fed the rank-mean gradients (ZeRO changes memory and wire, not the
  numerics);
- its optimizer state a rank is about 1/N of the replicated state's
  bytes (padding and the step count are the only slack);
- the snapshot books reduce-scatters and allgathers and no allreduce,
  and their logical bytes are ``telemetry.predict.zero_layout_bytes``'
  within 1% (on the card, where the lane books an allgather's input
  shard as the reference's device plane does, the reduce-scatters'
  padded buckets and 1/N of them for the allgathers).
"""

import sys
import tempfile
import time

STEPS = 4
SHAPES = [(64, 32), (33,), (32, 16), (129,)]
BUCKET_BYTES = 8 * 1024
LR = 1e-2


def _ops(snap, kind, field):
    """``field`` of one op kind over both sections (``ops``: CPU tensors,
    ``device_ops``: CUDA tensors)."""
    return sum(snap[section].get(kind, {}).get(field, 0)
               for section in ("ops", "device_ops"))


def worker(rank, size, tmpdir, device="cpu"):
    """One rank's ZeRO steps and their checks; returns the numbers."""
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.parallel.precision import fused_adam
    from horovod_tpu_torch.parallel.zero import (
        optimizer_state_bytes,
        zero_bucket_layout,
    )
    from horovod_tpu_torch.telemetry import smoke
    from horovod_tpu_torch.telemetry.predict import zero_layout_bytes

    del tmpdir
    dev = smoke.open_lane(hvd, device)
    try:
        def tree(value):
            return {f"p{i}": torch.full(s, value(i), device=dev)
                    for i, s in enumerate(SHAPES)}

        params = tree(lambda i: 0.05 * (i + 1))
        # Rank-varying gradients whose mean every rank knows.
        grads = tree(lambda i: 0.1 * (rank + 1) * (i - 1.5))
        gmean = tree(lambda i: 0.1 * (i - 1.5) * (size + 1) / 2.0)

        zopt = hvd.DistributedFusedAdam(LR, zero=True,
                                        bucket_bytes=BUCKET_BYTES)
        ref = fused_adam(LR)
        zp = {k: v.clone() for k, v in params.items()}
        rp = {k: v.clone() for k, v in params.items()}
        zstate, rstate = zopt.init(zp), ref.init(rp)

        telemetry.metrics_reset()
        for _ in range(STEPS):
            zp, zstate = zopt.apply(zp, grads, zstate)
            rp, rstate = ref.apply(rp, gmean, rstate)
        snap = telemetry.snapshot()

        # 1) parity with the replicated update on the mean gradients.
        for k in params:
            np.testing.assert_allclose(zp[k].cpu().numpy(),
                                       rp[k].cpu().numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        # 2) the ZeRO-1 memory cut.
        zbytes = optimizer_state_bytes(zstate)
        rbytes = optimizer_state_bytes(rstate)
        assert zbytes < rbytes / size * 1.10, (zbytes, rbytes, size)
        # 3) the collective mix, and its bytes against the layout's.
        layout = zero_bucket_layout(list(params.values()), size,
                                    BUCKET_BYTES)
        predicted = zero_layout_bytes(layout) * STEPS
        if dev.type == "cuda":
            # The card books an allgather's negotiated (input) shapes, a
            # 1/N shard of each padded bucket, as the reference's device
            # plane does (common/operations.py _account); the CPU books
            # its gathered result.
            predicted = predicted // 2 * (size + 1) // size
        moved = (_ops(snap, "reducescatter", "bytes")
                 + _ops(snap, "allgather", "bytes"))
        assert _ops(snap, "allreduce", "tensors") == 0, snap["ops"]
        assert _ops(snap, "reducescatter", "tensors") > 0, snap["ops"]
        assert predicted > 0 and abs(moved / predicted - 1.0) < 0.01, (
            moved, predicted)
    finally:
        hvd.shutdown()
    return {"rank": rank, "opt_bytes": zbytes, "replicated": rbytes,
            "moved": moved, "predicted": predicted}


def check(results, size=2):
    """The parent's checks: every rank reported the same layout."""
    assert [r["rank"] for r in results] == list(range(size)), results
    assert len({(r["moved"], r["predicted"]) for r in results}) == 1, \
        results
    return results[0]


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    device = smoke.pick_device(argv, "zero_smoke", 2)
    if device is None:
        return 2
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmpdir:
        results = smoke.run_workers("horovod_tpu_torch.torch.zero_smoke", 2,
                                    tmpdir, env={smoke.DEVICE_ENV: device})
    r = check(results)
    print(f"zero smoke: OK (2 ranks on {device}: replicated parity, "
          f"optimizer state {r['opt_bytes']} B a rank of {r['replicated']} "
          f"B, reduce-scatter + allgather {r['moved']} B against the "
          f"layout's {r['predicted']} B; {time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
