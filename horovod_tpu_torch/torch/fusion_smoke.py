"""Two-rank compute/collective fusion smoke of the port's lane.

    python -m horovod_tpu_torch.torch.fusion_smoke [--cpu]

The port's copy of ``horovod_tpu/jax/fusion_smoke.py``. Before the
ranks start, the C7 gate of hvdlint (``analysis/``), host-side in this
process: the registered ``zero1_fused_step`` lints clean, and a
tail-bunched fixture (two matmuls, then two reduce-scatters, then two
all-gathers over ``data=2``) fires exactly C7, so a vacuously quiet
check gates nothing. Then two ranks (gloo with ``--cpu``, else NCCL with
a card a rank, which needs two cards) train a small MLP through
``hvd.make_fused_train_step`` (ZeRO-1 with each bucket's reduce-scatter
started from the backward, ``parallel/fusion.py``) and prove:

- **the ledger invariant**: under a ``StepTimer``, on every plane,
  ``exposed + hidden == total`` exactly, the overlap ledger closed a
  window for every step, and the fused schedule hid wire time
  (``hidden > 0``: collectives ran while no caller waited on them);
- **the schedule knob's identity**: ``HOROVOD_JIT_FUSION`` flips the
  schedule, never the numbers, so the fused and the unfused losses and
  final params are the same bits.
"""

import sys
import tempfile
import time

STEPS = 4
SHAPES = {"w1": (32, 64), "w2": (64, 32), "b2": (32,), "w3": (32, 8)}
BUCKET_BYTES = 4096
LR = 1e-2
SEED = 0


def _inputs(device):
    """The params and the batch, from a seed with numpy (every rank the
    same)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    params = {name: torch.from_numpy(
        np.zeros(shape, np.float32) if len(shape) == 1
        else (rng.standard_normal(shape) * 0.1).astype(np.float32))
        .to(device) for name, shape in SHAPES.items()}
    batch = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(device) for k, s in (("x", (8, 32)), ("y", (8, 8)))}
    return params, batch


def loss_fn(p, b):
    import torch

    h = torch.tanh(b["x"] @ p["w1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return torch.mean((h @ p["w3"] - b["y"]) ** 2)


def _bunched(mesh, x, w):
    """Backward-shaped fixture: all the arithmetic, then every bucket's
    reduce-scatter bunched at the tail."""
    import torch

    from horovod_tpu_torch.parallel import ops

    g = mesh.axis_group("data")
    a = x @ w
    b = torch.tanh(a) @ w
    s1 = ops.reduce_scatter(a.reshape(-1), g)
    s2 = ops.reduce_scatter(b.reshape(-1), g)
    return ops.all_gather(s1, g), ops.all_gather(s2, g)


def _lint_gate():
    """C7 both ways, host-side (no ranks needed): the shipped fused
    program lints clean, and a tail-bunched fixture still fires."""
    import torch

    from horovod_tpu_torch import analysis
    from horovod_tpu_torch.analysis.lint import main as lint_main

    rc = lint_main(["--program", "zero1_fused_step"])
    assert rc == 0, f"hvdlint zero1_fused_step rc={rc}"
    x = torch.ones((16, 16))
    diags = analysis.lint(_bunched, lambda mesh: (mesh, x, x),
                          axis_env=[("data", 2)])
    assert [d.id for d in diags] == ["C7"], diags
    print("FUSION_SMOKE_LINT_OK (C7 clean on zero1_fused_step, fires on "
          "the bunched fixture)")


def worker(rank, size, tmpdir, device="cpu"):
    """One rank: the fused run under a timer, the unfused run; returns
    the ledger's numbers."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.parallel import fusion
    from horovod_tpu_torch.telemetry import smoke

    del tmpdir
    dev = smoke.open_lane(hvd, device)
    try:
        params, batch = _inputs(dev)
        init, step, finish = hvd.make_fused_train_step(
            loss_fn, LR, bucket_bytes=BUCKET_BYTES)

        def run(fused, timer=None):
            fusion.set_jit_fusion(fused)
            carry = init({k: v.clone() for k, v in params.items()})
            losses = []
            for _ in range(STEPS):
                if timer is not None:
                    timer.start_step()
                loss, carry = step(carry, batch)
                losses.append(loss.detach().clone())
                if timer is not None:
                    timer.end_step(loss)
            p, _ = finish(carry)
            return losses, p

        # (1) the fused lane under a StepTimer: the ledger's invariant.
        telemetry.metrics_reset()
        losses_f, params_f = run(True, telemetry.StepTimer())
        ov = telemetry.wire_overlap()
        assert ov["steps"] >= STEPS, ov
        hidden_us = 0
        for plane in ("intra", "cross"):
            p = ov[plane]
            assert p["exposed_us"] + p["hidden_us"] == p["total_us"], ov
            hidden_us += p["hidden_us"]
        assert hidden_us > 0, ov

        # (2) the unfused schedule: the same bits.
        losses_u, params_u = run(False)
        for lf, lu in zip(losses_f, losses_u):
            assert torch.equal(lf, lu), (lf, lu)
        for k in params:
            assert torch.equal(params_f[k], params_u[k]), k
    finally:
        fusion.set_jit_fusion(None)
        hvd.shutdown()
    return {"rank": rank, "steps": ov["steps"], "hidden_us": hidden_us,
            "total_us": ov["intra"]["total_us"] + ov["cross"]["total_us"],
            "loss": float(losses_f[-1])}


def main(argv=None):
    from horovod_tpu_torch.telemetry import smoke

    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return smoke.worker_main(worker)
    device = smoke.pick_device(argv, "fusion_smoke", 2)
    if device is None:
        return 2
    t0 = time.monotonic()
    _lint_gate()
    with tempfile.TemporaryDirectory() as tmpdir:
        results = smoke.run_workers(
            "horovod_tpu_torch.torch.fusion_smoke", 2, tmpdir,
            env={smoke.DEVICE_ENV: device})
    print(f"fusion smoke: OK (2 ranks on {device}: exposed + hidden == "
          f"total on every plane, hidden "
          f"{min(r['hidden_us'] for r in results)} us or more on the fused "
          f"schedule, fused and unfused the same bits; "
          f"{time.monotonic() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
