"""Elastic training of the port across spawned gloo ranks, against the
reference's elastic core.

- A rank SIGKILLed mid-step by ``HOROVOD_FAULT_INJECT`` (the port of
  ``tests/parallel/test_elastic_ring.py:368``): both survivors raise the
  typed ``HorovodPeerFailureError`` naming it within 30 s of the kill,
  agree on ``survivors()``, re-form in place at epoch 1 and size 2, and
  finish with the params of ``_train_reference()`` and of the
  reference's run of the same worker.
- ``DistributedOptimizer`` over a small ``nn.Linear`` at 2 ranks: a
  ``HorovodInternalError`` raised with its hooks' allreduces in flight;
  after ``reset()`` its ``_drain_on_reset`` hook has cleared them and
  training goes on to the fault-free params.
- 2 ranks, rank 0 (the store's host) killed outside any collective:
  rank 1's next op fails with a record that is not certain, the size-2
  rule of ``survivors()`` names rank 1 alone, and it finishes at size 1.
- The port's workers under the reference's ``ElasticDriver``
  (``tests/integration/test_elastic_torch.py``'s worker): one killed at
  step 6 and respawned, both finish 12 steps at size 2, their digests
  equal to each other and to the reference worker's.
- The same scenario under the port's own ``ElasticDriver``: the same
  steps, size and digests.
"""

import json
import os
import queue
import signal
import sys
import time

import numpy as np
import torch

from tests.test_torch_mp import (
    REPO_ROOT,
    context,
    free_port,
    parent_state,
    rank_entry,
)

_TIMEOUT_MS = 2000   # the reference's wire deadline in its chaos runs


def run_chaos(fn, size, victims, timeout=120, env=None):
    """Run ``fn(rank, size)`` on spawned ranks, ``victims`` expected to
    die by SIGKILL: the survivors' results by rank, and the wall time at
    which each victim was seen dead (polled every 0.1 s)."""
    ctx = context()
    port = free_port()
    q = ctx.Queue()
    parent = parent_state()
    procs = {r: ctx.Process(target=rank_entry,
                            args=(fn, r, size, port, q, env, parent))
             for r in range(size)}
    for p in procs.values():
        p.start()
    results, errors, deaths = {}, {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < size - len(victims):
            assert time.monotonic() < deadline, \
                f"survivors hung: got {sorted(results)}"
            for v in victims:
                if v not in deaths and procs[v].exitcode is not None:
                    deaths[v] = time.time()
            try:
                rank, err, res = q.get(timeout=0.1)
            except queue.Empty:
                continue
            (errors if err is not None else results)[rank] = err or res
    finally:
        for r, p in procs.items():
            if r in victims and p.is_alive():
                p.kill()
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    assert not errors, f"survivor failures: {errors}"
    for v in victims:
        assert procs[v].exitcode == -signal.SIGKILL, (v, procs[v].exitcode)
        deaths.setdefault(v, time.time())
    return results, deaths


# ---- (i) SIGKILL mid-step, re-formed in place ---------------------------

_TRAIN_STEPS = 8
_TRAIN_FAIL_STEP = 5
_TRAIN_DIM = 257
_TRAIN_LR = 0.1
# state.sync() costs 2 broadcasts (ops 0-1); step s's allreduce is op
# 2 + s, so the victim dies at the top of step _TRAIN_FAIL_STEP.
_TRAIN_KILL_OP = 2 + _TRAIN_FAIL_STEP


def _grad(step, rank):
    return np.full(_TRAIN_DIM, 0.01 * (step + 1) * (rank + 1), np.float32)


def _train_reference():
    """3-rank mean gradients through the last commit (the end of step
    _TRAIN_FAIL_STEP - 1), then 2-rank ones."""
    p = np.zeros(_TRAIN_DIM, np.float64)
    for s in range(_TRAIN_STEPS):
        world = (1, 2, 3) if s < _TRAIN_FAIL_STEP else (1, 2)
        p = p - _TRAIN_LR * 0.01 * (s + 1) * sum(world) / len(world)
    return p


def _train(impl, steps=_TRAIN_STEPS, kill_outside=None):
    """The worker of both runs: an ObjectState trained under the elastic
    loop, one averaged allreduce a step. Records each typed error as it
    surfaces (wall time, ranks, survivors, the fault record)."""
    if impl == "port":
        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.common import basics as b
        from horovod_tpu_torch.common import elastic as hvd_elastic
        from horovod_tpu_torch.common.exceptions import (
            HorovodPeerFailureError,
        )

        hvd.init(device="cpu")

        def average(g, name):
            return hvd.allreduce(torch.from_numpy(g), name=name,
                                 op=hvd.Average).numpy()
        rank, size = hvd.rank, hvd.size
    else:
        from horovod_tpu.common import basics, eager_ops as ops
        from horovod_tpu.common import elastic as hvd_elastic
        from horovod_tpu.common.exceptions import HorovodPeerFailureError

        b = basics.HorovodBasics()
        hvd_elastic.init()

        def average(g, name):
            return ops.allreduce_async(
                g, name, op=ops.ReduceOp.AVERAGE).synchronize()
        rank, size = b.rank, b.size

    state = hvd_elastic.ObjectState(step=0,
                                    params=np.zeros(_TRAIN_DIM, np.float32))
    epochs, errors = [], []

    @hvd_elastic.run_fn
    def train(state):
        epochs.append(b.epoch())
        while state.step < steps:
            if kill_outside is not None and kill_outside == (
                    rank(), state.step) and b.epoch() == 0:
                os.kill(os.getpid(), signal.SIGKILL)
            g = _grad(state.step, rank())
            t0 = time.monotonic()
            try:
                mean = average(g, f"grad.{state.step}.{b.epoch()}")
            except HorovodPeerFailureError as e:
                fault = b.last_fault()
                errors.append(dict(
                    ranks=tuple(e.fault_ranks), epoch=e.epoch,
                    wall=time.time(), elapsed=time.monotonic() - t0,
                    survivors=hvd_elastic.survivors(),
                    certain=fault["certain"]))
                raise
            state.params = state.params - _TRAIN_LR * mean
            state.step += 1
            state.commit()
        return state.params

    params = train(state)
    out = dict(params=params, epochs=epochs, errors=errors, step=state.step,
               epoch=b.epoch(), size=size(), rank=rank())
    if impl == "port":
        out["elastic"] = hvd.metrics()["elastic"]
    b.shutdown()
    return out


def _train_port(rank, size):
    return _train("port")


def _train_ref(rank, size):
    return _train("ref")


def test_sigkilled_rank_reforms_in_place_and_recovers_training():
    env = {"HOROVOD_FAULT_INJECT": f"2:{_TRAIN_KILL_OP}",
           "HOROVOD_WIRE_TIMEOUT_MS": str(_TIMEOUT_MS)}
    port, deaths = run_chaos(_train_port, 3, victims={2}, env=env)
    ref, _ = run_chaos(_train_ref, 3, victims={2}, env=env)
    assert sorted(port) == sorted(ref) == [0, 1]
    want = _train_reference()
    for r in (0, 1):
        got = port[r]
        (err,) = got["errors"]
        assert err["ranks"] == (2,) and err["epoch"] == 0, err
        assert err["certain"] and err["survivors"] == [0, 1], err
        # Surfaced promptly: not after the groups' 600 s timeout.
        assert err["wall"] - deaths[2] < 30 and err["elapsed"] < 30, err
        assert got["epochs"] == [0, 1] == ref[r]["epochs"]
        assert (got["epoch"], got["size"], got["rank"]) == (1, 2, r)
        assert got["step"] == _TRAIN_STEPS
        np.testing.assert_allclose(got["params"], want, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["params"], ref[r]["params"],
                                   rtol=1e-5, atol=1e-7)
        assert ref[r]["errors"][0]["ranks"] == (2,)
        el = got["elastic"]
        assert el["epoch"] == 1 and el["faults_detected"] >= 1
        assert el["faults_recovered"] == el["ranks_blacklisted"] == 1
        assert el["detect_us"]["count"] >= 1
        assert el["last_fault"]["recovered"] is True


# ---- (i b) DistributedOptimizer's stale handles -------------------------

_OPT_STEPS, _OPT_FAIL_STEP, _OPT_LR = 6, 3, 0.05


def _opt_data(rank):
    rng = np.random.default_rng(11 + rank)
    return (torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((8, 1)).astype(np.float32)))


def _optimizer_worker(rank, size):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu")
    torch.manual_seed(7)
    model = torch.nn.Linear(4, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=_OPT_LR),
        named_parameters=model.named_parameters())
    state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)
    x, y = _opt_data(rank)
    seen = {"epochs": [], "in_flight_at_entry": []}

    @hvd.elastic.run
    def train(state):
        seen["epochs"].append(basics.epoch())
        seen["in_flight_at_entry"].append(len(opt._handles))
        while state.step < _OPT_STEPS:
            opt.zero_grad()
            torch.nn.functional.mse_loss(model(x), y).backward()
            if state.step == _OPT_FAIL_STEP and "raised" not in seen:
                # The hooks' allreduces are in flight now.
                seen["raised"] = len(opt._handles)
                raise hvd.HorovodInternalError("failed after backward")
            opt.step()
            state.step += 1
            state.commit()

    train(state)
    out = dict(seen=seen, epoch=basics.epoch(),
               params=[p.detach().numpy().copy()
                       for p in model.parameters()])
    hvd.shutdown()
    return out


def test_optimizer_drains_stale_handles_on_reset():
    from tests.test_torch_mp import run_ranks

    got = run_ranks(_optimizer_worker, 2, timeout=120)
    torch.manual_seed(7)
    model = torch.nn.Linear(4, 1)
    data = [_opt_data(r) for r in range(2)]
    for _ in range(_OPT_STEPS):
        grads = [torch.autograd.grad(torch.nn.functional.mse_loss(
            model(x), y), list(model.parameters())) for x, y in data]
        with torch.no_grad():
            for p, g0, g1 in zip(model.parameters(), *grads):
                p -= _OPT_LR * (g0 + g1) / 2
    for r in got:
        assert r["seen"]["raised"] == 2, r["seen"]     # weight and bias
        assert r["seen"]["epochs"] == [0, 1]
        assert r["seen"]["in_flight_at_entry"] == [0, 0]
        assert r["epoch"] == 1
        for p, w in zip(r["params"], model.parameters()):
            np.testing.assert_allclose(p, w.detach().numpy(), rtol=1e-6,
                                       atol=1e-7)
        for p, q in zip(r["params"], got[0]["params"]):
            assert np.array_equal(p, q)


# ---- (ii) the size-2 suspicion rule ------------------------------------

_SUSPECT_STEPS, _SUSPECT_KILL_STEP = 6, 3


def _suspect_worker(rank, size):
    return _train("port", steps=_SUSPECT_STEPS,
                  kill_outside=(0, _SUSPECT_KILL_STEP))


def test_store_host_lost_outside_a_collective_size_two_rule():
    got, deaths = run_chaos(_suspect_worker, 2, victims={0})
    r = got[1]
    (err,) = r["errors"]
    # Rank 0 took the store with it: a suspicion, named alike at size 2.
    assert err["ranks"] == (0,) and not err["certain"], err
    assert err["survivors"] == [1], err
    assert err["wall"] - deaths[0] < 30, err
    assert r["epochs"] == [0, 1]
    assert (r["epoch"], r["size"], r["rank"]) == (1, 1, 0)
    # Renumbered rank 0 of a world of one, it takes rank 0's gradients.
    p = np.zeros(_TRAIN_DIM, np.float64)
    for s in range(_SUSPECT_STEPS):
        world = (1, 2) if s < _SUSPECT_KILL_STEP else (1,)
        p = p - _TRAIN_LR * 0.01 * (s + 1) * sum(world) / len(world)
    np.testing.assert_allclose(r["params"], p, rtol=1e-5, atol=1e-7)


# ---- (iii) the reference's driver, the port's workers --------------------

WORKER_SRC = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
{imports}

tmp = {tmp!r}
{init}
torch.manual_seed(7)

model = torch.nn.Linear(4, 1)
base_opt = torch.optim.SGD(model.parameters(), lr=0.05)
opt = hvd.DistributedOptimizer(base_opt,
                               named_parameters=model.named_parameters())
state = hvd.elastic.TorchState(model=model, optimizer=base_opt, step=0)

rng = np.random.RandomState(3)
x = torch.from_numpy(rng.rand(64, 4).astype("float32"))
y = torch.from_numpy(rng.rand(64, 1).astype("float32"))


@hvd.elastic.run
def train(state):
    while state.step < 12:
        if state.step == 6:
            try:
                fd = os.open(os.path.join(tmp, "suicide.lock"),
                             os.O_CREAT | os.O_EXCL)
                os.close(fd)
                os._exit(17)
            except FileExistsError:
                pass
        i = (state.step * 8) % 64
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x[i:i + 8]), y[i:i + 8])
        loss.backward()
        opt.step()
        state.step += 1
        state.commit()

train(state)
digest = float(sum(p.detach().sum() for p in model.parameters()))
peers = hvd.allgather_object(digest)
wid = os.environ["HOROVOD_WORKER_ID"].replace(":", "_")
with open(os.path.join(tmp, "done." + wid), "w") as f:
    json.dump({{"step": int(state.step), "size": hvd.size(),
               "peers": peers}}, f)
hvd.shutdown()
"""

_IMPLS = {
    "port": ("import horovod_tpu_torch.torch as hvd",
             'hvd.init(device="cpu")'),
    "ref": ('import jax\njax.config.update("jax_platforms", "cpu")\n'
            "import horovod_tpu.torch as hvd", "hvd.init()"),
}


def _drive(tmp_path, impl, driver="ref"):
    """The workers of ``impl`` under ``driver``'s ``ElasticDriver``
    (the reference's or the port's), 2 slots on this host."""
    if driver == "ref":
        from horovod_tpu.runner.elastic.discovery import FixedHosts
        from horovod_tpu.runner.elastic.driver import ElasticDriver
    else:
        from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
        from horovod_tpu_torch.runner.elastic.driver import ElasticDriver

    tmp = tmp_path / f"{impl}.{driver}"
    tmp.mkdir()
    imports, init = _IMPLS[impl]
    worker = tmp / "worker.py"
    worker.write_text(WORKER_SRC.format(repo=REPO_ROOT, tmp=str(tmp),
                                        imports=imports, init=init))
    driver = ElasticDriver(FixedHosts({"localhost": 2}),
                           [sys.executable, str(worker.resolve())],
                           min_np=2, max_np=2, poll_interval=0.5,
                           start_timeout=120,
                           env={"JAX_PLATFORMS": "cpu",
                                "PYTHONPATH": REPO_ROOT})
    driver.start()
    try:
        rc = driver.wait_for_completion()
    finally:
        driver.stop()
    assert rc == 0, impl
    assert (tmp / "suicide.lock").exists()
    done = [json.loads(p.read_text()) for p in sorted(tmp.glob("done.*"))]
    assert len(done) == 2, impl
    return done


def test_reference_driver_respawns_port_workers(tmp_path):
    port = _drive(tmp_path, "port")
    ref = _drive(tmp_path, "ref")
    want = ref[0]["peers"][0]
    for r in port + ref:
        assert r["step"] == 12 and r["size"] == 2, r
        assert all(abs(d - want) < 1e-5 for d in r["peers"]), (r, want)


def _plain_digest(steps=12):
    """The worker's training without a fault or a peer: both ranks take
    the same batches, so the averaged gradients are one rank's."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(64, 4).astype("float32"))
    y = torch.from_numpy(rng.rand(64, 1).astype("float32"))
    torch.manual_seed(7)
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    for step in range(steps):
        i = (step * 8) % 64
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x[i:i + 8]), y[i:i + 8]).backward()
        opt.step()
    return float(sum(p.detach().sum() for p in model.parameters()))


def test_port_driver_respawns_port_workers(tmp_path):
    """The port's own ElasticDriver, the port's workers: the killed one
    respawned, both finish 12 steps at size 2 with the digest the
    reference driver's run reaches (its run above equals the plain
    training's)."""
    done = _drive(tmp_path, "port", driver="port")
    want = _plain_digest()
    for r in done:
        assert r["step"] == 12 and r["size"] == 2, r
        assert len(r["peers"]) == 2
        assert all(abs(d - want) < 1e-5 for d in r["peers"]), (r, want)
