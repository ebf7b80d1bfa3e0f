"""The parole door (driverless scale-up) and the voluntary shrink of the
port's elastic training, across spawned gloo ranks, against the
trajectories the reference's chaos tests pin
(``tests/parallel/test_chaos_matrix.py:471 _train_reference``).

- SIGKILL then parole rejoin (the port of ``test_chaos_matrix.py:579``):
  3 ranks, rank 2 killed at step 5, a fresh joiner absorbed at the
  fault's re-formation (``HOROVOD_REJOIN_POLL=0``): every rank ends at
  epoch 1, size 3, on the uninterrupted 3-rank trajectory; one rank
  blacklisted, one rejoined, one fault recovered.
- A healthy commit absorbs a joiner (the port of ``:643``): 2 -> 3 at
  step 0's commit, ``epochs_seen == [0, 1]``, one rank rejoined, none
  blacklisted, no fault; the reference's core runs the same worker and
  lands on the same params. Then 1 -> 2: a world of one hosts the store
  when the door is on, and its commit poll is local.
- Shrink then rejoin (``tests/parallel/test_autoscale_chaos.py:186``'s
  sequence without the autoscaler): 3 ranks, ``shrink({2})`` after step
  2, the victim knocks again and the next commit grows the world back.
- A ``TorchState`` joiner over a small ``nn.Linear`` and a ``TreeState``
  joiner over its weights: equal to the survivors' parameters after its
  first ``sync()``.
- The door in one process: a freeze is idempotent per epoch, the count
  outlives the release, a failed poll gives 0 with a ``RuntimeWarning``,
  ``shrink`` of an improper set raises ``ValueError``.
"""

import json
import multiprocessing as mp
import os
import queue
import signal
import socket
import sys
import time
import types
import warnings

import numpy as np
import pytest
import torch

from tests.utils_mp import REPO_ROOT, free_port

_TRAIN_STEPS = 8
_TRAIN_FAIL_STEP = 5
_TRAIN_DIM = 193
_TRAIN_LR = 0.1
# ObjectState.sync() at size > 1 is 2 broadcasts (ops 0-1); step s's
# allreduce is op 2 + s: the victim dies at the top of step 5.
_TRAIN_KILL_OP = 2 + _TRAIN_FAIL_STEP


def _entry(fn, rank, size, port, q, env):
    os.environ.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(rank),
        "HOROVOD_LOCAL_SIZE": str(size),
        "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
        "HOROVOD_CONTROLLER_PORT": str(port),
        "JAX_PLATFORMS": "cpu",
    })
    os.environ.update(env or {})
    sys.path.insert(0, REPO_ROOT)
    try:
        q.put((rank, None, fn(rank, size)))
    except Exception as e:  # noqa: BLE001
        import traceback

        traceback.print_exc()
        q.put((rank, f"{type(e).__name__}: {e}", None))


def run_world(fn, size, victims=(), env=None, extra=(), timeout=150):
    """``fn(rank, size)`` on ``size`` spawned ranks, ``victims`` expected
    to die by SIGKILL, and each ``(fn, env)`` of ``extra`` as a fresh
    process beside them (results under ``size``, ``size + 1``...): the
    results of every process that lived, by index."""
    ctx = mp.get_context("spawn")
    port = free_port()
    q = ctx.Queue()
    jobs = [(fn, env or {})] * size + [
        (f, dict(env or {}, **e)) for f, e in extra]
    procs = {i: ctx.Process(target=_entry, args=(f, i, size, port, q, e))
             for i, (f, e) in enumerate(jobs)}
    for p in procs.values():
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < len(jobs) - len(victims):
            assert time.monotonic() < deadline, \
                f"hung: got {sorted(results)}, errors {errors}"
            try:
                i, err, res = q.get(timeout=0.1)
            except queue.Empty:
                continue
            (errors if err is not None else results)[i] = err or res
    finally:
        for i, p in procs.items():
            if i in victims and p.is_alive():
                p.kill()
            p.join(timeout=15)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    assert not errors, f"failures: {errors}"
    for v in victims:
        assert procs[v].exitcode == -signal.SIGKILL, (v, procs[v].exitcode)
    return results


def _grad(step, rank):
    return np.full(_TRAIN_DIM, 0.01 * (step + 1) * (rank + 1), np.float32)


def _train_reference(worlds_by_step):
    """``test_chaos_matrix.py:471``: the params after every step, given
    the world (1-based rank multipliers) each step ran in."""
    p = np.zeros(_TRAIN_DIM, np.float64)
    for s in range(_TRAIN_STEPS):
        world = worlds_by_step(s)
        p = p - _TRAIN_LR * 0.01 * (s + 1) * sum(world) / len(world)
    return p


def _api(impl):
    """The port's elastic lane or the reference's core, behind one face."""
    if impl == "port":
        import horovod_tpu_torch.torch as hvd
        from horovod_tpu_torch.common import basics as b
        from horovod_tpu_torch.common import elastic as el

        return types.SimpleNamespace(
            b=b, el=el, init=lambda: el.init(device="cpu"),
            rejoin=lambda: el.rejoin(timeout=120, device="cpu"),
            average=lambda g, name: hvd.allreduce(
                torch.from_numpy(g), name=name, op=hvd.Average).numpy(),
            elastic=lambda: hvd.metrics()["elastic"])
    from horovod_tpu.common import basics, eager_ops as ops
    from horovod_tpu.common import elastic as el

    b = basics.HorovodBasics()
    return types.SimpleNamespace(
        b=b, el=el, init=el.init, rejoin=lambda: el.rejoin(timeout=120),
        average=lambda g, name: ops.allreduce_async(
            g, name, op=ops.ReduceOp.AVERAGE).synchronize(),
        elastic=lambda: b.metrics_snapshot()["elastic"])


class _Evicted(Exception):
    pass


def _train(api, state, epochs_seen, after_commit=None):
    @api.el.run_fn
    def train(state):
        epochs_seen.append(api.b.epoch())
        while state.step < _TRAIN_STEPS:
            g = _grad(state.step, api.b.rank())
            mean = api.average(g, f"grad.{state.step}.{api.b.epoch()}")
            state.params = state.params - _TRAIN_LR * mean
            state.step += 1
            state.commit()
            if after_commit is not None:
                after_commit(state)
        return state.params

    return train(state)


def _await_knock(api):
    """Rank 0 gates training on a joiner at its door, so that the
    transition that should absorb it has one to absorb."""
    door = api.el._ensure_door()
    deadline = time.monotonic() + 60
    while door.pending_count() == 0:
        assert time.monotonic() < deadline, "the joiner never knocked"
        time.sleep(0.05)


def _survivor(impl, rank):
    api = _api(impl)
    api.init()
    if rank == 0:
        _await_knock(api)
    state = api.el.ObjectState(step=0,
                               params=np.zeros(_TRAIN_DIM, np.float32))
    epochs_seen = []
    params = _train(api, state, epochs_seen)
    out = dict(params=params, epochs=epochs_seen, epoch=api.b.epoch(),
               size=api.b.size(), rank=api.b.rank(), elastic=api.elastic())
    api.b.shutdown()
    return out


def _joiner(impl):
    """A fresh process: knock (retrying while rank 0 opens its door),
    wait to be absorbed, then train from the survivors' commit."""
    api = _api(impl)
    deadline = time.monotonic() + 60
    while True:
        try:
            asg = api.rejoin()
            break
        except (OSError, ConnectionError):
            assert time.monotonic() < deadline, "the door never opened"
            time.sleep(0.2)
    state = api.el.ObjectState(step=0,
                               params=np.zeros(_TRAIN_DIM, np.float32))
    epochs_seen = []
    params = _train(api, state, epochs_seen)
    out = dict(asg=asg, params=params, epochs=epochs_seen,
               epoch=api.b.epoch(), size=api.b.size(), rank=api.b.rank())
    api.b.shutdown()
    return out


# ---- SIGKILL, then a parole joiner at the fault's transition ------------


def _kill_survivor(rank, size):
    return _survivor("port", rank)


def _kill_joiner(rank, size):
    return _joiner("port")


def test_sigkill_then_parole_rejoin_regrows_and_pins_trajectory():
    got = run_world(
        _kill_survivor, 3, victims={2},
        env={"HOROVOD_REJOIN_PORT": str(free_port()),
             "HOROVOD_REJOIN_POLL": "0",
             "HOROVOD_FAULT_INJECT": f"2:{_TRAIN_KILL_OP}:kill"},
        extra=[(_kill_joiner, {"HOROVOD_FAULT_INJECT": "",
                               "HOROVOD_WORKER_ID": "parolee:1"})])
    assert sorted(got) == [0, 1, 3]
    want = _train_reference(lambda s: (1, 2, 3))
    for r in (0, 1):
        assert got[r]["epochs"] == [0, 1]
        assert (got[r]["epoch"], got[r]["size"], got[r]["rank"]) == (1, 3, r)
        np.testing.assert_allclose(got[r]["params"], want, rtol=1e-5,
                                   atol=1e-7)
        el = got[r]["elastic"]
        assert el["ranks_blacklisted"] == el["ranks_rejoined"] == 1, el
        assert el["faults_recovered"] == 1, el
    j = got[3]
    assert (j["asg"]["rank"], j["asg"]["size"], j["asg"]["epoch"]) == (2, 3, 1)
    assert j["epochs"] == [1] and (j["epoch"], j["rank"]) == (1, 2)
    np.testing.assert_allclose(j["params"], want, rtol=1e-5, atol=1e-7)


# ---- a healthy commit absorbs a joiner ---------------------------------


def _grow_port(rank, size):
    return _survivor("port", rank)


def _grow_ref(rank, size):
    return _survivor("ref", rank)


def _grow_joiner_port(rank, size):
    return _joiner("port")


def _grow_joiner_ref(rank, size):
    return _joiner("ref")


def _check_grow(got, base):
    # Step 0 runs at the base world, its commit absorbs the joiner, and
    # every later step runs one rank larger.
    full = tuple(range(1, base + 2))
    want = _train_reference(lambda s: full[:base] if s == 0 else full)
    for r in range(base):
        assert got[r]["epochs"] == [0, 1]
        assert (got[r]["epoch"], got[r]["size"]) == (1, base + 1)
        np.testing.assert_allclose(got[r]["params"], want, rtol=1e-5,
                                   atol=1e-7)
        el = got[r]["elastic"]
        assert el["ranks_rejoined"] == 1, el
        assert el["ranks_blacklisted"] == 0 and el["faults_detected"] == 0
    j = got[base]
    assert (j["asg"]["rank"], j["asg"]["size"]) == (base, base + 1)
    assert j["epochs"] == [1] and j["epoch"] == 1
    np.testing.assert_allclose(j["params"], want, rtol=1e-5, atol=1e-7)
    return want


def test_healthy_commit_absorbs_parole_joiner_scale_up():
    port = run_world(
        _grow_port, 2, env={"HOROVOD_REJOIN_PORT": str(free_port())},
        extra=[(_grow_joiner_port, {"HOROVOD_WORKER_ID": "parolee:2"})])
    ref = run_world(
        _grow_ref, 2, env={"HOROVOD_REJOIN_PORT": str(free_port()),
                           "HOROVOD_WIRE_TIMEOUT_MS": "5000"},
        extra=[(_grow_joiner_ref, {"HOROVOD_WORKER_ID": "parolee:2"})])
    _check_grow(port, 2)
    _check_grow(ref, 2)
    for r in range(3):
        np.testing.assert_allclose(port[r]["params"], ref[r]["params"],
                                   rtol=1e-6, atol=1e-8)


def test_a_world_of_one_grows_through_its_door():
    got = run_world(
        _grow_port, 1, env={"HOROVOD_REJOIN_PORT": str(free_port())},
        extra=[(_grow_joiner_port, {"HOROVOD_WORKER_ID": "parolee:1"})])
    _check_grow(got, 1)


# ---- shrink, then the victim knocks again ------------------------------


_SHRINK_AFTER = 3     # the commit of step 2: steps 0-2 ran at 3 ranks


def _shrink_worlds(step):
    # Steps 0-2 at 3 ranks; step 3 at 2 (its commit sees the knock);
    # steps 4-7 at 3 again.
    return (1, 2) if step == _SHRINK_AFTER else (1, 2, 3)


def _shrink_worker(rank, size):
    api = _api("port")
    api.init()
    state = api.el.ObjectState(step=0,
                               params=np.zeros(_TRAIN_DIM, np.float32))
    epochs_seen = []

    def after_commit(state):
        if state.step == _SHRINK_AFTER and api.b.epoch() == 0:
            if not api.el.shrink({2}):
                raise _Evicted()
            if api.b.rank() == 0:
                _await_knock(api)

    try:
        params = _train(api, state, epochs_seen, after_commit)
    except _Evicted:
        assert not api.b.is_initialized()
        left = (state.step, state.params.copy())
        return dict(left=left, **_joiner("port"))
    out = dict(params=params, epochs=epochs_seen, epoch=api.b.epoch(),
               size=api.b.size(), rank=api.b.rank(), elastic=api.elastic())
    api.b.shutdown()
    return out


def test_shrink_then_the_victim_rejoins():
    got = run_world(_shrink_worker, 3,
                    env={"HOROVOD_REJOIN_PORT": str(free_port())})
    want = _train_reference(_shrink_worlds)
    for r in (0, 1):
        assert got[r]["epochs"] == [0, 2]
        assert (got[r]["epoch"], got[r]["size"], got[r]["rank"]) == (2, 3, r)
        np.testing.assert_allclose(got[r]["params"], want, rtol=1e-5,
                                   atol=1e-7)
        el = got[r]["elastic"]
        # Capacity management, not a fault: the victim blacklisted at the
        # shrink, one rank rejoined at the grow.
        assert el["ranks_blacklisted"] == el["ranks_rejoined"] == 1, el
        assert el["faults_detected"] == el["faults_recovered"] == 0, el
    v = got[2]
    step, params = v["left"]
    assert step == _SHRINK_AFTER
    np.testing.assert_allclose(params, np.full(_TRAIN_DIM, _partial(step)),
                               rtol=1e-5, atol=1e-7)
    assert (v["asg"]["rank"], v["asg"]["size"], v["asg"]["epoch"]) == (2, 3, 2)
    assert v["epochs"] == [2] and (v["epoch"], v["rank"]) == (2, 2)
    np.testing.assert_allclose(v["params"], want, rtol=1e-5, atol=1e-7)


def _partial(steps):
    """The params after ``steps`` steps at 3 ranks (one value: every
    element is the same)."""
    p = 0.0
    for s in range(steps):
        p -= _TRAIN_LR * 0.01 * (s + 1) * 2.0
    return p


# ---- TorchState and TreeState joiners ----------------------------------


_LIN_STEPS = 4


def _lin_data(rank):
    rng = np.random.default_rng(21 + rank)
    return (torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((8, 1)).astype(np.float32)))


def _lin_run(joiner, kind):
    """A small ``nn.Linear`` trained under ``TorchState`` with
    ``DistributedOptimizer``, or its weights as a tree under
    ``TreeState`` with averaged gradients; a joiner starts from other
    weights."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    if joiner:
        deadline = time.monotonic() + 60
        while True:
            try:
                hvd.elastic.rejoin(timeout=120, device="cpu")
                break
            except (OSError, ConnectionError):
                assert time.monotonic() < deadline, "the door never opened"
                time.sleep(0.2)
    else:
        hvd.init(device="cpu")
        if hvd.rank() == 0:
            _await_knock(_api("port"))
    torch.manual_seed(100 if joiner else 7)
    model = torch.nn.Linear(4, 1)
    if kind == "torch":
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters())
        state = hvd.elastic.TorchState(model=model, optimizer=opt, step=0)

        def weights():
            return [p.detach().numpy().copy() for p in model.parameters()]
    else:
        state = hvd.elastic.TreeState(params={
            "w": model.weight.detach().clone(),
            "b": model.bias.detach().clone()}, step=0)

        def weights():
            return [state.params[k].numpy().copy() for k in ("w", "b")]
    entries = []

    @hvd.elastic.run
    def train(state):
        entries.append((basics.epoch(), state.step, weights()))
        x, y = _lin_data(hvd.rank())
        while state.step < _LIN_STEPS:
            if kind == "torch":
                opt.zero_grad()
                torch.nn.functional.mse_loss(model(x), y).backward()
                opt.step()
            else:
                p = {k: v.clone().requires_grad_() for k, v in
                     state.params.items()}
                loss = torch.nn.functional.mse_loss(x @ p["w"].T + p["b"], y)
                grads = torch.autograd.grad(loss, [p["w"], p["b"]])
                state.params = {
                    k: (v - 0.05 * hvd.allreduce(
                        g, name=f"tree.{k}.{state.step}", op=hvd.Average))
                    for (k, v), g in zip(state.params.items(), grads)}
            state.step += 1
            state.commit()

    train(state)
    out = dict(entries=entries, rank=hvd.rank(), epoch=basics.epoch(),
               params=weights())
    hvd.shutdown()
    return out


def _lin_survivor_torch(rank, size):
    return _lin_run(False, "torch")


def _lin_joiner_torch(rank, size):
    return _lin_run(True, "torch")


def _lin_survivor_tree(rank, size):
    return _lin_run(False, "tree")


def _lin_joiner_tree(rank, size):
    return _lin_run(True, "tree")


@pytest.mark.parametrize("kind", ["torch", "tree"])
def test_torch_state_joiner_takes_the_survivors_commit(kind):
    survivor, joiner = {"torch": (_lin_survivor_torch, _lin_joiner_torch),
                        "tree": (_lin_survivor_tree, _lin_joiner_tree)}[kind]
    got = run_world(survivor, 2,
                    env={"HOROVOD_REJOIN_PORT": str(free_port())},
                    extra=[(joiner, {"HOROVOD_WORKER_ID": "lin:1"})])
    (epoch, step, synced), = got[2]["entries"]
    assert (epoch, step) == (1, 1)
    for r in (0, 1):
        # Each survivor entered at epoch 0, then after the grow at step
        # 1's commit, holding that commit.
        first, second = got[r]["entries"]
        assert (first[:2], second[:2]) == ((0, 0), (1, 1))
        for a, b in zip(second[2], synced):
            assert np.array_equal(a, b)
    for r in (1, 2):
        for a, b in zip(got[r]["params"], got[0]["params"]):
            assert np.array_equal(a, b)


# ---- the door in one process -------------------------------------------


def _hello(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall(b'{"op": "hello", "worker": "w"}\n')
    return s


def _poll(port, epoch):
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall((json.dumps({"op": "poll", "epoch": epoch}) +
                   "\n").encode())
        return json.loads(s.makefile("r").readline())["count"]


def _wait_pending(door, n):
    deadline = time.monotonic() + 10
    while door.pending_count() != n:
        assert time.monotonic() < deadline, door.pending_count()
        time.sleep(0.01)


def test_door_freezes_once_per_epoch_and_the_count_outlives_release():
    from horovod_tpu_torch.common.elastic import _ParoleDoor

    port = free_port()
    door = _ParoleDoor(port)
    a = _hello(port)
    try:
        # One at a time: each hello has its own handler thread, and the
        # release hands out assignments in the order they were held.
        _wait_pending(door, 1)
        b = _hello(port)
        _wait_pending(door, 2)
        assert door.freeze(5) == 2 and door.pending_count() == 0
        c = _hello(port)
        _wait_pending(door, 1)
        # Frozen once: a later knock does not change epoch 5's count, by
        # either route.
        assert door.freeze(5) == 2 and _poll(port, 5) == 2
        asg = [{"rank": 2, "size": 4}, {"rank": 3, "size": 4}]
        door.release(5, asg)
        got = [json.loads(s.makefile("r").readline()) for s in (a, b)]
        assert got == asg
        # Released, never popped: a survivor polling late reads the same.
        assert door.freeze(5) == 2 and _poll(port, 5) == 2
        door.release(5, asg)                 # a second release: a no-op
        assert door.freeze(6) == 1 and door.pending_count() == 0
        c.close()
        b.close()
    finally:
        a.close()
        door._sock.close()


def test_failed_poll_is_zero_with_a_warning(monkeypatch):
    from horovod_tpu_torch.common import elastic

    monkeypatch.setenv("HOROVOD_REJOIN_PORT", str(free_port()))
    monkeypatch.delenv("HOROVOD_RDZV_ADDR", raising=False)
    monkeypatch.setattr(elastic.basics, "rank", lambda: 1)
    with pytest.warns(RuntimeWarning, match="poll failed 3x"):
        assert elastic._freeze_joiners_inner(3) == 0


def test_shrink_of_an_improper_set_raises(monkeypatch):
    from horovod_tpu_torch.common import elastic

    monkeypatch.setattr(elastic.basics, "size", lambda: 3)
    monkeypatch.setattr(elastic.basics, "rank", lambda: 0)
    for victims in ({0, 1, 2}, {3}, {-1}, {0, 1, 2, 3}):
        with pytest.raises(ValueError, match="proper subset"):
            elastic.shrink(victims)


def test_rejoin_without_a_port_raises(monkeypatch):
    from horovod_tpu_torch.common import elastic

    monkeypatch.delenv("HOROVOD_REJOIN_PORT", raising=False)
    with pytest.raises(ValueError, match="HOROVOD_REJOIN_PORT"):
        elastic.rejoin()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert elastic._poll_rejoiners() == 0
