"""The port's elastic states, loop and fault trigger at world size 1,
against the reference's.

- ``ObjectState`` and ``TorchState`` (a model and Adam) commit and
  restore as the reference's on the same values, bit for bit; a
  restore never aliases the snapshot (Adam's step counts included);
  ``TreeState`` against ``JaxState`` on the same numpy trees, each
  tensor back on its device in its dtype.
- ``checkpoint_dir`` and ``resume()``: step numbers continue across a
  second state on the same directory, ``max_to_keep`` holds, as
  ``JaxState`` over orbax does.
- ``run_fn``'s loop, the port's and the reference's on the same
  function (one spawned world of one with both lanes open): a raised
  ``HorovodInternalError``, one raised ``from`` it, an implicit
  ``__context__`` (not recovered) and ``HostsUpdatedInterrupt(
  skip_sync=True)``; every reset bumps the port's epoch, and the
  auto-namer restarts at 0 after it, as the reference's.
- ``HOROVOD_FAULT_INJECT`` parses as the core's ``ParseFaultSpec`` on
  the reference's corpus (malformed specs stay disarmed; ``stop``,
  ``reset`` and ``flip`` raise naming L8); ``kill`` at op 3 leaves 3
  completed ops on both lanes, ``delay`` stalls its op.
- ``hvd.elastic.rejoin`` without a door's port raises ``ValueError``,
  as the reference's does.
"""

import copy
import ctypes
import multiprocessing as mp
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from tests.single.test_analysis_model import _INVALID, _VALID
from tests.test_torch_mp import REPO_ROOT, lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jnp = lazy_module("jax.numpy")


# ---- states --------------------------------------------------------------


def _object_sequence(cls):
    s = cls(step=0, params=np.zeros(3, np.float32), meta={"tags": ["a"]})
    s.step, s.params = 1, s.params + 1
    s.meta["tags"].append("b")
    s.commit()
    s.step, s.params = 2, s.params + 1
    s.meta["tags"].append("c")
    s.restore()
    s.meta["tags"].append("d")        # a restored copy, not the snapshot
    s.restore()
    return s.step, s.params, s.meta


def test_object_state_matches_reference():
    from horovod_tpu.common.elastic import ObjectState as RefObjectState
    from horovod_tpu_torch.common.elastic import ObjectState

    got, want = _object_sequence(ObjectState), _object_sequence(
        RefObjectState)
    assert got[0] == want[0] == 1
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == {"tags": ["a", "b"]}


def _adam_sequence(cls):
    torch.manual_seed(3)
    model = torch.nn.Linear(5, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    x = torch.randn(16, 5)

    def step():
        opt.zero_grad()
        (model(x) ** 2).mean().backward()
        opt.step()

    state = cls(model=model, optimizer=opt, epoch=0)
    step()
    state.epoch = 1
    state.commit()
    committed = copy.deepcopy((model.state_dict(), opt.state_dict()))
    step()
    step()
    state.epoch = 5
    state.restore()
    step()                  # must not move the snapshot (Adam's step)
    state.restore()
    return model.state_dict(), opt.state_dict(), state.epoch, committed


def test_torch_state_matches_reference():
    from horovod_tpu.torch.elastic import TorchState as RefTorchState
    from horovod_tpu_torch.torch.elastic import TorchState

    (m, o, e, committed), (rm, ro, re_, _) = (_adam_sequence(TorchState),
                                              _adam_sequence(RefTorchState))
    assert e == re_ == 1
    for k in m:
        assert torch.equal(m[k], rm[k]) and torch.equal(m[k],
                                                        committed[0][k])
    for pid, st in o["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ro["state"][pid][k]), (pid, k)
            assert torch.equal(v, committed[1]["state"][pid][k]), (pid, k)
    assert o["param_groups"] == ro["param_groups"]


_TREE = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                    "layers": [np.ones(4, np.float32),
                               np.full(2, 7, np.int32)]},
         "count": np.int64(0)}


def test_tree_state_matches_jax_state():
    from horovod_tpu.jax.elastic import JaxState
    from horovod_tpu_torch.torch.elastic import TreeState

    def as_torch(x):
        return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) \
            else x

    tree = {"params": {"w": as_torch(_TREE["params"]["w"]),
                       "layers": [as_torch(a) for a in
                                  _TREE["params"]["layers"]]},
            "count": 0}
    port = TreeState(carry=tree, step=0)
    ref = JaxState(carry=copy.deepcopy(_TREE), step=0)
    for s in (port, ref):
        s.carry = {"params": {"w": s.carry["params"]["w"] * 2,
                              "layers": [a + 1 for a in
                                         s.carry["params"]["layers"]]},
                   "count": 1}
        s.step = 1
        s.commit()
        s.carry = {"params": {"w": s.carry["params"]["w"] * 0,
                              "layers": s.carry["params"]["layers"]},
                   "count": 9}
        s.step = 2
        s.restore()
    got, want = port.carry, ref.carry
    assert port.step == ref.step == 1 and got["count"] == want["count"] == 1
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(want["params"]["w"]))
    for g, w, orig in zip(got["params"]["layers"], want["params"]["layers"],
                          _TREE["params"]["layers"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.from_numpy(orig).dtype
        assert g.device == torch.device("cpu")
    # The restored tensors are copies: writing them leaves the snapshot.
    got["params"]["w"].add_(100)
    port.restore()
    np.testing.assert_array_equal(port.carry["params"]["w"].numpy(),
                                  np.asarray(want["params"]["w"]))


def test_checkpoint_dir_resume_continues_numbering(tmp_path):
    from horovod_tpu.jax.elastic import JaxState
    from horovod_tpu_torch.torch.elastic import TorchState, TreeState

    def run(cls, root, value):
        s1 = cls(checkpoint_dir=root, v=value(0.0))
        for i in range(1, 5):
            s1.v = value(float(i))
            s1.commit()
        s1._ckpt_mgr.wait()
        s2 = cls(checkpoint_dir=root, v=value(0.0))
        s2.v = value(10.0)
        s2.commit()           # step 5, not a skipped step 1
        s2._ckpt_mgr.wait()
        s3 = cls(checkpoint_dir=root, v=value(-1.0))
        return s3.resume(), float(np.asarray(s3.v)), s3

    got = run(TreeState, tmp_path / "port", lambda x: torch.tensor(x))
    want = run(JaxState, tmp_path / "ref", lambda x: jnp.asarray(x))
    assert got[:2] == want[:2] == (5, 10.0)
    assert got[2]._ckpt_mgr.all_steps() == [3, 4, 5] == sorted(
        int(p) for p in os.listdir(tmp_path / "ref") if p.isdigit())
    # TorchState: the model and the extras come back from disk.
    model = torch.nn.Linear(2, 1)
    s = TorchState(model=model, checkpoint_dir=tmp_path / "torch", step=3)
    s.commit()
    fresh = torch.nn.Linear(2, 1)
    s2 = TorchState(model=fresh, checkpoint_dir=tmp_path / "torch", step=0)
    assert s2.resume() == 1 and s2.step == 3
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


def test_rejoin_and_the_trigger_before_init(monkeypatch):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu.common import elastic as ref_elastic
    from horovod_tpu_torch.common import basics

    monkeypatch.delenv("HOROVOD_REJOIN_PORT", raising=False)
    with pytest.raises(ValueError, match="HOROVOD_REJOIN_PORT"):
        ref_elastic.rejoin()
    with pytest.raises(ValueError, match="HOROVOD_REJOIN_PORT"):
        hvd.elastic.rejoin()
    assert hvd.elastic.survivors() is None
    with pytest.raises(RuntimeError, match="requires hvd.init"):
        basics.set_fault_inject(0, 1)


# ---- HOROVOD_FAULT_INJECT's grammar --------------------------------------


def test_fault_spec_parses_as_the_core():
    from horovod_tpu.common import basics
    from horovod_tpu_torch.common.operations import parse_fault_spec

    lib = basics.HorovodBasics().lib
    try:
        for spec in _VALID + _INVALID:
            if "9223372036854775808" in spec:
                continue     # C clamps the overflow; the twins reject it
            rc = lib.hvdtpu_set_fault_inject_spec(spec.encode())
            action = spec.split(":")[2] if spec.count(":") >= 2 else "kill"
            if rc == -2:
                assert parse_fault_spec(spec) is None, spec
            elif action in ("stop", "reset", "flip"):
                with pytest.raises(ValueError, match="L8"):
                    parse_fault_spec(spec)
            else:
                rank, op = (int(p) for p in spec.split(":")[:2])
                assert parse_fault_spec(spec)[:3] == (rank, op, action), spec
    finally:
        lib.hvdtpu_set_fault_inject_spec(ctypes.c_char_p(b""))
    assert parse_fault_spec("1:4:delay:25") == (1, 4, "delay", 25)
    assert parse_fault_spec("9223372036854775808:3") is None


# ---- the loop, the namer and the trigger in a world of one --------------


class _Logged:
    """A state that logs the loop's calls (the same on both lanes)."""

    def __init__(self, base):
        self.log = []
        self.base = base

    def sync(self):
        self.log.append("sync")

    def restore(self):
        self.log.append("restore")

    def on_reset(self):
        self.log.append("on_reset")


def _scenarios(elastic, internal_error, hosts_updated, epoch):
    """Each scenario's log under ``elastic.run_fn``."""
    out = {}

    def run(name, first):
        state = _Logged(None)
        calls = []

        @elastic.run_fn
        def train(state):
            calls.append(len(calls))
            state.log.append(f"run@{epoch()}")
            if len(calls) == 1:
                first()
            return "done"

        try:
            result = train(state)
        except Exception as e:  # noqa: BLE001 — recorded
            result = f"raised {type(e).__name__}"
        out[name] = (result, state.log)

    def direct():
        raise internal_error("lost")

    def chained():
        raise RuntimeError("wrapped") from internal_error("lost")

    def implicit():
        try:
            raise internal_error("lost")
        except internal_error:
            raise RuntimeError("aborting")  # noqa: B904 — the point

    def interrupted():
        raise hosts_updated(skip_sync=True)

    for name, fn in (("direct", direct), ("chained", chained),
                     ("implicit", implicit), ("interrupt", interrupted)):
        run(name, fn)
    return out


def _battery(rank, size):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu.common import elastic as ref_elastic
    from horovod_tpu.common.basics import HorovodBasics
    from horovod_tpu.common.exceptions import (
        HorovodInternalError as RefInternal,
        HostsUpdatedInterrupt as RefInterrupt,
    )
    from horovod_tpu.torch import mpi_ops as ref_ops
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import elastic as port_elastic
    from horovod_tpu_torch.torch import mpi_ops

    out = {}
    hvd.init(device="cpu")
    ref_elastic.init()
    ref_basics = HorovodBasics()
    out["port"] = _scenarios(port_elastic, hvd.HorovodInternalError,
                             hvd.HostsUpdatedInterrupt, basics.epoch)
    out["ref"] = _scenarios(ref_elastic, RefInternal, RefInterrupt,
                            ref_basics.epoch)
    out["port_epoch"] = basics.epoch()
    out["resets"] = hvd.metrics()["elastic"]["resets"]
    names = {}
    for impl, namer, reset in (("port", mpi_ops._auto_name,
                                port_elastic.reset),
                               ("ref", ref_ops._auto_name,
                                ref_elastic.reset)):
        names[impl] = [namer("allreduce"), namer("allreduce")]
        reset()
        names[impl] += [namer("allreduce"), namer("broadcast")]
    out["names"] = names
    out["ops_after_resets"] = hvd.allreduce(torch.ones(3), name="after",
                                            op=hvd.Sum).tolist()
    out["device_after_resets"] = basics.device()
    # The trigger: armed and disarmed by hand; the env path on each init.
    basics.set_fault_inject(0, 10 ** 6)
    out["armed"] = basics.lane().fault_inject
    basics.set_fault_inject(-1, 0)
    out["disarmed"] = basics.lane().fault_inject
    try:
        basics.set_fault_inject_spec("0:1:kill:1")
    except ValueError as e:
        out["malformed"] = str(e)
    hvd.shutdown()
    env = {}
    for spec in ("0:0:kill:1", "0:1:stop:40", "0:1:delay:1000"):
        os.environ["HOROVOD_FAULT_INJECT"] = spec
        try:
            hvd.init(device="cpu")
        except ValueError as e:
            env[spec] = f"ValueError: {e}"
            continue
        times = []
        for i in range(3):
            t0 = time.monotonic()
            hvd.allreduce(torch.ones(2), name=f"{spec}.{i}")
            times.append(time.monotonic() - t0)
        env[spec] = (basics.lane().fault_inject, times)
        hvd.shutdown()
    os.environ.pop("HOROVOD_FAULT_INJECT")
    out["env"] = env
    # No device means the card, whatever an earlier init asked for.
    hvd.init(device="cpu")
    hvd.shutdown()
    try:
        hvd.init()
        out["bare_init"] = str(basics.device())
        hvd.shutdown()
    except RuntimeError as e:
        out["bare_init"] = f"RuntimeError: {e}"
    ref_basics.shutdown()
    return out


@pytest.fixture(scope="module")
def battery():
    return run_ranks(_battery, 1, timeout=180)[0]


def test_run_fn_matches_reference(battery):
    port, ref = battery["port"], battery["ref"]
    assert port.keys() == ref.keys()
    for name in port:
        # The epochs differ in number (the reference re-inits at 0), not
        # in the loop's calls.
        strip = [(r, [e.split("@")[0] for e in log])
                 for r, log in (port[name], ref[name])]
        assert strip[0] == strip[1], (name, port[name], ref[name])
    assert port["direct"] == ("done", ["sync", "run@0", "restore",
                                       "on_reset", "sync", "run@1"])
    assert port["chained"][0] == "done"
    assert port["implicit"] == ("raised RuntimeError", ["sync", "run@2"])
    # skip_sync: no restore, no sync before the second run.
    assert port["interrupt"] == ("done", ["sync", "run@2", "on_reset",
                                          "run@3"])
    assert battery["port_epoch"] == 3 and battery["resets"] == 3
    assert battery["ops_after_resets"] == [1.0, 1.0, 1.0]


def test_reset_keeps_the_lane_device_and_bare_init_means_the_card(battery):
    # Three resets of a CPU lane re-open it on the CPU.
    assert battery["device_after_resets"] is None
    if torch.cuda.is_available():
        assert battery["bare_init"].startswith("cuda")
    else:
        assert battery["bare_init"].startswith("RuntimeError") and \
            "no CUDA device" in battery["bare_init"]


def test_auto_namer_restarts_at_zero_after_reset(battery):
    names = battery["names"]
    assert names["port"] == names["ref"] == [
        "allreduce.noname.0", "allreduce.noname.1", "allreduce.noname.0",
        "broadcast.noname.0"]


def test_fault_inject_arming_and_env(battery):
    assert battery["armed"] == (0, 10 ** 6, "kill", 0)
    assert battery["disarmed"] is None
    assert "malformed" in battery["malformed"]
    env = battery["env"]
    inject, times = env["0:0:kill:1"]          # malformed: disarmed
    assert inject is None and max(times) < 1.0
    assert env["0:1:stop:40"].startswith("ValueError") and \
        "L8" in env["0:1:stop:40"]
    inject, times = env["0:1:delay:1000"]      # one-shot, then disarmed
    assert inject is None and times[1] >= 1.0 > max(times[0], times[2])


def _kill_worker(impl, q):
    # A world of one, whatever layout the spawning process's environment
    # holds (another test in the same pytest worker may have left one).
    os.environ.update({"HOROVOD_FAULT_INJECT": "0:3", "JAX_PLATFORMS": "cpu",
                       "HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
                       "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
                       "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1"})
    for k in ("HOROVOD_REJOIN_PORT", "HOROVOD_RDZV_ADDR"):
        os.environ.pop(k, None)
    sys.path.insert(0, REPO_ROOT)
    if impl == "port":
        import horovod_tpu_torch.torch as hvd

        hvd.init(device="cpu")

        def op(i):
            hvd.allreduce(torch.ones(2), name=f"op.{i}")
    else:
        from horovod_tpu.common import basics, eager_ops

        basics.HorovodBasics().init()

        def op(i):
            eager_ops.allreduce_async(np.ones(2, np.float32),
                                      f"op.{i}").synchronize()
    for i in range(6):
        op(i)
        q.send(i)     # a pipe: written before the next op, unbuffered


def test_kill_fires_at_the_same_op_as_the_core():
    ctx = mp.get_context("spawn")
    done = {}
    for impl in ("port", "ref"):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_kill_worker, args=(impl, send))
        p.start()
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
        assert p.exitcode == -signal.SIGKILL, (impl, p.exitcode)
        done[impl] = []
        while recv.poll():
            done[impl].append(recv.recv())
    assert done["port"] == done["ref"] == [0, 1, 2]
