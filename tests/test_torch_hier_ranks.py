"""The port's hierarchical cross-plane allreduce on gloo, against the
reference lane (``HOROVOD_CROSS_PLANE``, ``csrc/ring_ops.cc:797``).

- 4 ranks as 2 slices x 2 (the layout env of
  ``tests/parallel/test_eager_ops.py:500-538``) under ``hier``: Sum,
  Average and Max at counts 1, 7 and 64 and a fused response, through
  the reference's eager ops in one world and the port in another.
  Integer-valued inputs are bit-equal to the reference and to the flat
  sum; float inputs within rtol 1e-6 (f32), as ROADMAP.md queue C allows
  on gloo. Each rank's ``wire`` and ``cross_*`` tx bytes of one
  allreduce equal ``horovod_tpu/telemetry/predict.py``'s
  ``hier_allreduce_wire_bytes`` (and ``flat_ring_wire_bytes`` under
  ``ring``).
- Modes, in the same 4 processes after the battery, each case a fresh
  ``init`` on a rendezvous of its own (``HOROVOD_CONTROLLER_PORT``), so
  that each runs the first open's probe: ``auto`` picks split 2 on its
  own, ``ring`` and ``ici`` pin 0, ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``
  means ``hier``, an unknown value means ``auto``; a heterogeneous
  layout (local sizes 2 and 3) disables the split on every rank with no
  deadlock and the warning on rank 0
  (``tests/parallel/test_eager_ops.py:546-571``); the knobs in
  ``hvd.metrics()``.
- Re-formation after a lost peer (``tests/parallel/test_elastic_ring.py:
  376-482``), in one world of 6 ranks (3 x 2): the whole slice {4, 5}
  is SIGKILLed (``set_fault_inject``) at the top of an allreduce, which
  the survivors fail in its cross hop; ``reinit`` over the 4 survivors
  keeps split 2 and exact sums. Then rank 3 of that 2 x 2 world dies
  the same way: rank 2 fails in its slice's reduce-scatter, rank 1 in
  the cross hop, rank 0 waits in the cross hop on rank 2; the 3
  survivors go flat with exact sums. Each survivor's failed lane thread
  ends once its peers have torn their lanes down (a lane left in a
  slice's or a cross group's collective is released by ``reinit``).
- A world grown by joiner slots is flat.
"""

import functools
import io
import os
import socket
import sys
import time

import numpy as np
import pytest

from tests.test_torch_elastic_ranks import run_chaos
from tests.utils_mp import run_ranks

COUNTS = (1, 7, 64)
WIRE_COUNT = 4096 + 37
TIMEOUT = 120


def _slice_env(rank, size, local):
    os.environ.update({
        "HOROVOD_LOCAL_RANK": str(rank % local),
        "HOROVOD_LOCAL_SIZE": str(local),
        "HOROVOD_CROSS_RANK": str(rank // local),
        "HOROVOD_CROSS_SIZE": str(size // local),
    })


class _Lane:
    """The reference's eager ops or the port's frontend, one face."""

    def __init__(self, impl):
        self.impl = impl
        if impl == "ref":
            from horovod_tpu.common import basics
            from horovod_tpu.common import eager_ops

            self.b = basics.HorovodBasics()
            self.b.init()
            self.ops = eager_ops
        else:
            import horovod_tpu_torch.torch as hvd

            hvd.init(device="cpu")
            self.hvd = hvd

    def start(self, x, name, op="Sum", pset=0):
        """``pset``: the port's process set id (the reference's lane
        runs the global set here)."""
        if self.impl == "ref":
            return self.ops.allreduce_async(
                x, name, op=getattr(self.ops.ReduceOp, op.upper()))
        import torch

        return self.hvd.allreduce_async(torch.from_numpy(x.copy()),
                                        name=name,
                                        op=getattr(self.hvd, op),
                                        process_set_id=pset)

    def wait(self, h):
        out = h.synchronize()
        return np.asarray(out) if self.impl == "ref" else out.numpy()

    def allreduce(self, x, name, op="Sum", pset=0):
        return self.wait(self.start(x, name, op, pset))

    def reducescatter(self, x, name, op="Sum", pset=0):
        if self.impl == "ref":
            h = self.ops.reducescatter_async(
                x, name, op=getattr(self.ops.ReduceOp, op.upper()))
            return np.asarray(h.synchronize())
        import torch

        return self.hvd.reducescatter(torch.from_numpy(x.copy()), name=name,
                                      op=getattr(self.hvd, op),
                                      process_set_id=pset).numpy()

    def set_codec(self, mode):
        (self.b if self.impl == "ref" else self.hvd).set_wire_codec(mode)

    def set_split(self, split):
        (self.b if self.impl == "ref" else self.hvd).set_hier_split(split)

    def wire(self):
        snap = self.b.metrics_snapshot() if self.impl == "ref" else \
            self.hvd.metrics()
        return snap["wire"]

    def split(self):
        return self.b.hier_split() if self.impl == "ref" else \
            self.hvd.hier_split()

    def close(self):
        (self.b if self.impl == "ref" else self.hvd).shutdown()


def _ints(n, rank, dtype):
    return ((np.arange(n) % 7 - 3) * (rank + 1)).astype(dtype)


def _floats(n, rank, seed):
    rng = np.random.default_rng([seed, rank])
    return rng.standard_normal(n).astype(np.float32)


def _battery(rank, size, impl, local=2):
    _slice_env(rank, size, local)
    lane = _Lane(impl)
    out = {"split": lane.split()}
    try:
        for n in COUNTS:
            for dt in ("float32", "float64"):
                for op in ("Sum", "Average", "Max"):
                    out[f"int.{dt}.{op}.{n}"] = lane.allreduce(
                        _ints(n, rank, dt), f"i.{dt}.{op}.{n}", op)
            out[f"float.Sum.{n}"] = lane.allreduce(
                _floats(n, rank, n), f"f.{n}")
        hs = [lane.start(np.full(6, float(rank + i), np.float32), f"fu.{i}")
              for i in range(3)]
        for i, h in enumerate(hs):
            out[f"fused.{i}"] = lane.wait(h)
        x = (np.arange(WIRE_COUNT, dtype=np.float32) % 7 - 3) * (rank + 1)
        lane.allreduce(x, "warm")
        before = lane.wire()
        out["wire.out"] = lane.allreduce(x, "wire")
        after = lane.wire()
        out["wire"] = {k: after[k] - before[k] for k in (
            "tx_bytes", "cross_tx_bytes", "rx_bytes", "cross_rx_bytes")}
        return out
    finally:
        lane.close()


# (the case's environment, its mode, its split)
MODE_CASES = [
    ({}, "auto", 2),
    ({"HOROVOD_CROSS_PLANE": "ring"}, "ring", 0),
    ({"HOROVOD_CROSS_PLANE": "ICI"}, "ici", 0),
    ({"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"}, "hier", 2),
    ({"HOROVOD_CROSS_PLANE": "bogus"}, "auto", 2),
]


def _free_ports(n):
    """``n`` distinct free ports (bound together, then released)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _reopen_at(port, env):
    """The next ``init`` rendezvouses on ``port`` under ``env``'s
    cross-plane settings."""
    os.environ["HOROVOD_CONTROLLER_PORT"] = str(port)
    for k in ("HOROVOD_CROSS_PLANE", "HOROVOD_HIERARCHICAL_ALLREDUCE"):
        os.environ.pop(k, None)
    os.environ.update(env)


def _modes_worker(rank, size, local=2):
    _slice_env(rank, size, local)
    err = io.StringIO()
    saved, sys.stderr = sys.stderr, err
    try:
        import horovod_tpu_torch.torch as hvd

        hvd.init(device="cpu")
    finally:
        sys.stderr = saved
    try:
        x = (np.arange(WIRE_COUNT, dtype=np.float32) % 5 - 2) * (rank + 1)
        import torch

        before = hvd.metrics()["wire"]
        out = hvd.allreduce(torch.from_numpy(x), name="m",
                            op=hvd.Sum).numpy()
        after = hvd.metrics()["wire"]
        want = (np.arange(WIRE_COUNT) % 5 - 2) * sum(
            range(1, size + 1))
        return dict(mode=hvd.cross_plane(), split=hvd.hier_split(),
                    exact=bool(np.array_equal(out, want)),
                    tx=after["tx_bytes"] - before["tx_bytes"],
                    cross_tx=after["cross_tx_bytes"]
                    - before["cross_tx_bytes"],
                    knobs=hvd.metrics()["knobs"], stderr=err.getvalue())
    finally:
        hvd.shutdown()


def _heterogeneous_worker(rank, size):
    # Ranks disagree on local_size (2 vs 3): the probe's MIN allreduce
    # disables the split everywhere.
    local = 2 if rank < 2 else 3
    os.environ.update({"HOROVOD_LOCAL_RANK": str(rank % local),
                       "HOROVOD_LOCAL_SIZE": str(local),
                       "HOROVOD_CROSS_RANK": str(rank // local),
                       "HOROVOD_CROSS_SIZE": "2"})
    return _modes_worker(rank, size, local=local)


def _port_world(rank, size, ports):
    """The battery under ``hier``, then each mode case and the
    heterogeneous layout, each on its own rendezvous."""
    out = {"battery": _battery(rank, size, "port"), "modes": []}
    for (env, _, _), port in zip(MODE_CASES, ports):
        _reopen_at(port, env)
        out["modes"].append(_modes_worker(rank, size))
    _reopen_at(ports[-1], {"HOROVOD_CROSS_PLANE": "hier"})
    out["heterogeneous"] = _heterogeneous_worker(rank, size)
    return out


@pytest.fixture(scope="module")
def hier_worlds():
    env = {"HOROVOD_CROSS_PLANE": "hier"}
    ref = run_ranks(functools.partial(_battery, impl="ref"), 4,
                    timeout=TIMEOUT, env=env)
    port = run_ranks(functools.partial(
        _port_world, ports=_free_ports(len(MODE_CASES) + 1)), 4,
        timeout=TIMEOUT, env=env)
    return ref, port


def _want_int(key, size):
    _, dt, op, n = key.split(".")
    xs = [_ints(int(n), r, dt) for r in range(size)]
    if op == "Max":
        return np.max(xs, axis=0)
    total = np.sum(xs, axis=0)
    return total / size if op == "Average" else total


def test_hier_matches_the_reference_lane(hier_worlds):
    ref, port = hier_worlds
    for rank in range(4):
        r, p = ref[rank], port[rank]["battery"]
        assert r["split"] == p["split"] == 2
        for key in r:
            if key.startswith("int."):
                want = _want_int(key, 4).astype(r[key].dtype)
                np.testing.assert_array_equal(p[key], r[key], err_msg=key)
                np.testing.assert_array_equal(p[key], want, err_msg=key)
            elif key.startswith("float."):
                np.testing.assert_allclose(p[key], r[key], rtol=1e-6,
                                           atol=1e-7, err_msg=key)
                want = np.sum([_floats(p[key].size, q, p[key].size)
                               for q in range(4)], axis=0)
                np.testing.assert_allclose(p[key], want, rtol=1e-6,
                                           atol=1e-6)
            elif key.startswith("fused."):
                i = int(key.split(".")[1])
                np.testing.assert_array_equal(p[key], r[key])
                np.testing.assert_array_equal(p[key], 6.0 + 4 * i)


def test_hier_wire_bytes_match_the_predictor(hier_worlds):
    from horovod_tpu.telemetry.predict import hier_allreduce_wire_bytes

    ref, port = hier_worlds
    for rank in range(4):
        pred = hier_allreduce_wire_bytes(WIRE_COUNT, 4, 4, 2, rank)
        got, theirs = port[rank]["battery"]["wire"], ref[rank]["wire"]
        assert got["cross_tx_bytes"] == pred["cross"] == \
            theirs["cross_tx_bytes"]
        assert got["tx_bytes"] == pred["cross"] + pred["intra"] == \
            theirs["tx_bytes"]
        np.testing.assert_array_equal(port[rank]["battery"]["wire.out"],
                                      ref[rank]["wire.out"])


# ---- modes ------------------------------------------------------------------


@pytest.mark.parametrize("env,mode,split", MODE_CASES)
def test_modes_pick_the_split(hier_worlds, env, mode, split):
    from horovod_tpu.telemetry.predict import flat_ring_wire_bytes

    case = MODE_CASES.index((env, mode, split))
    got = [p["modes"][case] for p in hier_worlds[1]]
    for rank, g in enumerate(got):
        assert (g["mode"], g["split"], g["exact"]) == (mode, split, True)
        assert g["knobs"]["cross_plane"] == mode
        assert g["knobs"]["hier_split"] == split
        assert g["knobs"]["wire_codec"] == "off"
        if split == 0:
            assert g["cross_tx"] == 0
            assert g["tx"] == flat_ring_wire_bytes(WIRE_COUNT, 4, 4, rank)
        else:
            assert g["cross_tx"] > 0
    warned = "ignoring unknown HOROVOD_CROSS_PLANE=bogus" in got[0]["stderr"]
    assert warned == (env.get("HOROVOD_CROSS_PLANE") == "bogus")


def test_heterogeneous_layout_runs_flat_and_warns(hier_worlds):
    got = [p["heterogeneous"] for p in hier_worlds[1]]
    assert [(g["split"], g["exact"]) for g in got] == [(0, True)] * 4
    assert "HOROVOD_CROSS_PLANE=hier disabled" in got[0]["stderr"]
    assert "local sizes mixed" in got[0]["stderr"]
    assert all("disabled" not in g["stderr"] for g in got[1:])


# ---- re-formation after a lost peer -----------------------------------------

# (victims, survivors, the op at which the victims die): two warm-ups
# are ops 0-1 of epoch 0; epoch 1's "reformed" allreduce is its op 0.
_FAULT_STAGES = (({4, 5}, [0, 1, 2, 3], 2), ({3}, [0, 1, 2], 1))


def _fault_worker(rank, size):
    _slice_env(rank, size, 2)
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import HorovodPeerFailureError

    hvd.init(device="cpu")
    x = torch.from_numpy((np.arange(512, dtype=np.float32) % 5) - 2)
    out = {"before": hvd.hier_split()}
    for i in range(2):
        hvd.allreduce(x * (rank + 1), name=f"warm.{i}", op=hvd.Sum)
    try:
        for epoch, (victims, survivors, op) in enumerate(_FAULT_STAGES,
                                                         1):
            if hvd.rank() in victims:
                basics.set_fault_inject(hvd.rank(), op)
            failed = basics.lane()
            try:
                hvd.allreduce(x, name=f"boom.{epoch}", op=hvd.Sum)
                return f"boom.{epoch} did not fail"
            except HorovodPeerFailureError as e:
                dead = sorted(e.fault_ranks)
            basics.reinit(survivors, epoch)
            deadline = time.monotonic() + 30
            while failed._thread.is_alive() and time.monotonic() < deadline:
                time.sleep(0.05)
            w0 = hvd.metrics()["wire"]["cross_tx_bytes"]
            got = hvd.allreduce(x * (hvd.rank() + 1), name=f"reformed.{epoch}",
                                op=hvd.Sum).numpy()
            out[epoch] = dict(
                dead=dead, failed_lane_ended=not failed._thread.is_alive(),
                split=hvd.hier_split(),
                layout=(hvd.size(), hvd.local_size(), hvd.local_rank(),
                        hvd.cross_size(), hvd.cross_rank()),
                exact=bool(np.array_equal(
                    got, x.numpy() * sum(range(1, hvd.size() + 1)))),
                cross=hvd.metrics()["wire"]["cross_tx_bytes"] - w0)
        return out
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def fault_world():
    got, _ = run_chaos(_fault_worker, 6, victims={3, 4, 5}, timeout=TIMEOUT,
                       env={"HOROVOD_CROSS_PLANE": "hier"})
    assert sorted(got) == [0, 1, 2]
    return got


def test_losing_a_whole_slice_keeps_the_split(fault_world):
    for rank, g in fault_world.items():
        assert g["before"] == 2
        s = g[1]
        assert s["dead"] == [4, 5]
        assert (s["split"], s["exact"], s["failed_lane_ended"]) == \
            (2, True, True)
        assert s["layout"] == (4, 2, rank % 2, 2, rank // 2)
        assert s["cross"] > 0


def test_losing_one_rank_goes_flat(fault_world):
    for rank, g in fault_world.items():
        s = g[2]
        assert s["dead"] == [3]
        assert (s["split"], s["exact"], s["failed_lane_ended"]) == \
            (0, True, True)
        assert s["layout"] == (3, 3, rank, 1, 0)
        assert s["cross"] == 0


def _grow_worker(rank, size):
    import torch

    from horovod_tpu_torch.common import basics

    import horovod_tpu_torch.torch as hvd

    if rank < 4:
        os.environ["HOROVOD_SIZE"] = "4"
        _slice_env(rank, 4, 2)
        hvd.init(device="cpu")
        before = hvd.hier_split()
        hvd.allreduce(torch.ones(8), name="warm", op=hvd.Sum)
        basics.reinit([0, 1, 2, 3, -1, -1], 1)
    else:
        # A joiner opens straight into the grown world at its epoch.
        hvd.init(device="cpu", epoch=1)
        before = None
    try:
        out = hvd.allreduce(torch.full((9,), float(hvd.rank())),
                            name="grown", op=hvd.Sum).numpy()
        return dict(before=before, split=hvd.hier_split(),
                    layout=(hvd.size(), hvd.local_size()),
                    exact=bool(np.array_equal(out, np.full(9, 15.0))))
    finally:
        hvd.shutdown()


def test_a_grown_world_is_flat():
    got = run_ranks(_grow_worker, 6, timeout=TIMEOUT,
                    env={"HOROVOD_CROSS_PLANE": "hier"})
    assert [g["before"] for g in got] == [2] * 4 + [None] * 2
    assert all((g["split"], g["layout"], g["exact"]) == (0, (6, 6), True)
               for g in got)
