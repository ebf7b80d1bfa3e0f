"""``HOROVOD_AUTOTUNE=1`` on the port's lane at 2 spawned gloo ranks: the
port of ``tests/parallel/test_eager_ops.py:344 test_autotune``, with
small windows (``HOROVOD_AUTOTUNE_STEPS=4``, ``_WINDOW_CYCLES=2``,
``_WINDOW_BYTES=1``).

- 30 allreduces (the reference's), then fused sets of three, stay exact
  while the tuner walks the grid, until rank 0's tuner has converged;
- every rank runs each response with rank 0's knobs (fusion threshold,
  cycle time, and the data plane's fusion buffer threshold) in effect,
  response by response, and ends on the same knobs;
- ``knob_adopt`` events on both ranks, the log's header the reference's
  and its last row the converged point, equal to ``hvd.metrics()
  ["knobs"]``;
- after ``reinit`` the tuner starts again: a fresh log, no samples;
- at 4 ranks as 2 x 2 slices with ``HOROVOD_WIRE_COMPRESSION=bf16``, the
  tuner's grid holds the codec {off, bf16} and the split {flat, 2}; its
  moves (scripted on rank 0 through its ``update``) ride the response
  lists, and every rank runs each response with the same split and
  codec, adopting a move in the same cycle, with ``knob_adopt`` events 3
  and 4 on the workers; sums of integers (exact in bf16) stay exact.
"""

import os

import numpy as np
import torch

from horovod_tpu_torch.common import parameter_manager as pmod
from tests.test_torch_mp import run_ranks

STEPS = 4


def _worker(rank, size):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu")
    rt = basics.lane()
    seen = []
    execute = rt.data_plane.execute

    def recording(res, entries, pset):
        seen.append((tuple(res.tensor_names), rt.fusion_threshold,
                     rt.cycle_time_ms, rt.data_plane.fusion_threshold))
        return execute(res, entries, pset)

    rt.data_plane.execute = recording
    try:
        for i in range(30):
            out = hvd.allreduce(torch.full((1024,), float(rank + i)),
                                name=f"at.{i}", op=hvd.Sum)
            assert torch.equal(out, torch.full((1024,), float(
                sum(r + i for r in range(size)))))
        # Sets of three 1 MiB tensors: their fusion follows the knob.
        for i in range(200):
            xs = [torch.full((1 << 18,), float(rank + i + k))
                  for k in range(3)]
            hs = [hvd.allreduce_async(x, name=f"set.{i}.{k}", op=hvd.Sum)
                  for k, x in enumerate(xs)]
            for k, h in enumerate(hs):
                assert torch.equal(h.synchronize(), torch.full(
                    (1 << 18,), float(sum(r + i + k for r in range(size)))))
            pm = rt.param_manager
            done = torch.tensor([int(pm is not None and pm.done)])
            if int(hvd.allreduce(done, name=f"done.{i}", op=hvd.Max)):
                break
        hvd.barrier()
        out = dict(seen=seen, knobs=hvd.metrics()["knobs"],
                   adopted=[e for e in hvd.events()
                            if e["type"] == "knob_adopt"],
                   worker_pm=rt.param_manager is None)
        rt.data_plane.execute = execute
        log = os.environ["HOROVOD_AUTOTUNE_LOG"]
        if rank == 0:
            with open(log) as f:
                out["log"] = f.read()
            out["samples"] = rt.param_manager._opt.num_samples
        basics.reinit([0, 1], basics.epoch() + 1)
        if rank == 0:
            with open(log) as f:
                out["log_after"] = f.read()
            pm = basics.lane().param_manager
            out["after"] = (pm.done, pm._opt.num_samples, pm.candidate)
        out["knobs_after"] = hvd.metrics()["knobs"]
        hvd.allreduce(torch.ones(4), name="after", op=hvd.Sum)
        return out
    finally:
        hvd.shutdown()


def test_autotune_at_two_ranks(tmp_path):
    log = str(tmp_path / "autotune.csv")
    got = run_ranks(_worker, 2, timeout=240, env={
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": log,
        "HOROVOD_AUTOTUNE_STEPS": str(STEPS),
        "HOROVOD_AUTOTUNE_WINDOW_CYCLES": "2",
        "HOROVOD_AUTOTUNE_WINDOW_BYTES": "1"})
    r0, r1 = got
    # The coordinator tunes; the worker builds no tuner.
    assert not r0["worker_pm"] and r1["worker_pm"]
    # Both ran the same responses, each under the same knobs.
    assert [s[0] for s in r0["seen"]] == [s[0] for s in r1["seen"]]
    assert r0["seen"] == r1["seen"]
    for _, fusion, _, buffer in r0["seen"]:
        assert fusion == buffer
    assert len({(s[1], s[2]) for s in r0["seen"]}) > 1, "the knobs never moved"
    assert r0["knobs"] == r1["knobs"]
    # Each rank recorded its moves: rank 0 when it tuned, rank 1 when it
    # adopted; the same values in the same order.
    assert r0["adopted"] and [(e["knob"], e["value"]) for e in r0["adopted"]] \
        == [(e["knob"], e["value"]) for e in r1["adopted"]]
    # The log: the reference's header, STEPS scored rows, then the
    # converged point, which is the live knobs.
    lines = r0["log"].splitlines(keepends=True)
    assert lines[0] == pmod.HEADER
    rows = [line.rstrip("\n").split(",") for line in lines[1:]]
    assert len(rows) == STEPS + 1 and r0["samples"] == STEPS
    assert all(len(r) == 7 and r[2:6] == ["0", "0", "0", "1"] for r in rows)
    assert int(rows[-1][0]) == r0["knobs"]["fusion_threshold_bytes"]
    assert float(rows[-1][1]) == r0["knobs"]["cycle_time_ms"]
    # reinit built a fresh tuner: a new log, no samples, at the knobs the
    # environment gives (64 MiB, 1 ms).
    assert r0["log_after"] == pmod.HEADER
    assert r0["after"] == (False, 0, 31)
    assert r0["knobs_after"] == r1["knobs_after"] == {
        "fusion_threshold_bytes": 64 << 20, "cycle_time_ms": 1.0,
        "wire_compression": False, "wire_codec": "off",
        "cross_plane": "auto", "hier_split": 0, "cross_compression": False}


def test_untuned_lane_carries_no_knobs():
    from horovod_tpu_torch.common.controller import Controller
    from horovod_tpu_torch.common.message import ResponseList
    from horovod_tpu_torch.common.response_cache import ResponseCache

    ctl = Controller(2, 64 << 20, lambda ps: [0, 1], ResponseCache(0))
    assert (ctl.bcast_fusion_bytes, ctl.bcast_cycle_ms) == (0, 0.0)
    assert ResponseList().fusion_threshold_bytes == 0
    ctl.set_autotuned_params(4 << 20, 2.5)
    assert ctl.fusion_threshold == ctl.bcast_fusion_bytes == 4 << 20
    assert ctl.bcast_cycle_ms == 2.5


# Candidates of the 64 MiB, 1 ms point: (codec index, split index) of
# ``((6 * 5 + 1) * 2 + codec_i) * 2 + split_i``.
SCRIPT = [(1, 0), (0, 1), (1, 1), (0, 0), (1, 1)]


def _lockstep_worker(rank, size):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    os.environ.update({"HOROVOD_LOCAL_RANK": str(rank % 2),
                       "HOROVOD_LOCAL_SIZE": "2",
                       "HOROVOD_CROSS_RANK": str(rank // 2),
                       "HOROVOD_CROSS_SIZE": "2"})
    hvd.init(device="cpu")
    rt = basics.lane()
    plane = rt.data_plane
    seen = []
    execute = plane.execute

    def recording(res, entries, pset):
        seen.append((tuple(res.tensor_names), plane.hier_split,
                     plane.wire_codec))
        return execute(res, entries, pset)

    plane.execute = recording
    out = {}
    if rank == 0:
        pm = rt.param_manager
        out["grid"] = (pm.comp_values, pm.hier_values, len(pm.candidates))
        moves, cycles = iter(SCRIPT), [0]

        def update(nbytes):
            cycles[0] += 1
            if cycles[0] % 4:
                return False
            move = next(moves, None)
            if move is None:
                return False
            pm.move_to(((6 * 5 + 1) * 2 + move[0]) * 2 + move[1])
            return True
        pm.update = update
    try:
        exact = True
        for i in range(60):
            x = torch.from_numpy(((np.arange(1000) % 9) - 4).astype(
                np.float32) * (rank + 1 + i % 3))
            got = hvd.allreduce(x, name=f"ls.{i}", op=hvd.Sum)
            want = ((np.arange(1000) % 9) - 4) * sum(
                r + 1 + i % 3 for r in range(size))
            exact = exact and bool(np.array_equal(got.numpy(), want))
        hvd.barrier()
        plane.execute = execute
        out.update(seen=seen, exact=exact, adopted=[
            (e["knob"], e["value"]) for e in hvd.events()
            if e["type"] == "knob_adopt"])
        return out
    finally:
        hvd.shutdown()


def test_workers_adopt_the_split_and_codec_in_the_same_cycle():
    got = run_ranks(_lockstep_worker, 4, timeout=240, env={
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_WIRE_COMPRESSION": "bf16",
        "HOROVOD_AUTOTUNE_STEPS": "20"})
    assert got[0]["grid"] == ((0, 1), (0, 2), 140)
    assert all(g["exact"] for g in got)
    for g in got[1:]:
        assert g["seen"] == got[0]["seen"]
    knobs = {(split, codec) for _, split, codec in got[0]["seen"]}
    assert knobs == {(0, 0), (0, 1), (2, 0), (2, 1)}
    for g in got[1:]:
        assert {k for k, _ in g["adopted"]} == {3, 4}
        assert [a for a in g["adopted"] if a[0] in (3, 4)] == \
            [a for a in got[0]["adopted"] if a[0] in (3, 4)]
