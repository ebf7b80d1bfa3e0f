"""The port's Horovod eager lane against the reference, op by op.

The same seeded numpy inputs run through the reference
``horovod_tpu.torch`` (its C++ core's host lane) in one spawned world
and through ``horovod_tpu_torch.torch`` (``init(device="cpu")``: gloo)
in another; each rank's results are compared here. Tolerances: at 2
ranks f32 Sum, Min and Max match bit for bit (one commutative operation
per element), as every integer result does; everything else is held to
rtol 1e-6, atol 1e-7 in f32/f64 and rtol 1e-2 in f16/bf16 (the lanes
sum in different orders at 3+ ranks, and a lone bf16 allreduce folds
its prescale into the post scale, so whether it fused changes its
rounding). Mismatched collectives must fail on every rank with the
reference's message.

Every op of the frontend runs at 2 ranks in every dtype the reference
takes (Sum, Average, Min, Max, Product; prescale and postscale; in
place and out of place; uneven allgather, alltoall with splits,
reducescatter with uneven rows; grouped; enqueued in different orders
on different ranks; process sets; join; barrier; Adasum), again with
``HOROVOD_FUSION_THRESHOLD=256``, and at 3 ranks; Adasum also at 4.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_mp import run_ranks

DTYPES = ("float32", "float64", "float16", "bfloat16", "int32", "int64",
          "uint8", "int8", "bool")
FLOATS = ("float32", "float64", "float16", "bfloat16")
OPS = ("Sum", "Average", "Min", "Max", "Product")


def _input(dtype, shape, seed, rank):
    rng = np.random.default_rng(seed * 7919 + rank)
    if dtype == "bool":
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if dtype.startswith(("int", "uint")):
        lo = 0 if dtype == "uint8" else -3
        return torch.from_numpy(rng.integers(lo, 4, shape).astype(dtype))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(getattr(torch, dtype))


def _keep(t):
    """A result tensor as {"dtype": name, "array": numpy}; bf16 as its
    bits."""
    t = t.detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return {"dtype": name, "array": t.numpy().copy()}


def _open(impl):
    if impl == "ref":
        import horovod_tpu.torch as hvd

        hvd.init()
    else:
        import horovod_tpu_torch.torch as hvd

        hvd.init(device="cpu")
    return hvd


def _error(fn):
    """The message of the HorovodInternalError ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is checked below
        return f"{type(e).__name__}: {e}"
    return "no error"


def _battery(rank, size, impl):
    hvd = _open(impl)
    out = {}
    try:
        # Allreduce, every dtype x op, enqueued together (they fuse).
        handles = {}
        for d, dt in enumerate(DTYPES):
            for o, op in enumerate(OPS):
                handles[f"ar.{dt}.{op}"] = hvd.allreduce_async(
                    _input(dt, (3, 5), 10 * d + o, rank),
                    op=getattr(hvd, op))
        for d, dt in enumerate(FLOATS + ("int32", "int64")):
            handles[f"ar.{dt}.scaled_avg"] = hvd.allreduce_async(
                _input(dt, (7,), 100 + d, rank), op=hvd.Average,
                prescale_factor=0.5, postscale_factor=3.0)
            handles[f"ar.{dt}.scaled_sum"] = hvd.allreduce_async(
                _input(dt, (2, 3), 200 + d, rank), op=hvd.Sum,
                prescale_factor=2.0)
        # 32 allreduces of 32 bytes that may share one response.
        for i in range(32):
            handles[f"fuse.{i}.Sum"] = hvd.allreduce_async(
                _input("float32", (8,), 150 + i, rank), op=hvd.Sum)
        for k, h in handles.items():
            out[k] = _keep(h.synchronize())
        # One at a time: the lone-tensor path (the bf16 prescale fold).
        for d, dt in enumerate(FLOATS):
            out[f"ar1.{dt}.scaled"] = _keep(hvd.allreduce(
                _input(dt, (9,), 300 + d, rank), op=hvd.Sum,
                prescale_factor=0.25, postscale_factor=1.5))
        for d, dt in enumerate(FLOATS):
            out[f"adasum.{dt}"] = _keep(hvd.allreduce(
                _input(dt, (33,), 400 + d, rank), op=hvd.Adasum))
        out["adasum.int32.error"] = _error(lambda: hvd.allreduce(
            _input("int32", (3,), 1, rank), op=hvd.Adasum))

        # In place writes into the caller's storage; out of place leaves
        # the input as it was.
        t = _input("float32", (4, 3), 500, rank)
        ptr = t.data_ptr()
        r = hvd.allreduce_(t, op=hvd.Sum)
        out["inplace.same_storage"] = r.data_ptr() == ptr == t.data_ptr()
        out["inplace.allreduce_"] = _keep(t)
        t = _input("bfloat16", (6,), 501, rank)
        ptr = t.data_ptr()
        hs = hvd.grouped_allreduce_async_(
            [t, _input("bfloat16", (2, 2), 502, rank)], op=hvd.Average)
        outs = [h.synchronize() for h in hs]
        out["inplace.grouped_same_storage"] = outs[0].data_ptr() == ptr
        for i, o in enumerate(outs):
            out[f"inplace.grouped.{i}"] = _keep(o)
        t = _input("float32", (5,), 503, rank)
        before = t.clone()
        out["oop.allreduce"] = _keep(hvd.allreduce(t))
        out["oop.input_untouched"] = bool(torch.equal(t, before))
        t = _input("int64", (4,), 504, rank)
        ptr = t.data_ptr()
        hvd.broadcast_(t, root_rank=size - 1)
        out["inplace.broadcast_same_storage"] = t.data_ptr() == ptr
        out["inplace.broadcast_"] = _keep(t)

        # Allgather with unequal first dims, broadcast, in every dtype.
        for d, dt in enumerate(DTYPES):
            out[f"ag.{dt}"] = _keep(hvd.allgather(
                _input(dt, (rank + 1, 2), 600 + d, rank)))
            out[f"bc.{dt}"] = _keep(hvd.broadcast(
                _input(dt, (3,), 700 + d, rank), root_rank=size - 1))

        # Alltoall with uneven splits, and without.
        for d, dt in enumerate(("float32", "bfloat16", "int64", "bool")):
            splits = [1 + (rank + j) % 2 for j in range(size)]
            out[f"a2a.{dt}"] = _keep(hvd.alltoall(
                _input(dt, (sum(splits), 3), 800 + d, rank), splits=splits))
        out["a2a.even"] = _keep(hvd.alltoall(
            _input("float32", (2 * size, 2), 810, rank)))

        # Reducescatter with uneven rows.
        for o, op in enumerate(OPS):
            out[f"rs.float32.{op}"] = _keep(hvd.reducescatter(
                _input("float32", (2 * size + 1, 3), 900 + o, rank),
                op=getattr(hvd, op)))
        for d, dt in enumerate(DTYPES[1:-1]):
            out[f"rs.{dt}.Sum"] = _keep(hvd.reducescatter(
                _input(dt, (size + 1, 2), 910 + d, rank), op=hvd.Sum))

        # Grouped allgather and reducescatter.
        for i, g in enumerate(hvd.grouped_allgather(
                [_input("float32", (rank + 1, 2), 1000 + i, rank)
                 for i in range(3)])):
            out[f"grouped_ag.{i}"] = _keep(g)
        for i, g in enumerate(hvd.grouped_reducescatter(
                [_input("float32", (size * 2, 3), 1010 + i, rank)
                 for i in range(2)], op=hvd.Sum)):
            out[f"grouped_rs.{i}"] = _keep(g)

        # Ranks enqueue the same names in different orders.
        names = [f"order.{i}" for i in range(4)]
        order = names if rank % 2 == 0 else names[::-1]
        hs = {n: hvd.allreduce_async(
            _input("float32", (6,), 1100 + names.index(n), rank), name=n,
            op=hvd.Sum) for n in order}
        for n in names:
            out[f"ar.{n}"] = _keep(hs[n].synchronize())

        # Process sets: the last rank alone, and the first and last.
        last = hvd.add_process_set([size - 1])
        pair = hvd.add_process_set([0, size - 1])
        if rank == size - 1:
            out["ps.alone"] = _keep(hvd.allreduce(
                _input("float32", (4,), 1200, rank), name="ps.alone",
                op=hvd.Sum, process_set_id=last))
        if rank in (0, size - 1):
            out["ps.pair"] = _keep(hvd.allreduce(
                _input("float32", (4,), 1201, rank), name="ps.pair",
                process_set_id=pair))
            out["ps.pair.ag"] = _keep(hvd.allgather(
                _input("float32", (rank + 1,), 1202, rank),
                name="ps.pair.ag", process_set_id=pair))
            out["ps.pair.size_rank"] = (pair.size(), pair.rank())
        hvd.remove_process_set(pair)
        hvd.remove_process_set(last)

        # Mismatches fail on every rank.
        out["err.shape"] = _error(lambda: hvd.allreduce(
            torch.zeros(3 + rank), name="bad.shape"))
        out["err.dtype"] = _error(lambda: hvd.allreduce(
            torch.zeros(3, dtype=torch.float32 if rank == 0
                        else torch.float64), name="bad.dtype"))
        out["err.op"] = _error(
            lambda: hvd.allreduce(torch.zeros(3), name="bad.op")
            if rank == 0 else hvd.allgather(torch.zeros(3), name="bad.op"))
        out["err.root"] = _error(lambda: hvd.broadcast(
            torch.zeros(3), root_rank=rank, name="bad.root"))
        out["err.gather_dims"] = _error(lambda: hvd.allgather(
            torch.zeros(2, 2 + rank), name="bad.gather"))

        out["err.grouping"] = _error(lambda: _mismatched_grouping(impl,
                                                                 rank))

        hvd.barrier()
        # Join: rank r runs r + 1 allreduces, then joins; joined ranks
        # contribute zeros. Then every rank but 0 allgathers (rank 0,
        # joined at once, contributes no rows) and joins.
        for i in range(rank + 1):
            out[f"join.ar.{i}"] = _keep(hvd.allreduce(
                torch.full((4,), float(rank + 1)), name=f"join.ar.{i}",
                op=hvd.Sum))
        out["join.last"] = hvd.join()
        if rank > 0:
            out["join.ag"] = _keep(hvd.allgather(
                torch.full((2, 3), float(rank)), name="join.ag"))
        # Which of ranks 1.. joins last here depends on timing.
        out["last_joined_after_gather"] = hvd.join()
        hvd.barrier()
        if impl == "port":
            # Fused responses (the metrics registry), and the most bytes
            # one fused allreduce carried (its response_launch event).
            fused = [e["bytes"] for e in hvd.events()
                     if e["type"] == "response_launch" and
                     e["op_class"] == 0 and e["tensors"] > 1]
            out["stats"] = dict(
                fused=hvd.metrics()["fusion"]["fused_responses"],
                largest_fused=max(fused, default=0))
        return out
    finally:
        hvd.shutdown()


def _mismatched_grouping(impl, rank):
    """Rank 0 groups two allreduces, rank 1 enqueues them alone: both
    fail. The reference frontend enqueues a CPU group tensor by tensor,
    so its side is the core's own grouped call (``eager_ops``), as
    ``tests/parallel/test_eager_ops.py:469`` drives it."""
    z4, z5 = np.zeros(4, np.float32), np.zeros(5, np.float32)
    if impl == "ref":
        from horovod_tpu.common import eager_ops as ops

        if rank == 0:
            hs = ops.grouped_allreduce_async([z4, z5], ["mm.0", "mm.1"])
        else:
            hs = [ops.allreduce_async(z4, "mm.0"),
                  ops.allreduce_async(z5, "mm.1")]
    else:
        import horovod_tpu_torch.torch as hvd

        t4, t5 = torch.from_numpy(z4), torch.from_numpy(z5)
        if rank == 0:
            hs = hvd.grouped_allreduce_async_([t4, t5],
                                              names=["mm.0", "mm.1"])
        else:
            hs = [hvd.allreduce_async_(t4, name="mm.0"),
                  hvd.allreduce_async_(t5, name="mm.1")]
    raise RuntimeError(" | ".join(_error(h.synchronize) for h in hs))


def _adasum_battery(rank, size, impl):
    hvd = _open(impl)
    try:
        out = {}
        for d, dt in enumerate(FLOATS):
            out[f"adasum.{dt}"] = _keep(hvd.allreduce(
                _input(dt, (65,), 50 + d, rank), op=hvd.Adasum))
        out["adasum.scaled"] = _keep(hvd.allreduce(
            _input("float32", (17,), 60, rank), op=hvd.Adasum,
            prescale_factor=0.5, postscale_factor=2.0))
        # A zero-norm side is added as it is.
        out["adasum.zero"] = _keep(hvd.allreduce(
            torch.zeros(5) if rank == 0 else _input("float32", (5,), 61,
                                                    rank), op=hvd.Adasum))
        return out
    finally:
        hvd.shutdown()


def _values(entry):
    arr = entry["array"]
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16).double().numpy()
    return arr.astype(np.float64)


def _bit_exact(key, dtype, size):
    if dtype in ("float32", "float64"):
        return size == 2 and key.endswith((".Sum", ".Min", ".Max"))
    return dtype not in FLOATS


def _compare(ref, port, size):
    assert set(ref) == set(port), set(ref) ^ set(port)
    for key in sorted(ref):
        want, got = ref[key], port[key]
        if not isinstance(want, dict):
            # Error messages, flags, counts: equal.
            assert want == got, (key, want, got)
            continue
        assert want["dtype"] == got["dtype"], (key, want, got)
        assert want["array"].shape == got["array"].shape, (key, want, got)
        if _bit_exact(key, want["dtype"], size):
            np.testing.assert_array_equal(got["array"], want["array"],
                                          err_msg=key)
        elif want["dtype"] in ("float16", "bfloat16"):
            np.testing.assert_allclose(_values(got), _values(want),
                                       rtol=1e-2, atol=1e-2, err_msg=key)
        else:
            np.testing.assert_allclose(_values(got), _values(want),
                                       rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.fixture(scope="module")
def two_ranks():
    ref = run_ranks(functools.partial(_battery, impl="ref"), 2, timeout=180)
    port = run_ranks(functools.partial(_battery, impl="port"), 2,
                     timeout=180)
    return ref, port


@pytest.mark.parametrize("group", [
    "ar.", "fuse.", "ar1.", "adasum.", "inplace.", "oop.", "ag.", "bc.",
    "a2a.", "rs.", "grouped_", "ar.order", "ps.", "err.", "join."])
def test_two_ranks_match_reference(two_ranks, group):
    ref, port = two_ranks
    compared = 0
    for rank in range(2):
        r = {k: v for k, v in ref[rank].items() if k.startswith(group)}
        p = {k: v for k, v in port[rank].items() if k.startswith(group)}
        _compare(r, p, 2)
        compared += len(r)
    assert compared, group


def test_two_ranks_in_place_errors_and_join_hold(two_ranks):
    _, port = two_ranks
    for out in port:
        assert out["inplace.same_storage"]
        assert out["inplace.grouped_same_storage"]
        assert out["inplace.broadcast_same_storage"]
        assert out["oop.input_untouched"]
        assert out["join.last"] == 1
        assert out["last_joined_after_gather"] == 1
        for key in ("err.shape", "err.dtype", "err.op", "err.root",
                    "err.gather_dims", "err.grouping"):
            assert "HorovodInternalError" in out[key], out[key]
            assert "mismatched" in out[key], out[key]
        # The grouped allreduce is one fused response, whatever the
        # timing.
        assert out["stats"]["fused"] >= 1


def test_fusion_threshold_256_same_numbers(two_ranks):
    ref, _ = two_ranks
    port = run_ranks(functools.partial(_battery, impl="port"), 2,
                     timeout=180, env={"HOROVOD_FUSION_THRESHOLD": "256"})
    for rank in range(2):
        _compare(ref[rank], {k: v for k, v in port[rank].items()
                             if k != "stats"}, 2)
        assert port[rank]["stats"]["largest_fused"] <= 256


def _lose_a_peer(rank, size, port, q):
    import os

    os.environ.update({"HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
                       "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
                       "HOROVOD_CONTROLLER_PORT": str(port)})
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(4), name="before")
    if rank == 1:
        os._exit(3)        # a crash: no shutdown, no atexit
    out = {"in_flight": _error(lambda: hvd.allreduce(torch.ones(4),
                                                     name="after")),
           "later": _error(lambda: hvd.allreduce(torch.ones(4),
                                                 name="later"))}
    hvd.shutdown()
    q.put(out)


def test_lost_peer_fails_in_flight_and_later_ops():
    import multiprocessing as mp

    from tests.test_torch_mp import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_lose_a_peer, args=(r, 2, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = q.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert procs[0].exitcode == 0 and procs[1].exitcode == 3
    # The typed subclass of HorovodInternalError, naming the lost rank.
    assert out["in_flight"].startswith("HorovodPeerFailureError: "), out
    assert "collective runtime failed" in out["in_flight"], out
    assert "rank(s) [1] lost" in out["in_flight"], out
    assert out["later"].startswith(
        "HorovodPeerFailureError: cannot enqueue later"), out
