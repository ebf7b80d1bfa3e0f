"""The response cache of the port's lane against the reference's.

The cases of ``tests/parallel/test_response_cache.py`` run on the same
seeded numpy inputs through the reference ``horovod_tpu.torch`` in one
spawned world and through ``horovod_tpu_torch.torch``
(``init(device="cpu")``, gloo) in another, started together: a steady
state (12 steps of 6 named allreduces, a broadcast and a
reducescatter) at 2 and 4 ranks; a name whose shape, dtype or reduce op
changes (an eviction everywhere); ranks that enqueue in different
orders with one late; a join that covers a pending bit; a disabled cache
(``HOROVOD_CACHE_CAPACITY=0``); and a cache of 4 positions under 6
names. Results are held to ``test_torch_hvd_ops.py``'s tolerances (at 2
ranks f32 Sum bit for bit), and after every case each rank's
``(hits, misses, entries)`` equals the reference's
``response_cache_stats()``. A unit test drives two caches with the same
response lists and holds them identical.
"""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_hvd_ops import _compare, _keep
from tests.test_torch_mp import run_ranks

STEPS, NGRADS = 12, 6


def run_both(fn, size, env=None, timeout=240):
    """``fn(rank, size, impl)`` in a reference world and a port world,
    started together; returns (reference results, port results)."""
    out, errors = {}, []

    def world(impl):
        try:
            out[impl] = run_ranks(_Bound(fn, impl), size,
                                  timeout=timeout, env=env)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=world, args=(impl,))
               for impl in ("ref", "port")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out["ref"], out["port"]


class _Bound:
    """A picklable ``fn(rank, size, impl)`` bound to ``impl``."""

    def __init__(self, fn, impl):
        self.fn, self.impl = fn, impl

    def __call__(self, rank, size):
        return self.fn(rank, size, self.impl)


def open_lane(impl):
    """``(hvd, cache_stats)`` of an initialized lane."""
    if impl == "ref":
        import horovod_tpu.torch as hvd
        from horovod_tpu.common.basics import HorovodBasics

        hvd.init()
        return hvd, HorovodBasics().response_cache_stats
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics

    hvd.init(device="cpu")
    return hvd, basics.response_cache_stats


def _x(shape, seed, rank, dtype=np.float32):
    rng = np.random.default_rng(seed * 7919 + rank)
    return torch.from_numpy(rng.standard_normal(shape).astype(dtype))


def _steady(hvd, rank, size, out):
    for step in range(STEPS):
        hs = [hvd.allreduce_async(_x((8,), 100 * step + i, rank),
                                  name=f"grad.{i}", op=hvd.Sum)
              for i in range(NGRADS)]
        for i, h in enumerate(hs):
            out[f"steady.{step}.{i}"] = _keep(h.synchronize())
        out[f"steady.{step}.bcast"] = _keep(hvd.broadcast(
            _x((4,), 50 + step, rank, np.float64), 0,
            name="bcast.w"))
        out[f"steady.{step}.rs"] = _keep(hvd.reducescatter(
            _x((size * 2, 3), 70 + step, rank), name="rs.w",
            op=hvd.Sum))


def _cases(rank, size, impl):
    """Steady state, eviction, skewed arrival and join in one world; the
    cache counters after each."""
    import time

    hvd, stats = open_lane(impl)
    out = {}
    try:
        _steady(hvd, rank, size, out)
        out["stats.steady"] = stats()
        # A name whose shape, dtype or reduce op changes.
        for k, shape in enumerate(((4,), (4,), (6,), (6,), (2, 3), (4,))):
            out[f"evict.shape.{k}"] = _keep(hvd.allreduce(
                _x(shape, 200 + k, rank), name="mutating", op=hvd.Sum))
        for k, dt in enumerate((np.float32, np.float64, np.float32)):
            out[f"evict.dtype.{k}"] = _keep(hvd.allreduce(
                _x((3,), 210 + k, rank, dt), name="mutdtype", op=hvd.Sum))
        for k, op in enumerate(("Sum", "Max", "Sum")):
            out[f"evict.op.{k}"] = _keep(hvd.allreduce(
                _x((3,), 220 + k, rank, np.float64), name="mutop",
                op=getattr(hvd, op)))
        out["stats.evict"] = stats()
        # Ranks enqueue in different orders; rank 1 is late.
        names = [f"skew.{i}" for i in range(3)]
        for step in range(5):
            if rank == 1:
                time.sleep(0.05)
            order = names if rank % 2 == 0 else names[::-1]
            hs = {n: hvd.allreduce_async(
                _x((4,), 300 + 10 * step + names.index(n), rank), name=n,
                op=hvd.Sum) for n in order}
            for n in names:
                out[f"skew.{step}.{n}"] = _keep(hs[n].synchronize())
        out["stats.skew"] = stats()
        # Warm "g", then only rank 0 rides its bit once more: the joined
        # ranks' zeros complete it.
        for step in range(2):
            out[f"join.warm.{step}"] = _keep(hvd.allreduce(
                _x((4,), 400 + step, rank), name="g", op=hvd.Sum))
        if rank == 0:
            out["join.hit"] = _keep(hvd.allreduce(
                _x((4,), 402, rank), name="g", op=hvd.Sum))
        out["join.last"] = hvd.join()
        out["stats.join"] = stats()
        return out
    finally:
        hvd.shutdown()


def _steady_only(rank, size, impl):
    hvd, stats = open_lane(impl)
    out = {}
    try:
        _steady(hvd, rank, size, out)
        out["stats.steady"] = stats()
        return out
    finally:
        hvd.shutdown()


def _small_cache(rank, size, impl):
    """Six names through a cache of 4 positions (or none): every step
    is still right."""
    hvd, stats = open_lane(impl)
    out = {}
    try:
        for step in range(4):
            hs = [hvd.allreduce_async(_x((5,), 500 + 10 * step + i, rank),
                                      name=f"small.{i}", op=hvd.Sum)
                  for i in range(6)]
            for i, h in enumerate(hs):
                out[f"small.{step}.{i}"] = _keep(h.synchronize())
        out["stats.small"] = stats()
        return out
    finally:
        hvd.shutdown()


def _held(ref, port, size):
    """Results to the ops test's tolerances, counters equal."""
    for rank in range(size):
        r = {k: v for k, v in ref[rank].items() if not k.startswith("stats")}
        p = {k: v for k, v in port[rank].items()
             if not k.startswith("stats")}
        _compare(r, p, size)
        for key in ref[rank]:
            if key.startswith("stats"):
                assert tuple(port[rank][key]) == tuple(ref[rank][key]), (
                    rank, key, port[rank][key], ref[rank][key])


@pytest.fixture(scope="module")
def two_ranks():
    return run_both(_cases, 2)


@pytest.mark.parametrize("case", ["steady", "evict", "skew", "join"])
def test_two_ranks_match_reference(two_ranks, case):
    ref, port = two_ranks

    def pick(out):
        return {k: v for k, v in out.items()
                if k.startswith((case + ".", "stats." + case))}

    assert f"stats.{case}" in pick(ref[0])
    _held([pick(o) for o in ref], [pick(o) for o in port], 2)


def test_steady_state_rides_the_cache(two_ranks):
    _, port = two_ranks
    for out in port:
        hits, misses, entries = out["stats.steady"]
        # Every op after the first step is a hit.
        assert entries == NGRADS + 2
        assert hits == (STEPS - 1) * (NGRADS + 2)
        assert misses == NGRADS + 2
    assert port[0]["join.last"] == port[1]["join.last"] == 0


def test_four_ranks_steady_state():
    ref, port = run_both(_steady_only, 4)
    _held(ref, port, 4)
    assert port[0]["stats.steady"][0] == (STEPS - 1) * (NGRADS + 2)


@pytest.mark.parametrize("capacity", ["0", "4"])
def test_capacity(capacity):
    ref, port = run_both(_small_cache, 2,
                         env={"HOROVOD_CACHE_CAPACITY": capacity})
    _held(ref, port, 2)
    hits, misses, entries = port[0]["stats.small"]
    assert entries == int(capacity)
    assert hits == 3 * int(capacity) and misses == 24 - hits


def test_two_caches_fed_alike_stay_identical():
    """Two copies driven by the same broadcast lists, with evictions
    between, hold the same positions; the smallest free one is reused
    first; Adasum, grouped and allgather responses are never cached."""
    from horovod_tpu_torch.common.message import (
        ReduceOp,
        Request,
        RequestType,
        Response,
        ResponseType,
    )
    from horovod_tpu_torch.common.response_cache import (
        HIT,
        INVALID,
        MISS,
        ResponseCache,
    )

    def ar(names, shapes, **kw):
        return Response(ResponseType.ALLREDUCE, list(names),
                        "float32", list(shapes), **kw)

    lists = [
        [ar(["a", "b", "c"], [(4,), (2, 2), (3,)]),
         ar(["adasum"], [(4,)], reduce_op=ReduceOp.ADASUM),
         ar(["g0", "g1"], [(2,), (2,)], group_id=0),
         Response(ResponseType.ALLGATHER, ["ag"], "float32", [(3,)]),
         Response(ResponseType.BROADCAST, ["bc"], "float64", [(5,)],
                  root_rank=1)],
        [ar(["d"], [(1,)]), ar(["a"], [(4,)])],
    ]
    caches = [ResponseCache(8), ResponseCache(8)]
    for cache in caches:
        cache.insert_from_responses(lists[0])
        cache.evict(1)                       # "b"
        cache.insert_from_responses(lists[1])
    assert caches[0].state() == caches[1].state()
    slots, free = caches[0].state()
    assert [s[0][1] if s else None for s in slots] == ["a", "d", "c", "bc"]
    assert free == []
    c = caches[0]
    req = Request(0, RequestType.ALLREDUCE, "a", "float32", (4,))
    assert c.lookup(req) == (HIT, 0)
    assert c.lookup(Request(0, RequestType.ALLREDUCE, "a", "float32",
                            (5,)))[0] == INVALID
    assert c.lookup(Request(0, RequestType.BROADCAST, "bc", "float64", (5,),
                            root_rank=0))[0] == INVALID
    assert c.lookup(Request(0, RequestType.ALLREDUCE, "a", "float32", (4,),
                            group_id=3, group_size=2))[0] == MISS
    assert (c.hits, c.misses, c.entries, c.hit_bytes) == (1, 3, 4, 16)
