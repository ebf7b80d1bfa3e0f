"""Wire compression on the port's lane over gloo at 2, 3 and 4 ranks
(``HOROVOD_WIRE_COMPRESSION``, ``HOROVOD_CROSS_PLANE_COMPRESSION``;
``docs/wire.md``), against the reference lane.

One port world of 4 ranks (2 x 2) and one reference world run it all:

- The port under ``hier``: its hierarchical allreduce, off, bf16 and
  int8, gives the bits of ``chip_smoke.py``'s 4 emulated ranks of the
  data plane (``tests/test_torch_hvd_cuda_ranks.py``'s body and checks,
  which run it on NCCL across four cards).
- Both lanes reopen under ``hier`` and
  ``HOROVOD_CROSS_PLANE_COMPRESSION=1``: bf16 on the cross hop alone,
  with the global codec off and int8 (the cross hop stays bf16):
  bitwise across ranks, within the envelope, exact fills bit-equal to
  the reference, and the cross hop's bytes
  ``hier_allreduce_wire_bytes(..., compress_cross=True)``.
- Then flat (``set_hier_split(0)``), the port runs the same traffic over
  process sets of 2 and 3 ranks and over the world, with the codec off,
  bf16 and int8 (``hvd.set_wire_codec``, between synchronous ops on
  every rank): f32 Sum and Average allreduces at an uneven count, a
  fused response and a reducescatter. The allreduces agree bitwise
  across ranks, and every result stays within ``N^2 * 2^-7`` (bf16) and
  ``N^2 * 2^-6`` (int8) of the f64 sum of inputs in [-2, 2]. Ineligible
  traffic (f16, bf16 and int32 Sum, f32 Min and Max, Adasum) is
  bit-identical to the uncompressed run. The compressed allreduce's
  ``wire`` bytes are the port's formula (``data_plane.exchange_bytes``:
  an ``all_to_all`` of the segments' images and an ``all_gather`` of the
  finished ones), equal to ``horovod_tpu/telemetry/predict.py``'s
  ``flat_ring_wire_bytes(..., compressed=True)`` for bf16 at an even
  count, half its logical bytes.
- Exact fills (small integers for bf16; ``+-127 * w`` with a sign shared
  by every rank for int8, exact on the int8 codec's grid) are bit-equal
  to the reference lane under the same codec, flat at 4 ranks.
"""

import functools

import numpy as np
import pytest

from tests.test_torch_hier_ranks import (
    TIMEOUT,
    _free_ports,
    _Lane,
    _reopen_at,
    _slice_env,
)
from tests.test_torch_mp import run_ranks

COUNT = 1025          # uneven over 2, 3 and 4 ranks
EVEN = 1536           # even over 2, 3 and 4 ranks
BOUND = {1: 2.0 ** -7, 2: 2.0 ** -6}
SIZES = (2, 3, 4)
CROSS_ENV = {"HOROVOD_CROSS_PLANE": "hier",
             "HOROVOD_CROSS_PLANE_COMPRESSION": "1"}


def _inputs(n, rank, seed):
    rng = np.random.default_rng([seed, rank])
    return rng.uniform(-2, 2, n).astype(np.float32)


def _exact(n, rank, codec, weight=None):
    """Inputs every codec carries exactly: for int8 one sign pattern for
    all ranks times 127 * a per-rank weight (every record's amax is then
    127 * the weights summed so far, and every value a multiple)."""
    if codec == 2:
        signs = (np.arange(n) * 7 % 3 - 1).astype(np.float32)
        return signs * 127 * (rank + 1 if weight is None else weight)
    return ((np.arange(n) % 9 - 4) * (rank + 1)).astype(np.float32)


def _every_hop(lane, rank, size, pset):
    """The traffic of the module docstring's third item over the set of
    ranks ``0..size-1`` (``pset`` its id), codec off, bf16 and int8."""
    import torch

    hvd = lane.hvd
    out = {}
    for codec in (0, 1, 2):
        lane.set_codec(codec)
        if rank >= size:
            continue
        c = f"{codec}."
        p = f"{size}.{c}"
        out[c + "sum"] = lane.allreduce(_inputs(COUNT, rank, 1), p + "s",
                                        pset=pset)
        out[c + "avg"] = lane.allreduce(_inputs(COUNT, rank, 2), p + "a",
                                        "Average", pset)
        hs = [lane.start(_inputs(100 + i, rank, 3 + i), p + f"f{i}",
                         pset=pset) for i in range(3)]
        for i, h in enumerate(hs):
            out[c + f"fused{i}"] = lane.wait(h)
        out[c + "rs"] = lane.reducescatter(
            _inputs(5 * 33, rank, 9).reshape(5, 33), p + "rs", pset=pset)
        out[c + "exact"] = lane.allreduce(_exact(COUNT, rank, codec),
                                          p + "e", pset=pset)
        # Ineligible traffic.
        for dt in (torch.float16, torch.bfloat16, torch.int32):
            x = torch.from_numpy(_inputs(77, rank, 11) * 8).to(dt)
            r = hvd.allreduce(x, name=p + f"in.{dt}", op=hvd.Sum,
                              process_set_id=pset)
            out[c + f"in.{dt}"] = r.view(torch.int16).numpy() \
                if dt == torch.bfloat16 else r.numpy()
        for op in ("Min", "Max", "Adasum"):
            out[c + f"in.{op}"] = lane.allreduce(
                _inputs(77, rank, 12), p + f"in.{op}", op, pset)
        before = lane.wire()
        lane.allreduce(_inputs(EVEN, rank, 13), p + "w", pset=pset)
        after = lane.wire()
        out[c + "wire"] = {k: after[k] - before[k] for k in after}
    return out


def _exact_fills(lane, rank):
    out = {}
    for codec in (1, 2):
        lane.set_codec(codec)
        out[f"{codec}.ar"] = lane.allreduce(_exact(COUNT, rank, codec),
                                            f"{codec}.ar")
        out[f"{codec}.rs"] = lane.reducescatter(
            _exact(7 * 40, rank, codec).reshape(7, 40), f"{codec}.rs")
    return out


def _cross_hop(lane, rank):
    out = {"split": lane.split()}
    for codec in (0, 2):
        lane.set_codec(codec)
        c = f"{codec}."
        out[c + "sum"] = lane.allreduce(_inputs(COUNT, rank, 21), c + "s")
        out[c + "exact"] = lane.allreduce(
            _exact(COUNT, rank, codec, weight=1), c + "e")
        before = lane.wire()
        lane.allreduce(_inputs(EVEN, rank, 22), c + "w")
        after = lane.wire()
        out[c + "wire"] = {k: after[k] - before[k]
                           for k in ("tx_bytes", "cross_tx_bytes")}
    return out


def _world(rank, size, impl, port=None):
    """The module docstring's sequence on one lane; the reference skips
    the emulated comparison and the process sets."""
    _slice_env(rank, size, 2)
    out = {}
    if impl == "port":
        from tests.test_torch_hvd_cuda_ranks import _worker

        out["emulated"] = _worker(rank, size, device="cpu")
        _reopen_at(port, CROSS_ENV)
    lane = _Lane(impl)
    try:
        out["cross"] = _cross_hop(lane, rank)
        lane.set_codec(0)
        lane.set_split(0)
        if impl == "port":
            out["hop"] = {}
            for k in SIZES:
                pset = 0 if k == size else lane.hvd.add_process_set(
                    list(range(k))).process_set_id
                out["hop"][k] = _every_hop(lane, rank, k, pset)
        out["exact"] = _exact_fills(lane, rank)
        return out
    finally:
        lane.close()


@pytest.fixture(scope="module")
def worlds():
    ref = run_ranks(functools.partial(_world, impl="ref"), 4,
                    timeout=TIMEOUT, env=CROSS_ENV)
    port = run_ranks(functools.partial(_world, impl="port",
                                       port=_free_ports(1)[0]), 4,
                     timeout=TIMEOUT, env={"HOROVOD_CROSS_PLANE": "hier"})
    return ref, port


@pytest.mark.parametrize("size", SIZES)
def test_compression_every_hop(worlds, size):
    from horovod_tpu.telemetry.predict import flat_ring_wire_bytes
    from horovod_tpu_torch.common.data_plane import exchange_bytes
    from horovod_tpu_torch.ops.wire_codec import Segments, image_len

    got = [p["hop"][size] for p in worlds[1][:size]]
    f64 = {"sum": sum(_inputs(COUNT, r, 1).astype(np.float64)
                      for r in range(size)),
           "avg": sum(_inputs(COUNT, r, 2).astype(np.float64)
                      for r in range(size)) / size}
    for i in range(3):
        f64[f"fused{i}"] = sum(_inputs(100 + i, r, 3 + i).astype(np.float64)
                               for r in range(size))
    rows = sum(_inputs(5 * 33, r, 9).astype(np.float64).reshape(5, 33)
               for r in range(size))
    q, rem = divmod(5, size)
    for codec in (1, 2):
        c = f"{codec}."
        bound = size * size * BOUND[codec]
        for key, want in f64.items():
            for rank in range(size):
                # Every rank decodes the same bits.
                np.testing.assert_array_equal(
                    got[rank][c + key].view(np.uint32),
                    got[0][c + key].view(np.uint32), err_msg=key)
            err = np.abs(got[0][c + key] - want).max()
            assert err <= bound, (codec, key, err, bound)
            # The codec ran: the bits differ from the exact path's.
            assert not np.array_equal(got[0][c + key], got[0]["0." + key])
        for rank in range(size):
            off = rank * q + min(rank, rem)
            n = q + (rank < rem)
            err = np.abs(got[rank][c + "rs"] - rows[off:off + n]).max() \
                if n else 0.0
            assert err <= bound, (codec, "rs", rank, err)
            # Ineligible traffic: the same bits as with the codec off.
            for key in got[rank]:
                if key.startswith("0.in."):
                    np.testing.assert_array_equal(
                        got[rank][c + key[2:]], got[rank][key], err_msg=key)
            np.testing.assert_array_equal(
                got[rank][c + "exact"],
                sum(_exact(COUNT, r, codec) for r in range(size)))
            # The wire: the port's formula, the flat ring's bytes for bf16.
            w = got[rank][c + "wire"]
            seg = Segments.even(EVEN, size)
            counts = [seg.count(j) for j in range(size)]
            sizes = [image_len(n, codec) for n in counts]
            tx = sum(exchange_bytes(sizes, rank))
            assert (w["tx_bytes"], w["rx_bytes"]) == (tx, tx)
            assert w["tx_logical_bytes"] == 4 * sum(
                exchange_bytes(counts, rank))
            assert w["cross_tx_bytes"] == 0
            if codec == 1:
                assert w["tx_bytes"] == flat_ring_wire_bytes(
                    EVEN, 4, size, rank, compressed=True)
                assert w["tx_bytes"] * 2 == w["tx_logical_bytes"]
    for rank in range(size):
        w = got[rank]["0.wire"]
        assert w["tx_bytes"] == flat_ring_wire_bytes(EVEN, 4, size, rank)
        assert w["tx_bytes"] == w["tx_logical_bytes"]


def test_exact_fills_match_the_reference(worlds):
    ref, port = worlds
    for rank in range(4):
        for key, want in ref[rank]["exact"].items():
            np.testing.assert_array_equal(port[rank]["exact"][key], want,
                                          err_msg=key)


def test_bf16_on_the_cross_hop_only(worlds):
    from horovod_tpu.telemetry.predict import hier_allreduce_wire_bytes

    ref = [r["cross"] for r in worlds[0]]
    port = [p["cross"] for p in worlds[1]]
    want = sum(_inputs(COUNT, r, 21).astype(np.float64) for r in range(4))
    for rank in range(4):
        assert port[rank]["split"] == ref[rank]["split"] == 2
        for codec in (0, 2):
            c = f"{codec}."
            np.testing.assert_array_equal(
                port[rank][c + "sum"].view(np.uint32),
                port[0][c + "sum"].view(np.uint32))
            err = np.abs(port[rank][c + "sum"] - want).max()
            assert err <= 16 * BOUND[max(codec, 1)], (codec, err)
            np.testing.assert_array_equal(port[rank][c + "exact"],
                                          ref[rank][c + "exact"])
        pred = hier_allreduce_wire_bytes(EVEN, 4, 4, 2, rank,
                                         compress_cross=True)
        w = port[rank]["0.wire"]
        assert w["cross_tx_bytes"] == pred["cross"]
        assert w["tx_bytes"] == pred["cross"] + pred["intra"]


def test_the_lane_on_gloo_equals_the_emulated_data_plane(worlds):
    # The 4-card NCCL test's body and checks on gloo: the compressed
    # hierarchical allreduce of the real lane gives the bits of
    # chip_smoke.py's emulated ranks (the same data plane, its transport
    # replaced by copies).
    from tests.test_torch_hvd_cuda_ranks import check_four_ranks

    check_four_ranks([p["emulated"] for p in worlds[1]])
