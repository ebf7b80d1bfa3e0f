"""The cross-plane allreduce and the wire codecs on NCCL across four
cards: 4 ranks as 2 slices x 2, one card each.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. Each slice's two ranks see
their own pair of cards (``CUDA_VISIBLE_DEVICES``), as two hosts would,
so that ``local_rank`` picks the card. Under ``HOROVOD_CROSS_PLANE=hier``
with the codec switched between synchronous ops (``hvd.set_wire_codec``,
off, bf16, int8): small integer fills are the exact sum (off and bf16);
every rank holds the same bits; the compressed allreduces equal, bit for
bit, the data plane's own run of the same inputs over 4 emulated ranks
on the CPU (``chip_smoke.emulated_allreduce``: the plain codecs, the
transport emulated), since neither path sums anything outside the codec
arithmetic; each rank's ``wire`` bytes are the hierarchy's formula; the
codec kernels launch.

A lost peer on NCCL: in the same 2 x 2 world rank 3 is SIGKILLed
(``set_fault_inject``) at the top of a hierarchical allreduce. NCCL
queues the collective whatever its peers do, so the loss shows at a
later cycle's negotiation on gloo, and every survivor's next op raises
``HorovodPeerFailureError`` naming rank 3. ``reinit`` over the 3
survivors aborts the communicators the lane's kernels wait in, its
slices' and crosses' as well as the world's, and re-forms a flat world
on the same cards; its allreduce is exact, and the failed lane's thread
has ended.
"""

import os
import time

import numpy as np
import pytest
import torch

from tests.utils_mp import run_ranks

pytestmark = pytest.mark.cuda_sm90

COUNT = (1 << 20) + 37


def _inputs(rank):
    return np.random.default_rng([77, rank]).uniform(
        -2, 2, COUNT).astype(np.float32)


def _two_by_two(rank, device):
    """The 2 x 2 layout; on the card, each slice sees its pair."""
    os.environ.update({"HOROVOD_LOCAL_RANK": str(rank % 2),
                       "HOROVOD_LOCAL_SIZE": "2",
                       "HOROVOD_CROSS_RANK": str(rank // 2),
                       "HOROVOD_CROSS_SIZE": "2"})
    if device is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = "0,1" if rank < 2 else "2,3"


def _worker(rank, size, device=None):
    _two_by_two(rank, device)
    import horovod_tpu_torch.torch as hvd

    hvd.init(device=device)
    try:
        return run_codecs(rank)
    finally:
        hvd.shutdown()


def run_codecs(rank):
    """On the open 2 x 2 lane: the exact fill and the random inputs,
    codec off, bf16 and int8."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import wire_codec as wc

    dev = basics.device() or "cpu"     # the lane's card: cuda:local_rank
    out = {"split": hvd.hier_split()}
    ints = torch.from_numpy(((np.arange(4099) % 9 - 4) * (rank + 1))
                            .astype(np.float32)).to(dev)
    for codec in (0, 1, 2):
        hvd.set_wire_codec(codec)
        before = dict(wc.launches)
        out[f"{codec}.exact"] = hvd.allreduce(
            ints, name=f"{codec}.e", op=hvd.Sum).cpu().numpy()
        w0 = hvd.metrics()["wire"]
        out[f"{codec}.rand"] = hvd.allreduce(
            torch.from_numpy(_inputs(rank)).to(dev), name=f"{codec}.r",
            op=hvd.Average).cpu().numpy()
        w1 = hvd.metrics()["wire"]
        out[f"{codec}.wire"] = {k: w1[k] - w0[k] for k in (
            "tx_bytes", "cross_tx_bytes", "tx_logical_bytes")}
        out[f"{codec}.launches"] = sum(wc.launches[k] - before[k]
                                       for k in wc.KERNELS)
    return out


def hier_tx(count, codec, rank):
    """(tx, cross tx) bytes the lane books for one hierarchical allreduce
    of ``count`` f32 at 2 x 2 (``data_plane``'s formulas)."""
    from horovod_tpu_torch.common import data_plane as dp
    from horovod_tpu_torch.ops.wire_codec import Segments, image_len

    lr, cr = rank % 2, rank // 2
    seg = Segments.even(count, 2)
    counts = [seg.count(i) for i in range(2)]
    wire = [image_len(c, codec) for c in counts] if codec else \
        [4 * c for c in counts]
    rs = (dp.exchange_bytes if codec else dp.ring_reducescatter_bytes)(
        wire, lr)[0]
    ag = dp.ring_allgather_bytes([4 * c for c in counts], lr)[0]
    cseg = Segments.even(counts[lr], 2)
    cc = [cseg.count(i) for i in range(2)]
    if codec:
        cross = sum(dp.exchange_bytes([image_len(c, codec) for c in cc], cr))
    else:
        cross = dp.ring_allreduce_bytes([4 * c for c in cc], cr)[0]
    return rs + ag + cross, cross


def check_four_ranks(got):
    """The assertions of the module docstring over the 4 ranks' results."""
    import chip_smoke

    ints = sum(((np.arange(4099) % 9 - 4) * (r + 1)).astype(np.float32)
               for r in range(4))
    inputs = [torch.from_numpy(_inputs(r)) for r in range(4)]
    want = (sum(x.double() for x in inputs) / 4).numpy()
    for codec in (0, 1, 2):
        c = f"{codec}."
        emu = chip_smoke.emulated_allreduce(torch, inputs, 2, codec, False,
                                            op="average")
        for rank, g in enumerate(got):
            assert g["split"] == 2
            if codec < 2:    # small integers: exact in f32 and bf16
                np.testing.assert_array_equal(g[c + "exact"], ints)
            np.testing.assert_array_equal(g[c + "rand"].view(np.uint32),
                                          got[0][c + "rand"].view(np.uint32))
            assert (g[c + "wire"]["tx_bytes"],
                    g[c + "wire"]["cross_tx_bytes"]) == \
                hier_tx(COUNT, codec, rank)
            if codec:
                np.testing.assert_array_equal(
                    g[c + "rand"].view(np.uint32),
                    emu[rank].numpy().view(np.uint32))
            else:
                assert np.abs(g[c + "rand"] - want).max() <= 1e-6


def test_hier_and_codecs_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    got = run_ranks(_worker, 4, timeout=240,
                    env={"HOROVOD_CROSS_PLANE": "hier"})
    check_four_ranks(got)
    for g in got:
        assert g["0.launches"] == 0
        assert g["1.launches"] > 0 and g["2.launches"] > 0


def _fault_worker(rank, size, device=None):
    _two_by_two(rank, device)
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import HorovodPeerFailureError

    hvd.init(device=device)
    dev = basics.device() or "cpu"
    x = torch.from_numpy(((np.arange(4099) % 9 - 4) * (rank + 1))
                         .astype(np.float32)).to(dev)
    out = {"before": hvd.hier_split()}
    try:
        hvd.allreduce(x, name="warm", op=hvd.Sum).cpu()
        if rank == 3:
            basics.set_fault_inject(3, 1)
        failed, dead = basics.lane(), None
        for i in range(400):
            try:
                # Never read back: a collective with a lost peer never
                # ends on the card, until its communicator is aborted.
                hvd.allreduce(x, name=f"boom.{i}", op=hvd.Sum)
            except HorovodPeerFailureError as e:
                dead = sorted(e.fault_ranks)
                break
            time.sleep(0.05)
        t0 = time.monotonic()
        basics.reinit([0, 1, 2], 1)
        out["reinit_s"] = time.monotonic() - t0
        deadline = time.monotonic() + 30
        while failed._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)
        got = hvd.allreduce(torch.full((9,), float(hvd.rank() + 1),
                                       device=dev), name="flat",
                            op=hvd.Sum).cpu().numpy()
        out.update(dead=dead, failed_lane_ended=not failed._thread.is_alive(),
                   split=hvd.hier_split(), layout=(hvd.size(),
                                                   hvd.local_size()),
                   exact=bool(np.array_equal(got, np.full(9, 6.0))))
        return out
    finally:
        hvd.shutdown()


def test_a_lost_rank_mid_hier_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    from tests.test_torch_elastic_ranks import run_chaos

    got, _ = run_chaos(_fault_worker, 4, victims={3}, timeout=240,
                       env={"HOROVOD_CROSS_PLANE": "hier"})
    assert sorted(got) == [0, 1, 2]
    for g in got.values():
        assert g["before"] == 2 and g["dead"] == [3]
        assert (g["split"], g["layout"], g["exact"],
                g["failed_lane_ended"]) == (0, (3, 3), True, True)
