"""ZeRO-1 across four H100s: Llama-3-8B with f32 master weights trained
data-parallel.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. Each rank takes one card
(``HOROVOD_LOCAL_RANK``), joins ``create_mesh(data=4)`` (NCCL groups) and
trains ``LlamaConfig.llama3_8b()`` at full width through
``make_split_train_step(llama_loss(mesh=), fused_master_adam(3e-4),
zero=ZeroConfig(mesh=mesh))`` (the fused schedule) on B1 x T2048 a rank:
its share of one seeded B4 x T2048 batch. The params are drawn from one
seed on every rank in bf16 (an f32 draw of 8 B params, 32 GB, beside the
f32 state would not fit a card); the f32 master starts as their copy.

(i) 2 layers, 2 steps: the params are bit-identical across the four
ranks; rank 0 then runs the one-card replicated ``fused_master_adam``
split step on the whole batch from the same params. The first loss (no
update yet) agrees to 1e-3 relative, and every param to within
``2 * lr * steps`` plus one bf16 unit of its magnitude: the gradients
differ in their bf16 roundings (four partial sums reduced by NCCL against
one product over the batch), Adam's first steps move an entry by about
``lr`` whatever its gradient's size, so an entry whose gradient is near
zero may step the other way (at most ``2 * lr`` a step), and a master
that moves by less than a bf16 unit may round its compute cast either
way.

(ii) 32 layers, ``remat="full"``, 3 steps: finite losses, the same on
every rank; printed with each rank's ``max_memory_allocated``, ms/step
and optimizer-state bytes beside the layout's 1/4 figure and the
replicated state's bytes (12 bytes a parameter).

(iii) Elastic: Llama-3-8B at full width with ``fused_adam`` (bf16 mu and
nu) under the split step, ZeRO over the world (``ZeroConfig()``: no
mesh, the world's size), ``remat="full"``, each rank on its rows of one
seeded B12 x T1024 batch, inside ``hvd.elastic.TreeState``: 2 steps at
4 ranks, a voluntary ``shrink([3], state=)`` (the card's rows handed
over before it leaves), 2 steps at 3, the victim back through the
parole door (``HOROVOD_REJOIN_PORT``) and ``sync`` to 4, 2 steps. Before
each move rank 0 gathers every bucket's moments to the host (the lane's
allgather, bucket by bucket); after it, the new blocks gathered again
must join to the same bits, the padding zero: every rank's carry is the
gathered state re-sliced. Each step after a move is replayed from a
fresh carry built at the new size from the same params and blocks: the
losses equal. Printed: the re-layout's seconds (``TreeState.
last_relayout_s``) beside the NVLink bound of the busiest rank's bytes
(the plans' alltoallv, 450 GB/s a direction), and each rank's peak at 3.
A one-element alltoall before each move sets up the world's NCCL
peer-to-peer links (its cold and warm ms are printed), so that the moves'
times are the data's.
``ELASTIC_LAYERS`` (default 32) cuts the depth.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.utils_mp import run_ranks

pytestmark = pytest.mark.cuda_sm90

LR = 3e-4
BATCH, SEQ = 4, 2048


def _config(layers, remat):
    from horovod_tpu_torch.models import llama as tl

    return dataclasses.replace(tl.LlamaConfig.llama3_8b(), n_layers=layers,
                               remat=remat, dtype="bfloat16",
                               param_dtype="bfloat16")


def _batch():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 128256, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, 1))}


def _init(cfg):
    from horovod_tpu_torch.models import llama as tl

    return tl.llama_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")


def _host(tree):
    from horovod_tpu_torch.parallel._tree import tree_leaves

    return [t.detach().cpu() for t in tree_leaves(tree)]


def _digest(leaves):
    import hashlib

    h = hashlib.sha256()
    for t in leaves:
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _against(got, want, steps):
    """How far the bf16 params ``got`` lie from ``want``: the largest
    difference, the largest excess over the module docstring's bound
    (<= 0 passes), and how many entries differ at all."""
    worst, excess, differ, total = 0.0, -np.inf, 0, 0
    for a, b in zip(got, want):
        za, zb = a.float(), b.float()
        err = (za - zb).abs()
        ulp = torch.maximum(za.abs(), zb.abs()) * 2.0 ** -7
        excess = max(excess, (err - 2 * LR * steps - ulp).max().item())
        worst = max(worst, err.max().item())
        differ += int((a.view(torch.int16) != b.view(torch.int16)).sum())
        total += a.numel()
    return dict(worst=worst, excess=excess, differ=differ, total=total)


def _worker(rank, size, layers, steps, remat, reference):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel import zero as Z

    mesh = mesh_mod.create_mesh(data=size)
    cfg = _config(layers, remat)
    batch = _batch()
    local = {k: v.to(mesh.device) for k, v in mesh.shard_batch(batch).items()}
    ts = train_step.make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, cfg, mesh=mesh),
        precision.fused_master_adam(LR), zero=Z.ZeroConfig(mesh=mesh))
    carry = ts.init(_init(cfg))
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loss, carry = ts.step(carry, local)
        t1.record()
        torch.cuda.synchronize()
        secs.append(t0.elapsed_time(t1))
        losses.append(float(loss))
    layout = Z.zero_bucket_layout(
        Z.layout_leaves(Z._optimizer_hyper(precision.fused_master_adam(LR)),
                        carry[0]), size, Z.DEFAULT_BUCKET_BYTES)
    n_params = sum(b.nelems for b in layout.buckets)
    out = dict(losses=losses, ms_per_step=secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               state_bytes=Z.optimizer_state_bytes(carry[1]),
               layout_quarter_bytes=sum(12 * b.shard_elems(size)
                                        for b in layout.buckets) + 4,
               replicated_bytes=12 * n_params, n_params=n_params,
               card=torch.cuda.get_device_name(mesh.device))
    if reference:
        params = _host(carry[0])
        out["digest"] = _digest(params)
        del carry, ts
        torch.cuda.empty_cache()
        if rank == 0:
            ref = train_step.make_split_train_step(
                lambda p, d: tl.llama_loss(p, d, cfg),
                precision.fused_master_adam(LR))
            rc = ref.init(_init(cfg))
            full = {k: v.to(mesh.device) for k, v in batch.items()}
            out["ref_losses"] = []
            for _ in range(steps):
                loss, rc = ref.step(rc, full)
                out["ref_losses"].append(float(loss))
            out["against_ref"] = _against(params, _host(rc[0]), steps)
    return out


def _skip_without_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")


def test_two_layers_match_the_one_card_replicated_step():
    _skip_without_four_cards()
    steps = 2
    got = run_ranks(_Job(2, steps, "attn+gate", True), 4, timeout=480)
    for g in got:
        assert g["losses"] == got[0]["losses"]
        assert g["digest"] == got[0]["digest"]
    r0 = got[0]
    np.testing.assert_allclose(r0["losses"][0], r0["ref_losses"][0],
                               rtol=1e-3)
    d = r0["against_ref"]
    assert d["excess"] <= 0, d
    print(f"four cards, Llama-3-8B 2 layers: ZeRO losses {r0['losses']}, "
          f"one-card replicated {r0['ref_losses']}; largest param "
          f"difference {d['worst']:.3e}, {d['differ']} of {d['total']} "
          f"params differ; peak {[round(g['peak_gib'], 2) for g in got]} "
          f"GiB; {r0['card']}")


def test_llama3_8b_trains_on_four_cards():
    _skip_without_four_cards()
    got = run_ranks(_Job(32, 3, "full", False), 4, timeout=480)
    for g in got:
        assert g["losses"] == got[0]["losses"]
        assert all(np.isfinite(got[0]["losses"]))
        assert g["state_bytes"] == g["layout_quarter_bytes"]
    r0 = got[0]
    assert r0["n_params"] == 8_030_261_248
    print(f"four cards, Llama-3-8B 32 layers remat=full B1 x T{SEQ} a "
          f"rank: losses {r0['losses']}; ms/step "
          f"{[[round(t, 1) for t in g['ms_per_step']] for g in got]}; "
          f"peak {[round(g['peak_gib'], 2) for g in got]} GiB; state "
          f"{[g['state_bytes'] for g in got]} bytes a rank (layout 1/4: "
          f"{r0['layout_quarter_bytes']}; replicated "
          f"{r0['replicated_bytes']}); {r0['card']}")


# ---- (iii) elastic ZeRO: 4 -> 3 -> 4 ------------------------------------

EL_BATCH, EL_SEQ = 12, 1024
NVLINK_BYTES_PER_S = 450e9         # one direction, H100 SXM


def _el_batch(vocab, seq):
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, vocab, (EL_BATCH, seq)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, 1))}


def _el_rows(batch, hvd, device, step):
    n = EL_BATCH // hvd.size()
    r = hvd.rank()
    return {k: torch.roll(v, step, 0)[r * n:(r + 1) * n].to(device)
            for k, v in batch.items()}


def _gathered(hvd, opt, tag):
    """Every bucket's moments joined over the ranks (the real elements),
    on rank 0's host; None elsewhere."""
    meta = opt.zero_layout
    out = {}
    for f in ("mu", "nu"):
        for i, block in enumerate(getattr(opt, f)):
            full = hvd.allgather(block, name=f"{tag}.{f}.{i}")
            if hvd.rank() == 0:
                out[f, i] = full[:meta.nelems[i]].cpu()
            if block.numel() * hvd.size() > meta.nelems[i]:
                assert not full[meta.nelems[i]:].any(), "padding not zero"
    return out if hvd.rank() == 0 else None


def _same_as(hvd, opt, want, tag):
    got = _gathered(hvd, opt, tag)
    if hvd.rank() != 0:
        return None
    return all(torch.equal(got[k].view(torch.int16), want[k].view(
        torch.int16)) for k in want) and got.keys() == want.keys()


def _plan_bound(opt, victims, size):
    """The NVLink bound (ms) of a move of ``opt``'s blocks: the busiest
    rank's alltoallv bytes (the plans') over one direction's rate."""
    from horovod_tpu_torch.parallel import reshard as R

    meta = opt.zero_layout
    alive = [r for r in range(size) if r not in victims]
    m = len(alive)
    tx, rx = [0] * size, [0] * size
    for i, n in enumerate(meta.nelems):
        s, s_new = meta.padded()[i] // size, meta.padded(m)[i] // m
        src = [max(0, min(n, (r + 1) * s) - r * s) for r in range(size)]
        dst = [0 if r not in alive else
               max(0, min(n, (alive.index(r) + 1) * s_new)
                   - alive.index(r) * s_new) for r in range(size)]
        plan = R.plan_redistribute((n,), np.dtype("V2"), R.rows_layout(src),
                                   R.rows_layout(dst))
        for r in range(size):
            tx[r] += 2 * plan.wire_tx_bytes(r)     # mu and nu
            rx[r] += 2 * plan.wire_rx_bytes(r)
    return max(max(tx), max(rx)) / NVLINK_BYTES_PER_S * 1e3, sum(tx)


def _elastic_worker(rank, size, layers):
    import time

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import elastic as ce
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    hvd.init()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _config(layers, "full")
    batch = _el_batch(cfg.vocab_size, EL_SEQ)

    def build():
        ts = train_step.make_split_train_step(
            lambda p, d: tl.llama_loss(p, d, cfg, device=device),
            precision.fused_adam(LR), zero=ZeroConfig())
        return ts, ts.init(_init(cfg))

    def steps(ts, carry, first, n=2):
        losses = []
        for i in range(n):
            loss, carry = ts.step(carry, _el_rows(batch, hvd, device,
                                                  first + i))
            losses.append(float(loss))
        return losses, carry

    out = {"rank": rank, "card": torch.cuda.get_device_name(device)}
    ts, carry = build()
    state = hvd.elastic.TreeState(carry=carry, step=0)
    del carry
    out["losses4"], state.carry = steps(ts, state.carry, 0)
    state.commit()
    want = _gathered(hvd, state.carry[1], "t.g4")
    bound, moved = _plan_bound(state.carry[1], {3}, hvd.size())
    out["p2p4_ms"] = _p2p_setup_ms(hvd, device, "t.p2p4")
    torch.cuda.reset_peak_memory_stats()
    if not hvd.elastic.shrink([3], state=state):
        out["handover_s"] = state.last_relayout_s
        del state
        torch.cuda.empty_cache()
        hvd.elastic.rejoin()
        ts, carry = build()
        state = hvd.elastic.TreeState(carry=carry, step=0)
        del carry
        out["p2p4b_ms"] = _p2p_setup_ms(hvd, device, "t.p2p4b")
        state.sync()
        out["joined_as"] = hvd.rank()
        out["sync_s"] = state.last_relayout_s
    else:
        out.update(handover_s=state.last_relayout_s, handover_bound_ms=bound,
                   handover_bytes=moved,
                   shrunk=_same_as(hvd, state.carry[1], want, "t.s3"))
        snap = _moved(state.carry, "cpu")
        out["losses3"], state.carry = steps(ts, state.carry, 2)
        out["peak3_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["replay3"] = _replay(build, steps, state, snap, 2)
        want = _gathered(hvd, state.carry[1], "t.g3")
        if hvd.rank() == 0:
            door, t0 = ce._ensure_door(), time.monotonic()
            while door.pending_count() == 0:
                assert time.monotonic() - t0 < 300, "no joiner knocked"
                time.sleep(0.1)
        try:
            state.commit()
            raise AssertionError("the commit let no joiner in")
        except hvd.HostsUpdatedInterrupt:
            hvd.elastic.reset()
            state.on_reset()
        out["p2p4b_ms"] = _p2p_setup_ms(hvd, device, "t.p2p4b")
        state.sync()
        out["sync_s"] = state.last_relayout_s
    out["grown"] = _same_as(hvd, state.carry[1], want, "t.s4")
    snap = _moved(state.carry, "cpu")
    out["losses4b"], state.carry = steps(ts, state.carry, 4)
    out["replay4"] = _replay(build, steps, state, snap, 4)
    out["size"] = hvd.size()
    hvd.shutdown()
    return out


def _moved(carry, dev):
    """A carry's params and ZeRO blocks on ``dev`` (the state keeps its
    layout record)."""
    from horovod_tpu_torch.parallel._tree import tree_map

    params, opt = carry
    return (tree_map(lambda v: v.detach().to(dev, copy=True), params),
            opt._replace(count=opt.count.to(dev, copy=True),
                         mu=tuple(t.to(dev, copy=True) for t in opt.mu),
                         nu=tuple(t.to(dev, copy=True) for t in opt.nu)))


def _replay(build, steps, state, snap, first):
    """Losses of 2 steps from a fresh carry at this size (a new program,
    its own layout) holding ``snap``'s params and blocks, copied in place
    from the host; the elastic carry waits on the host meanwhile (one
    carry on the card at a time)."""
    from horovod_tpu_torch.parallel._tree import tree_leaves

    dev = state.carry[1].count.device
    parked = _moved(state.carry, "cpu")
    state.carry = None
    torch.cuda.empty_cache()
    ts, carry = build()
    params, opt = snap
    with torch.no_grad():
        for v, w in zip(tree_leaves(carry[0]), tree_leaves(params)):
            v.copy_(w)
        for f in ("count", "mu", "nu"):
            for v, w in zip(*(((getattr(o, f),) if f == "count" else
                               getattr(o, f)) for o in (carry[1], opt))):
                v.copy_(w)
    losses, carry = steps(ts, carry, first)
    del carry, ts
    torch.cuda.empty_cache()
    state.carry = _moved(parked, dev)
    return losses


def _p2p_setup_ms(hvd, device, tag):
    """A one-element-a-rank alltoall on the lane, cold then warm (ms): a
    communicator's first alltoall sets up NCCL's peer-to-peer links."""
    import time

    out = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hvd.alltoall(torch.zeros(hvd.size(), device=device),
                     name=f"{tag}.{i}")
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def test_zero_carry_follows_shrink_and_rejoin_on_four_cards():
    import os

    from tests.utils_mp import free_port

    _skip_without_four_cards()
    layers = int(os.environ.get("ELASTIC_LAYERS", 32))
    got = run_ranks(_ElasticJob(layers), 4, timeout=1500,
                    env={"HOROVOD_REJOIN_PORT": str(free_port()),
                         # The joiner waits at the door while the
                         # survivors check, train and replay at 3.
                         "HOROVOD_START_TIMEOUT": "900"})
    r0 = got[0]
    assert r0["shrunk"] and r0["grown"], r0
    for g in got:
        assert g["size"] == 4
        if g["rank"] != 3:
            assert g["losses3"] == g["replay3"], g
        assert g["losses4b"] == g["replay4"], g
        assert all(np.isfinite(g["losses4"] + g["losses4b"]))
    assert got[3]["joined_as"] == 3
    print(f"four cards, Llama-3-8B {layers} layers, fused_adam ZeRO over the "
          f"world: losses at 4 {r0['losses4']}, at 3 {r0['losses3']}, at 4 "
          f"again {r0['losses4b']}; hand-over 4 -> 3 "
          f"{[round(g['handover_s'] * 1e3, 1) for g in got]} ms a rank "
          f"beside the NVLink bound {r0['handover_bound_ms']:.2f} ms "
          f"({r0['handover_bytes'] / 1e9:.3f} GB sent); re-layout 3 -> 4 "
          f"{[round(g['sync_s'] * 1e3, 1) for g in got]} ms; NCCL's "
          f"peer-to-peer setup, a one-element alltoall cold/warm before "
          f"each move: {[round(t, 1) for t in r0['p2p4_ms']]} ms at 4, "
          f"{[round(t, 1) for t in r0['p2p4b_ms']]} ms at 4 again; peak at 3 "
          f"{[round(g.get('peak3_gib', 0), 2) for g in got[:3]]} GiB; "
          f"{r0['card']}")


class _ElasticJob:
    def __init__(self, layers):
        self.layers = layers

    def __call__(self, rank, size):
        return _elastic_worker(rank, size, self.layers)


class _Job:
    """A picklable ``_worker`` with its arguments bound."""

    def __init__(self, layers, steps, remat, reference):
        self.args = (layers, steps, remat, reference)

    def __call__(self, rank, size):
        return _worker(rank, size, *self.args)
