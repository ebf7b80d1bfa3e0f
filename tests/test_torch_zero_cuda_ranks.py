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


class _Job:
    """A picklable ``_worker`` with its arguments bound."""

    def __init__(self, layers, steps, remat, reference):
        self.args = (layers, steps, remat, reference)

    def __call__(self, rank, size):
        return _worker(rank, size, *self.args)
