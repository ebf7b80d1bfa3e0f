"""The ``tensor``, ``fsdp`` and ``expert`` mesh axes across four H100s:
the dense flagship under ``fsdp=2 x tensor=2`` and Mixtral-8x7B under
``expert=2 x tensor=2`` with the GShard dispatch.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. Each rank takes one card
(``HOROVOD_LOCAL_RANK``), joins ``create_mesh(...)`` (NCCL groups), takes
its blocks of the params (``shard_params(params, mesh,
llama_partition_rules())``) and trains them through
``make_split_train_step(llama_loss(mesh=), ...)``: its share
of one seeded batch (the flagship's B4 x T2048 split over ``fsdp``;
Mixtral's B2 x T2048 whole on every rank, which ``expert`` and ``tensor``
do not split). The params are drawn in bf16 one layer at a time from one
seed on every rank (``llama_init`` of a one-layer config, seed + layer),
so no rank ever holds a whole deep tree.

(i) 2 layers, 2 steps of ``fused_master_adam(3e-4)`` (f32 masters, as
``tests/test_torch_zero_cuda_ranks.py`` (i)), each model: the loss is
the same on every rank; rank 0 then runs the one-card unsharded split
step on the whole batch from the same params, and the params gathered
from the four ranks' blocks (``gather_params``) are held to it with that
test's tolerances: the first loss to 1e-3 relative, every param within
``2 * lr * steps`` plus one bf16 unit of its magnitude (the bound needs
the f32 master: bf16 params round at every step).

(ii) Mixtral-8x7B at full width and 16 of its 32 layers (the full depth
needs ~97 GB a card under this mesh; 16 layers ~49 GB of params,
gradients and Adam moments), ``remat="full"``, 3 steps of
``fused_adam(3e-4)`` (bf16 moments; f32 masters would not fit): finite
losses,
the same on every rank, printed with ms/step, each rank's
``max_memory_allocated`` and its state bytes (params, masters, moments).

``_worker`` also runs on the CPU (``device="cpu"``, gloo, a tiny config)
to rehearse a change before the cards.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.utils_mp import run_ranks

pytestmark = pytest.mark.cuda_sm90

LR = 3e-4
SEQ = 2048


def flagship(layers, remat):
    """The dense flagship (chip_smoke.flagship_config): vocab 32768,
    d2048, H16/Hkv4, d_ff 13312, bf16."""
    from horovod_tpu_torch.models import llama as tl

    return tl.LlamaConfig(vocab_size=32768, d_model=2048, n_layers=layers,
                          n_heads=16, n_kv_heads=4, d_ff=13312,
                          dtype="bfloat16", remat=remat,
                          param_dtype="bfloat16")


def mixtral(layers, remat):
    from horovod_tpu_torch.models import llama as tl

    return dataclasses.replace(tl.LlamaConfig.mixtral_8x7b(),
                               n_layers=layers, remat=remat,
                               dtype="bfloat16", param_dtype="bfloat16",
                               moe_impl="gshard")


MODELS = {"flagship": (flagship, dict(fsdp=2, tensor=2), 4),
          "mixtral": (mixtral, dict(expert=2, tensor=2), 2)}


def _batch(cfg, batch, seq):
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, 1))}


def _layers(cfg, device, seed=0):
    """The params of ``cfg`` one layer at a time: (the tree's non-layer
    leaves, a list of one-layer trees), drawn by ``llama_init`` of a
    one-layer config seeded ``seed + layer``."""
    from horovod_tpu_torch.models import llama as tl

    one = dataclasses.replace(cfg, n_layers=1)
    for layer in range(cfg.n_layers):
        gen = torch.Generator(device=device).manual_seed(seed + layer)
        yield tl.llama_init(one, gen, device=device)


def _stack(trees):
    """One tree from per-layer trees: the first's non-layer leaves, each
    layer leaf joined along its [L] dim."""
    first = trees[0]
    return {**{k: v for k, v in first.items() if k != "layers"},
            "layers": {k: torch.cat([t["layers"][k] for t in trees])
                       for k in first["layers"]}}


def params_blocks(cfg, mesh, device):
    """This rank's blocks of the seeded params, sharded layer by layer."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel.sharding import shard_params

    parts, specs = [], None
    for tree in _layers(cfg, device):
        block, specs = shard_params(tree, mesh, tl.llama_partition_rules())
        parts.append(block)
        del tree
    return _stack(parts), specs


def _host(tree):
    from horovod_tpu_torch.parallel._tree import tree_leaves

    return [t.detach().cpu() for t in tree_leaves(tree)]


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


def _state_bytes(carry):
    from horovod_tpu_torch.parallel._tree import tree_leaves

    params, opt = carry
    trees = [params, opt.mu, opt.nu, getattr(opt, "master", {})]
    return sum(t.numel() * t.element_size()
               for tree in trees for t in tree_leaves(tree))


OPTIMIZERS = {"master": "fused_master_adam", "adam": "fused_adam"}


def _worker(rank, size, model, layers, steps, remat, reference, optimizer,
            device=None, tiny=None, seq=SEQ):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.sharding import gather_params

    make, axes, batch_size = MODELS[model]
    mesh = mesh_mod.create_mesh(device=device, **axes)
    dev = mesh.device
    cfg = make(layers, remat) if tiny is None else dataclasses.replace(
        tiny, n_layers=layers, remat=remat)
    batch = _batch(cfg, batch_size, seq)
    local = {k: v.to(dev) for k, v in mesh.shard_batch(batch).items()}
    blocks, specs = params_blocks(cfg, mesh, dev.type)
    opt = getattr(precision, OPTIMIZERS[optimizer])
    ts = train_step.make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, cfg, mesh=mesh), opt(LR))
    carry = ts.init(blocks)
    del blocks
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        if cuda:
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        loss, carry = ts.step(carry, local)
        if cuda:
            t1.record()
            torch.cuda.synchronize()
            ms.append(t0.elapsed_time(t1))
        losses.append(float(loss))
    out = dict(losses=losses, ms_per_step=ms, state_bytes=_state_bytes(carry),
               n_layers=cfg.n_layers)
    if cuda:
        out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   card=torch.cuda.get_device_name(dev))
    if reference:
        params = gather_params(carry[0], mesh, specs)
        params = _host(params) if rank == 0 else None
        del carry, ts
        if cuda:
            torch.cuda.empty_cache()
        if rank == 0:
            ref = train_step.make_split_train_step(
                lambda p, d: tl.llama_loss(p, d, cfg, device=dev), opt(LR))
            rc = ref.init(_stack(list(_layers(cfg, dev.type))))
            full = {k: v.to(dev) for k, v in batch.items()}
            out["ref_losses"] = []
            for _ in range(steps):
                loss, rc = ref.step(rc, full)
                out["ref_losses"].append(float(loss))
            out["against_ref"] = _against(params, _host(rc[0]), steps)
    return out


class _Job:
    """A picklable ``_worker`` with its arguments bound."""

    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw

    def __call__(self, rank, size):
        return _worker(rank, size, *self.args, **self.kw)


def check_two_layers(got, label):
    """(i)'s checks on the four ranks' results; returns the line to
    print."""
    for g in got:
        assert g["losses"] == got[0]["losses"], label
    r0 = got[0]
    np.testing.assert_allclose(r0["losses"][0], r0["ref_losses"][0],
                               rtol=1e-3, err_msg=label)
    d = r0["against_ref"]
    assert d["excess"] <= 0, (label, d)
    return (f"{label} 2 layers: sharded losses {r0['losses']}, one-card "
            f"unsharded {r0['ref_losses']}; largest param difference "
            f"{d['worst']:.3e}, {d['differ']} of {d['total']} params differ; "
            f"ms/step {[[round(t, 1) for t in g['ms_per_step']] for g in got]}"
            f"; peak {[round(g.get('peak_gib', 0.0), 2) for g in got]} GiB; "
            f"{r0.get('card', 'cpu')}")


def _skip_without_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")


@pytest.mark.parametrize("model", ["flagship", "mixtral"])
def test_two_layers_match_the_one_card_unsharded_step(model):
    _skip_without_four_cards()
    got = run_ranks(_Job(model, 2, 2, "attn+gate", True, "master"), 4,
                    timeout=600)
    axes = " x ".join(f"{a}={n}" for a, n in MODELS[model][1].items())
    print(f"four cards, {model} under {axes}, "
          + check_two_layers(got, model))


def test_mixtral_8x7b_trains_on_four_cards():
    _skip_without_four_cards()
    got = run_ranks(_Job("mixtral", 16, 3, "full", False, "adam"), 4,
                    timeout=900)
    for g in got:
        assert g["losses"] == got[0]["losses"]
        assert all(np.isfinite(got[0]["losses"]))
    r0 = got[0]
    print(f"four cards, Mixtral-8x7B 16 of 32 layers under expert=2 x "
          f"tensor=2, remat=full, B2 x T{SEQ}: losses {r0['losses']}; "
          f"ms/step {[[round(t, 1) for t in g['ms_per_step']] for g in got]}"
          f"; peak {[round(g['peak_gib'], 2) for g in got]} GiB; state "
          f"{[g['state_bytes'] for g in got]} bytes a rank; {r0['card']}")
