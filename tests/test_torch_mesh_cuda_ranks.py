"""The ``tensor``, ``fsdp`` and ``expert`` mesh axes across four H100s:
the dense flagship under ``fsdp=2 x tensor=2``, Mixtral-8x7B under
``expert=2 x tensor=2`` with the GShard dispatch and under ``fsdp=2 x
tensor=2`` with the dropless grouped dispatch (K5/K6 on each rank's F/2
block of every expert), Llama-3-8B with ``fused_master_adam`` under
``data=2 x tensor=2`` with ZeRO-1 over ``data``, and BERT-Large under
``fsdp=2 x tensor=2``.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. Each rank takes one card
(``HOROVOD_LOCAL_RANK``), joins ``create_mesh(...)`` (NCCL groups), takes
its blocks of the params (``shard_params(params, mesh, rules)``) and
trains them through ``make_split_train_step(loss(mesh=), ...)``: its
share of one seeded batch (the flagship's B4 x T2048 split over
``fsdp``; Mixtral's B2 x T2048 whole on every rank under ``expert`` x
``tensor``, split over ``fsdp`` under ``fsdp`` x ``tensor``; Llama-3-8B's
B2 x T2048 split over ``data``; BERT-Large's B16 x T512, seeded padding,
split over ``fsdp``). The Llama params are drawn in bf16 one layer at a
time from one seed on every rank (``llama_init`` of a one-layer config,
seed + layer), so no rank ever holds a whole deep tree.

(i) 2 layers, 2 steps of ``fused_master_adam(3e-4)`` (f32 masters, as
``tests/test_torch_zero_cuda_ranks.py`` (i)), each Llama-family model
(the grouped Mixtral under ``remat="moe"``, the others ``attn+gate``;
Llama-3-8B's state sharded by ZeRO-1): the loss is the same on every
rank. Before the first step each rank takes the gradient of the loss at
its blocks (every sum over the mesh's axes included) and the four
ranks' gradients are gathered (``gather_params``). Rank 0 then takes
the one-card unsharded gradient at the same params on the whole batch
and runs the one-card unsharded split step (replicated state) from
them. Held to it: every gradient leaf within ``GRAD_REL`` of the
one-card leaf, norm-relative (|g - g1| / |g1|; ``GRAD_REL_MOE`` for the
Mixtral cases, where bf16 rounding flips the top-2 experts of some
tokens between the sharded and the one-card forward, and each flip
moves a token's whole contribution between experts: the share of
tokens whose choice differs is printed and held to ``FLIPS_MAX``);
the first loss within ``FIRST_LOSS_REL`` of the one card's, relative
to itself, and each later one within ``LOSS_REL`` of how far the one
card's loss moved from the first (Adam moves each entry by about lr a
step whatever the gradient, so the params alone cannot tell a wrong
gradient from a right one); and every param gathered from the four
ranks' blocks within ``2 * lr * steps`` plus one bf16 unit of its
magnitude (the bound needs the f32 master: bf16 params round at every
step). BERT-Large at full depth (24 layers, f32 params, bf16 compute,
full remat), 2 steps of ``fused_adam(1e-4)``, is held to its one-card
step the same way. The limits are set from sound runs on four H100s
(``PERF.md``); a dropped ``replicate`` over ``tensor`` or a dropped
batch-axis sum gives gradient errors of 0.44-0.87 (the CPU's tiny
rehearsal below).

(ii) At full width and a depth one card could not hold: Mixtral-8x7B,
16 of its 32 layers (the full depth needs ~97 GB a card; 16 layers ~49
GB of params, gradients and Adam moments), ``remat="full"``, 3 steps of
``fused_adam(3e-4)`` (bf16 moments; f32 masters would not fit), under
each dispatch; Llama-3-8B, all 32 layers, ``remat="full"``, 3 steps of
``fused_master_adam(3e-4)`` with ZeRO-1: finite losses, the same on
every rank, printed with ms/step, each rank's ``max_memory_allocated``
and its state bytes (params, masters, moments).

(iii) ``python -m horovod_tpu_torch.dryrun 4`` on the four cards (NCCL,
a card a rank): its nine passes that four ranks run (the three
pipeline passes among them), each against the
port's unsharded step.

``_worker`` and ``_bert_worker`` also run on the CPU (``device="cpu"``,
gloo, a tiny config) to rehearse a change before the cards.
"""

import contextlib
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.utils_mp import REPO_ROOT, run_ranks

pytestmark = pytest.mark.cuda_sm90

LR = 3e-4
SEQ = 2048
# The limits of (i) (see the module docstring), set from sound runs on
# four H100s: dense gradient leaves <= 3.07e-2 norm-relative, Mixtral's
# <= 1.28e-1 (about the square root of the share of tokens whose experts
# flipped in the second layer, 1.22e-2 and 1.64e-2: the flipped tokens'
# contributions add incoherently), first losses <= 7.6e-5 relative,
# later ones <= 1.10e-2 of the one card's move. A dropped replicate or
# batch-axis sum gives 0.44-0.87 (the CPU's tiny bf16 rehearsal).
GRAD_REL = 5e-2
GRAD_REL_MOE = 2e-1
FLIPS_MAX = 5e-2
FIRST_LOSS_REL = 1e-3
LOSS_REL = 3e-2


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


def mixtral_grouped(layers, remat):
    return dataclasses.replace(mixtral(layers, remat), moe_impl="grouped")


def llama3_8b(layers, remat):
    from horovod_tpu_torch.models import llama as tl

    return dataclasses.replace(tl.LlamaConfig.llama3_8b(), n_layers=layers,
                               remat=remat, dtype="bfloat16",
                               param_dtype="bfloat16")


MODELS = {"flagship": (flagship, dict(fsdp=2, tensor=2), 4),
          "mixtral": (mixtral, dict(expert=2, tensor=2), 2),
          "mixtral-grouped": (mixtral_grouped, dict(fsdp=2, tensor=2), 2),
          "llama3-8b-zero": (llama3_8b, dict(data=2, tensor=2), 2)}
# The models whose optimizer state ZeRO-1 shards over ``data``.
ZERO = ("llama3-8b-zero",)
# (i)'s remat mode a model: the grouped dispatch saves its expert chain.
TWO_LAYER_REMAT = {"mixtral-grouped": "moe"}


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


def _against(got, want, steps, lr=LR):
    """How far the params ``got`` lie from ``want``: the largest
    difference, the largest excess over the module docstring's bound
    (<= 0 passes), and how many entries differ at all."""
    worst, excess, differ, total = 0.0, -np.inf, 0, 0
    for a, b in zip(got, want):
        za, zb = a.float(), b.float()
        err = (za - zb).abs()
        ulp = torch.maximum(za.abs(), zb.abs()) * 2.0 ** -7
        excess = max(excess, (err - 2 * lr * steps - ulp).max().item())
        worst = max(worst, err.max().item())
        differ += int((a != b).sum())
        total += a.numel()
    return dict(worst=worst, excess=excess, differ=differ, total=total)


def _grad(loss_fn, params, batch):
    """The gradient of ``loss_fn`` at ``params`` on ``batch``, before
    any update: the first step's (under a mesh with every sum over its
    axes, none deferred)."""
    from horovod_tpu_torch.parallel.train_step import _value_and_grad

    return _value_and_grad(loss_fn, params, batch, 1)[1]


@contextlib.contextmanager
def _routing_log(log):
    """While open, every call of the router (``llama._route``, which both
    dispatches use) appends its top-k choice, each token's experts
    sorted, as [tokens, k] on the host."""
    from horovod_tpu_torch.models import llama as tl

    route = tl._route

    def recording(h, router_w, k):
        out = route(h, router_w, k)
        log.append(out[1].detach().reshape(-1, k).sort(-1).values.cpu())
        return out

    tl._route = recording
    try:
        yield log
    finally:
        tl._route = route


def _flips(sharded, one_card, layers):
    """Per layer, the share of this rank's tokens (the first rows of the
    batch on rank 0) whose experts differ from the one-card forward's."""
    return [float((a != b[:len(a)]).any(-1).float().mean())
            for a, b in zip(sharded[:layers], one_card[:layers])]


def _named(tree):
    """``tree``'s leaves on the host, by '/'-joined path."""
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.sharding import _paths

    return dict(zip(tree_leaves(_paths(tree)), _host(tree)))


def _grad_errors(got, want, dev):
    """Each leaf's norm-relative difference |got - want| / |want| (``got``
    the gathered sharded gradient by path, ``want`` the one-card one),
    computed on ``dev`` a leaf at a time."""
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.sharding import _paths

    out = {}
    for name, w in zip(tree_leaves(_paths(want)), tree_leaves(want)):
        a, b = got[name].to(dev).float(), w.detach().float()
        out[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
        del a, b
    return out


def _state_bytes(carry):
    """The bytes of a rank's params and optimizer state (moments and
    masters, replicated or ZeRO's shards)."""
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.zero import optimizer_state_bytes

    params, opt = carry
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)) \
        + optimizer_state_bytes(opt)


OPTIMIZERS = {"master": "fused_master_adam", "adam": "fused_adam"}


def _worker(rank, size, model, layers, steps, remat, reference, optimizer,
            device=None, tiny=None, seq=SEQ):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.sharding import gather_params
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    make, axes, batch_size = MODELS[model]
    mesh = mesh_mod.create_mesh(device=device, **axes)
    dev = mesh.device
    cfg = make(layers, remat) if tiny is None else dataclasses.replace(
        tiny, n_layers=layers, remat=remat)
    batch = _batch(cfg, batch_size, seq)
    local = {k: v.to(dev) for k, v in mesh.shard_batch(batch).items()}
    blocks, specs = params_blocks(cfg, mesh, dev.type)

    def loss_fn(p, d):
        return tl.llama_loss(p, d, cfg, mesh=mesh)

    grads, routes = None, []
    if reference:
        with _routing_log(routes):
            grads = _grad(loss_fn, blocks, local)
        grads = gather_params(grads, mesh, specs)
        grads = _named(grads) if rank == 0 else None
    opt = getattr(precision, OPTIMIZERS[optimizer])
    ts = train_step.make_split_train_step(
        loss_fn, opt(LR),
        zero=ZeroConfig(mesh=mesh) if model in ZERO else None)
    carry = ts.init(blocks)
    del blocks
    out = _train(ts, carry, local, steps, dev)
    out["n_layers"] = cfg.n_layers
    if reference:
        params = gather_params(out.pop("carry")[0], mesh, specs)
        params = _host(params) if rank == 0 else None
        del ts
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            def ref_loss(p, d):
                return tl.llama_loss(p, d, cfg, device=dev)

            ref = train_step.make_split_train_step(ref_loss, opt(LR))
            full = {k: v.to(dev) for k, v in batch.items()}
            init = _stack(list(_layers(cfg, dev.type)))
            one_card = []
            with _routing_log(one_card):
                ref_grads = _grad(ref_loss, init, full)
            out["grad_errors"] = _grad_errors(grads, ref_grads, dev)
            del ref_grads
            if cfg.n_experts:
                out["flips"] = _flips(routes, one_card, cfg.n_layers)
            del grads
            rc = ref.init(init)
            del init
            out["ref_losses"] = []
            for _ in range(steps):
                loss, rc = ref.step(rc, full)
                out["ref_losses"].append(float(loss))
            out["against_ref"] = _against(params, _host(rc[0]), steps)
    out.pop("carry", None)
    return out


def _train(ts, carry, local, steps, dev):
    """``steps`` split steps: losses, ms a step (CUDA events on the
    card), the state bytes, the peak and the card, and the carry."""
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
               carry=carry)
    if cuda:
        out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   card=torch.cuda.get_device_name(dev))
    return out


BERT_LR = 1e-4


def _bert_batch(cfg, batch, seq):
    """B x T tokens and targets, seeded padding (lengths in [T/4, T]) and
    ~15% of the real tokens predicted."""
    rng = np.random.default_rng(9)
    lengths = rng.integers(seq // 4, seq + 1, batch)
    mask = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.int32)
    mlm = ((rng.random((batch, seq)) < 0.15) * mask).astype(np.float32)
    mlm[:, 0] = 1.0
    return {k: torch.from_numpy(v) for k, v in (
        ("tokens", rng.integers(0, cfg.vocab_size, (batch, seq))),
        ("targets", rng.integers(0, cfg.vocab_size, (batch, seq))),
        ("mlm_mask", mlm), ("attention_mask", mask))}


def _bert_worker(rank, size, layers, steps, reference, device=None,
                 tiny=None, batch=16, seq=512):
    """BERT-Large (or ``tiny``) under ``fsdp=2 x tensor=2``: ``steps``
    split steps of ``fused_adam(1e-4)`` on this rank's rows and blocks,
    and with ``reference`` rank 0's one-card step on the whole batch."""
    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.sharding import gather_params, shard_params

    mesh = mesh_mod.create_mesh(device=device, fsdp=2, tensor=2)
    dev = mesh.device
    cfg = dataclasses.replace(tiny or bert.BertConfig.large(),
                              n_layers=layers)

    def init():
        return bert.bert_init(cfg, torch.Generator(device=dev.type)
                              .manual_seed(0), device=dev)

    blocks, specs = shard_params(init(), mesh, bert.bert_partition_rules())
    data = _bert_batch(cfg, batch, seq)
    local = {k: v.to(dev) for k, v in
             mesh.shard_batch(data, seq_dim=None).items()}

    def loss_fn(p, d):
        return bert.bert_mlm_loss(p, d, cfg, mesh=mesh)

    grads = None
    if reference:
        grads = gather_params(_grad(loss_fn, blocks, local), mesh, specs)
        grads = _named(grads) if rank == 0 else None
    ts = train_step.make_split_train_step(loss_fn,
                                          precision.fused_adam(BERT_LR))
    out = _train(ts, ts.init(blocks), local, steps, dev)
    del blocks
    out["n_layers"] = layers
    params = gather_params(out.pop("carry")[0], mesh, specs) \
        if reference else None
    if reference and rank == 0:
        params = _host(params)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        def ref_loss(p, d):
            return bert.bert_mlm_loss(p, d, cfg, device=dev)

        ref = train_step.make_split_train_step(
            ref_loss, precision.fused_adam(BERT_LR))
        full = {k: v.to(dev) for k, v in data.items()}
        start = init()
        out["grad_errors"] = _grad_errors(grads, _grad(ref_loss, start, full),
                                          dev)
        del grads
        rc = ref.init(start)
        del start
        out["ref_losses"] = []
        for _ in range(steps):
            loss, rc = ref.step(rc, full)
            out["ref_losses"].append(float(loss))
        out["against_ref"] = _against(params, _host(rc[0]), steps, BERT_LR)
    return out


class _Job:
    """A picklable ``_worker`` (or ``fn``) with its arguments bound."""

    def __init__(self, *args, fn=None, **kw):
        self.args, self.kw, self.fn = args, kw, fn

    def __call__(self, rank, size):
        return (self.fn or _worker)(rank, size, *self.args, **self.kw)


def check_two_layers(got, label, layers=2):
    """(i)'s checks on the four ranks' results; returns the line to
    print."""
    for g in got:
        assert g["losses"] == got[0]["losses"], label
    r0 = got[0]
    losses, ref = r0["losses"], r0["ref_losses"]
    loss_err = [abs(losses[0] - ref[0]) / abs(ref[0])] + [
        abs(a - b) / abs(ref[0] - b) for a, b in zip(losses[1:], ref[1:])]
    grad_err = r0["grad_errors"]
    worst = max(grad_err, key=grad_err.get)
    flips = r0.get("flips")
    line = (f"{label} {layers} layers: sharded losses {losses}, one-card "
            f"unsharded {ref} (loss errors {loss_err}); gradient leaves "
            f"within {grad_err[worst]:.3e} norm-relative (worst {worst}; "
            f"{sorted(grad_err.items(), key=lambda kv: -kv[1])[:6]})"
            + (f"; top-2 experts differ for {flips} of rank 0's tokens "
               "by layer" if flips is not None else ""))
    assert loss_err[0] <= FIRST_LOSS_REL, line
    assert max(loss_err[1:]) <= LOSS_REL, line
    assert grad_err[worst] <= (GRAD_REL if flips is None
                               else GRAD_REL_MOE), line
    assert flips is None or max(flips) <= FLIPS_MAX, line
    d = r0["against_ref"]
    assert d["excess"] <= 0, (label, d)
    return (f"{line}; largest param "
            f"difference {d['worst']:.3e}, {d['differ']} of {d['total']} "
            f"params differ; ms/step "
            f"{[[round(t, 1) for t in g['ms_per_step']] for g in got]}"
            f"; peak {[round(g.get('peak_gib', 0.0), 2) for g in got]} GiB; "
            f"state {[g['state_bytes'] for g in got]} bytes a rank; "
            f"{r0.get('card', 'cpu')}")


def check_trains(got, label):
    """(ii)'s checks: finite losses, the same on every rank; returns the
    line to print."""
    for g in got:
        assert g["losses"] == got[0]["losses"], label
    assert all(np.isfinite(got[0]["losses"])), label
    r0 = got[0]
    return (f"{label}: losses {r0['losses']}; ms/step "
            f"{[[round(t, 1) for t in g['ms_per_step']] for g in got]}; "
            f"peak {[round(g['peak_gib'], 2) for g in got]} GiB; state "
            f"{[g['state_bytes'] for g in got]} bytes a rank; {r0['card']}")


def _skip_without_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")


def _axes(model):
    return " x ".join(f"{a}={n}" for a, n in MODELS[model][1].items())


@pytest.mark.parametrize("model", ["flagship", "mixtral", "mixtral-grouped",
                                   "llama3-8b-zero"])
def test_two_layers_match_the_one_card_unsharded_step(model):
    _skip_without_four_cards()
    got = run_ranks(_Job(model, 2, 2, TWO_LAYER_REMAT.get(model, "attn+gate"),
                         True, "master"), 4, timeout=600)
    print(f"four cards, {model} under {_axes(model)}, "
          + check_two_layers(got, model))


def test_mixtral_8x7b_trains_on_four_cards():
    _skip_without_four_cards()
    got = run_ranks(_Job("mixtral", 16, 3, "full", False, "adam"), 4,
                    timeout=900)
    print("four cards, " + check_trains(
        got, f"Mixtral-8x7B 16 of 32 layers under {_axes('mixtral')}, "
             f"GShard, remat=full, B2 x T{SEQ}"))


def test_mixtral_8x7b_grouped_trains_under_fsdp_tensor():
    _skip_without_four_cards()
    got = run_ranks(_Job("mixtral-grouped", 16, 3, "full", False, "adam"), 4,
                    timeout=900)
    print("four cards, " + check_trains(
        got, f"Mixtral-8x7B 16 of 32 layers under "
             f"{_axes('mixtral-grouped')}, grouped (K5/K6), remat=full, "
             f"B2 x T{SEQ}"))


def test_llama3_8b_zero_trains_under_data_tensor():
    _skip_without_four_cards()
    got = run_ranks(_Job("llama3-8b-zero", 32, 3, "full", False, "master"),
                    4, timeout=900)
    print("four cards, " + check_trains(
        got, f"Llama-3-8B 32 layers under {_axes('llama3-8b-zero')}, "
             f"fused_master_adam, ZeRO-1 over data, remat=full, B2 x T{SEQ}"))


def test_bert_large_matches_the_one_card_step():
    _skip_without_four_cards()
    got = run_ranks(_Job(24, 2, True, fn=_bert_worker), 4, timeout=600)
    print("four cards, BERT-Large under fsdp=2 x tensor=2, B16 x T512, "
          "seeded padding, fused_adam(1e-4), full remat, "
          + check_two_layers(got, "BERT-Large", 24))


def test_dryrun_runs_on_four_cards():
    _skip_without_four_cards()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.dryrun", "4"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    print(proc.stdout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "dryrun_multichip: 4 CUDA cards (NCCL)", lines[0]
    ran = [l for l in lines if l.startswith("dryrun_multichip[")
           and "skipped" not in l and "waiting" not in l]
    assert len(ran) == 9 and all(" ok (" in l for l in ran), ran
