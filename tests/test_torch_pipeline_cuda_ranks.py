"""The ``pipe`` mesh axis across four H100s: Llama-3-8B trained through the
port's pipeline schedules (``horovod_tpu_torch/parallel/pipeline.py``)
over NCCL, one stage a card.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. Run it with ``python -m
pytest --noconftest tests/test_torch_pipeline_cuda_ranks.py -m cuda_sm90
-s`` (the repo's conftest imports jax, which the card machine lacks).
Each rank takes one card (``HOROVOD_LOCAL_RANK``), joins
``create_mesh(...)`` (NCCL groups), takes its blocks of the params (what
``shard_params(params, mesh, llama_partition_rules(pipeline=True,
virtual=V))`` gives it: for the interleaved schedule its V chunks in
device-major order) and its rows of one
seeded batch of B8 x T2048 (the batch is replicated over ``pipe`` and
``tensor``), cut into 8 microbatches of one row. The params are drawn in
bf16 one layer at a time from one seed (``llama_init`` of a one-layer
config seeded by the layer's index), as
``tests/test_torch_mesh_cuda_ranks.py`` draws them: a rank draws only
its stage's layers, and the one-card run the whole tree, from the same
seeds.

(i) Llama-3-8B cut to 8 layers, ``pipe=4`` (2 layers a stage, one a
chunk under the interleaved schedule), ``remat="attn+gate"``, gpipe,
``1f1b`` and ``interleaved_1f1b`` (V=2): the gradient of the loss at the
params, gathered from the four ranks (``gather_params``, the canonical
layer order restored), against the one-card unpipelined gradient on the
whole batch, leaf by leaf within ``GRAD_REL`` norm-relative, and the loss
within ``FIRST_LOSS_REL`` (the envelope of
``tests/test_torch_mesh_cuda_ranks.py``: bf16 rounds the stage's
activations and its microbatch gradients' sum in other places than the
one-card step's); the loss the same on every rank. Then 2 steps of
``fused_adam(3e-4)``, ms a step.

(ii) All 32 layers (8 a stage) under ``pipe=4`` with ``1f1b`` and with
``interleaved_1f1b`` (V=2), and under ``pipe=2 x tensor=2`` with
``1f1b``, ``remat="attn+gate"``: 3 steps of ``fused_adam(3e-4)``,
finite losses, the same on every rank, printed with ms a step, each
rank's ``max_memory_allocated`` and its state bytes (params and Adam
moments).

(iii) ``python -m horovod_tpu_torch.dryrun 4`` on the four cards (NCCL, a
card a rank): its nine passes that four ranks run, the three pipeline
passes among them, each against the port's unsharded step.

``_worker`` also runs on the CPU (``device="cpu"``, gloo, a tiny config)
to rehearse a change before the cards.
"""

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
BATCH = 8
GRAD_REL = 5e-2
FIRST_LOSS_REL = 1e-3
SCHEDULES = {"gpipe": ("gpipe", 1), "1f1b": ("1f1b", 1),
             "interleaved-v2": ("interleaved_1f1b", 2)}


def llama3_8b(layers, schedule, tiny=None):
    from horovod_tpu_torch.models import llama as tl

    sched, v = SCHEDULES[schedule]
    base = tiny or dataclasses.replace(tl.LlamaConfig.llama3_8b(),
                                       dtype="bfloat16",
                                       param_dtype="bfloat16")
    return dataclasses.replace(base, n_layers=layers, remat="attn+gate",
                               pipeline_schedule=sched,
                               pipeline_virtual_stages=v,
                               pipeline_microbatches=BATCH)


def _batch(cfg, seq):
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(np.roll(tokens, -1, 1))}


def _layer(cfg, layer, device):
    """Layer ``layer``'s one-layer tree (``llama_init`` seeded ``layer``;
    layer 0's also gives the embedding, final norm and lm_head)."""
    from horovod_tpu_torch.models import llama as tl

    gen = torch.Generator(device=device).manual_seed(layer)
    return tl.llama_init(dataclasses.replace(cfg, n_layers=1), gen,
                         device=device)


def _stack(head, layers):
    return {**head, "layers": {k: torch.cat([t[k] for t in layers])
                               for k in layers[0]}}


def _params(cfg, device):
    """The whole seeded tree, drawn one layer at a time (the one-card
    reference)."""
    layers, head = [], None
    for layer in range(cfg.n_layers):
        tree = _layer(cfg, layer, device)
        if head is None:
            head = {k: v for k, v in tree.items() if k != "layers"}
        layers.append(tree.pop("layers"))
        del tree
    return _stack(head, layers)


def _blocks(cfg, mesh, device):
    """This rank's blocks and the spec tree, drawn one layer at a time:
    only the layers of its stage (its V chunks in the interleaved
    schedule's device-major order), each cut over the other axes."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel.pipeline import _chunk_permutation
    from horovod_tpu_torch.parallel.sharding import (
        param_specs,
        shard_params,
    )

    S, stage = mesh.shape["pipe"], mesh.axis_index("pipe")
    per = cfg.n_layers // S
    rows = _chunk_permutation(cfg.n_layers, S,
                              cfg.pipeline_virtual_stages)[0]
    head, layers = None, []
    mine = [int(r) for r in rows[stage * per:(stage + 1) * per]]
    for layer in [0, *mine]:
        block, _ = shard_params(_layer(cfg, layer, device), mesh,
                                tl.llama_partition_rules())
        if head is None:
            head = {k: v for k, v in block.items() if k != "layers"}
        else:
            layers.append(block["layers"])
    blocks = _stack(head, layers)
    return blocks, param_specs(blocks, tl.llama_partition_rules(
        True, cfg.pipeline_virtual_stages))


def _state_bytes(carry):
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.zero import optimizer_state_bytes

    params, opt = carry
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)) \
        + optimizer_state_bytes(opt)


def _train(ts, carry, local, steps, dev):
    """``steps`` split steps: losses, ms a step (CUDA events on the
    card), state bytes, the peak and the card."""
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
    out = dict(losses=losses, ms_per_step=ms, state_bytes=_state_bytes(carry))
    if cuda:
        out.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   card=torch.cuda.get_device_name(dev))
    return out


def _grad_errors(got, want):
    """Each leaf's norm-relative difference, by '/'-joined path."""
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.sharding import _paths

    out = {}
    for name, a, b in zip(tree_leaves(_paths(want)), tree_leaves(got),
                          tree_leaves(want)):
        a, b = a.float(), b.float()
        out[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return out


def _worker(rank, size, axes, layers, schedules, steps, reference,
            device=None, tiny=None, seq=SEQ):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel.sharding import gather_params

    mesh = mesh_mod.create_mesh(device=device, **axes)
    dev = mesh.device
    out = {}
    for schedule in schedules:
        cfg = llama3_8b(layers, schedule, tiny)
        batch = _batch(cfg, seq)
        local = {k: v.to(dev) for k, v in mesh.shard_batch(batch).items()}
        blocks, specs = _blocks(cfg, mesh, dev.type)

        def loss_fn(p, d, cfg=cfg):
            return tl.llama_loss(p, d, cfg, mesh=mesh)

        row = {}
        if reference:
            loss, grads = train_step._value_and_grad(loss_fn, blocks, local,
                                                     1)
            grads = gather_params(grads, mesh, specs)
            row["loss"] = float(loss)
            if rank == 0:
                full = {k: v.to(dev) for k, v in batch.items()}
                ref_loss, ref = train_step._value_and_grad(
                    lambda p, d: tl.llama_loss(p, d, cfg, device=dev),
                    _params(cfg, dev.type), full, 1)
                row["ref_loss"] = float(ref_loss)
                row["grad_errors"] = _grad_errors(grads, ref)
                del ref
            del grads
        ts = train_step.make_split_train_step(loss_fn,
                                              precision.fused_adam(LR))
        row.update(_train(ts, ts.init(blocks), local, steps, dev))
        del ts, blocks
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[schedule] = row
    return out


class _Job:
    """A picklable ``_worker`` with its arguments bound."""

    def __init__(self, *args, **kw):
        self.args, self.kw = args, kw

    def __call__(self, rank, size):
        return _worker(rank, size, *self.args, **self.kw)


def check_reference(got, schedule):
    """(i)'s checks on the four ranks' results: the line to print."""
    rows = [g[schedule] for g in got]
    for r in rows:
        assert r["loss"] == rows[0]["loss"], schedule
        assert r["losses"] == rows[0]["losses"], schedule
    r0 = rows[0]
    loss_err = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    errs = r0["grad_errors"]
    worst = max(errs, key=errs.get)
    line = (f"{schedule}: loss {r0['loss']:.6f}, one-card unpipelined "
            f"{r0['ref_loss']:.6f} (relative {loss_err:.3e}, tol "
            f"{FIRST_LOSS_REL}); gradient leaves within {errs[worst]:.3e} "
            f"norm-relative (worst {worst}; "
            f"{sorted(errs.items(), key=lambda kv: -kv[1])[:4]}); "
            f"step losses {r0['losses']}; ms/step "
            f"{[[round(t, 1) for t in r[ 'ms_per_step']] for r in rows]}; "
            f"peak {[round(r.get('peak_gib', 0.0), 2) for r in rows]} GiB; "
            f"{r0.get('card', 'cpu')}")
    assert loss_err <= FIRST_LOSS_REL, line
    assert errs[worst] <= GRAD_REL, line
    return line


def check_trains(got, schedule, label):
    """(ii)'s checks: finite losses, the same on every rank."""
    rows = [g[schedule] for g in got]
    for r in rows:
        assert r["losses"] == rows[0]["losses"], label
    assert all(np.isfinite(rows[0]["losses"])), label
    return (f"{label}: losses {rows[0]['losses']}; ms/step "
            f"{[[round(t, 1) for t in r['ms_per_step']] for r in rows]}; "
            f"peak {[round(r['peak_gib'], 2) for r in rows]} GiB; state "
            f"{[r['state_bytes'] for r in rows]} bytes a rank; "
            f"{rows[0]['card']}")


def _skip_without_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")


def test_eight_layers_match_the_one_card_unpipelined_step():
    _skip_without_four_cards()
    got = run_ranks(_Job(dict(pipe=4), 8, list(SCHEDULES), 2, True), 4,
                    timeout=900)
    for schedule in SCHEDULES:
        print("four cards, Llama-3-8B 8 layers under pipe=4, B8 x T2048 as "
              "8 microbatches, remat=attn+gate, fused_adam(3e-4), "
              + check_reference(got, schedule))


@pytest.mark.parametrize("axes,schedules", [
    (dict(pipe=4), ["1f1b", "interleaved-v2"]),
    (dict(pipe=2, tensor=2), ["1f1b"])])
def test_llama3_8b_trains_pipelined(axes, schedules):
    _skip_without_four_cards()
    got = run_ranks(_Job(axes, 32, schedules, 3, False), 4, timeout=900)
    shape = " x ".join(f"{a}={n}" for a, n in axes.items())
    for schedule in schedules:
        print("four cards, " + check_trains(
            got, schedule, f"Llama-3-8B 32 layers under {shape}, "
            f"{schedule}, B8 x T{SEQ} as 8 microbatches, remat=attn+gate, "
            "fused_adam(3e-4)"))


def test_dryrun_runs_its_pipeline_passes_on_four_cards():
    _skip_without_four_cards()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.dryrun", "4"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    print(proc.stdout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "dryrun_multichip: 4 CUDA cards (NCCL)", lines[0]
    ran = [line for line in lines if line.startswith("dryrun_multichip[")
           and "skipped" not in line]
    assert len(ran) == 9 and all(" ok (" in line for line in ran), ran
    assert sum("'pipe': 2" in line for line in ran) == 3, ran
