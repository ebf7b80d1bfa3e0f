"""The port's ``DistributedOptimizer`` and broadcast helpers against the
reference ``horovod_tpu.torch`` and against one process on the full
batch, on 2 spawned CPU ranks (gloo).

- Diverged inits made equal by ``broadcast_parameters``, SGD on half a
  batch per rank for 3 steps: the port against the reference (rtol 1e-6,
  atol 1e-7) and both against one process on the full batch (rtol 1e-5,
  atol 1e-6: the averaged half-batch gradients sum in another order).
- ``backward_passes_per_step=2`` (the reference's analytic case),
  fp16 and bf16 compression, ``skip_synchronize`` with clipping,
  ``broadcast_optimizer_state`` (Adam), ``broadcast_object``,
  ``allgather_object``: the port against the reference.
- The port's Llama at a tiny config (2 layers, d 64) trained with
  ``DistributedOptimizer(torch.optim.Adam)`` over ``llama_loss`` for 3
  steps, its params broadcast from rank 0 first: equal to one process on
  the full batch (rtol 1e-4, atol 1e-6: Adam divides by the root of the
  squared gradients, which amplifies their rounding).
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_mp import run_ranks

BATCH = 8      # rows per rank


def _open(impl):
    if impl == "ref":
        import horovod_tpu.torch as hvd

        hvd.init()
    else:
        import horovod_tpu_torch.torch as hvd

        hvd.init(device="cpu")
    return hvd


def _model(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(10, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))


def _data(size):
    g = torch.Generator().manual_seed(1234)
    return (torch.randn(BATCH * size, 10, generator=g),
            torch.randn(BATCH * size, 4, generator=g))


def _params(model):
    return [p.detach().numpy().copy() for p in model.parameters()]


def _sgd_steps(model, opt, x, y, steps=3):
    for _ in range(steps):
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(x), y).backward()
        opt.step()


def _worker(rank, size, impl):
    hvd = _open(impl)
    out = {}
    try:
        x, y = _data(size)
        xs, ys = (t[rank * BATCH:(rank + 1) * BATCH] for t in (x, y))

        model = _model(7 + rank)           # diverged on purpose
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        out["broadcast_parameters"] = _params(model)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        out["is_sgd"] = isinstance(opt, torch.optim.SGD)
        _sgd_steps(model, opt, xs, ys)
        out["sgd_3_steps"] = _params(model)

        # Two backward passes, one step (the reference's analytic case).
        lin = torch.nn.Linear(4, 1, bias=False)
        with torch.no_grad():
            lin.weight.fill_(0.0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(lin.parameters(), lr=1.0),
            named_parameters=lin.named_parameters(),
            backward_passes_per_step=2)
        for i in range(2):
            lin(torch.full((1, 4), float(rank + 1 + i))).sum().backward()
        opt.step()
        out["backward_passes_2"] = _params(lin)

        for comp in ("fp16", "bf16"):
            model = _model(3 + rank)
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.05),
                named_parameters=model.named_parameters(),
                compression=getattr(hvd.Compression, comp))
            _sgd_steps(model, opt, xs, ys, steps=1)
            out[f"compression_{comp}"] = _params(model)

        # Clip the synchronized gradients, then step without a second
        # synchronize.
        model = _model(11)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        torch.nn.functional.mse_loss(model(xs), ys).backward()
        opt.synchronize()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 0.05)
        with opt.skip_synchronize():
            opt.step()
        out["skip_synchronize"] = _params(model)

        # Adam state from rank 0 (rank 1 took a different step first).
        model = _model(5)
        adam = torch.optim.Adam(model.parameters(), lr=1e-2)
        torch.nn.functional.mse_loss(model(xs), ys).backward()
        adam.step()
        if rank == 0:
            for group in adam.param_groups:
                group["lr"] = 0.5
        hvd.broadcast_optimizer_state(adam, root_rank=0)
        state = adam.state_dict()
        out["opt_state"] = [
            {k: v.numpy().copy() for k, v in s.items()}
            for _, s in sorted(state["state"].items())]
        out["opt_lr"] = adam.param_groups[0]["lr"]

        out["broadcast_object"] = hvd.broadcast_object(
            {"rank": rank, "list": [rank] * 3}, root_rank=1)
        out["allgather_object"] = hvd.allgather_object(("r", rank * 10))
        if impl == "port":
            out["llama"] = _llama_steps(hvd, rank, size)
        return out
    finally:
        hvd.shutdown()


def _llama_cfg():
    from horovod_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(dtype="float32", param_dtype="float32",
                            remat="none")


def _llama_batch(size):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2 * size, 16)).astype(np.int64)
    return tokens, np.roll(tokens, -1, 1)


def _llama_train(params, batches, cfg, opt):
    from horovod_tpu_torch.models.llama import llama_loss

    for tokens, targets in batches:
        opt.zero_grad()
        llama_loss(params, {"tokens": torch.from_numpy(tokens),
                            "targets": torch.from_numpy(targets)}, cfg,
                   device="cpu").backward()
        opt.step()


def _llama_steps(hvd, rank, size):
    """3 Adam steps of the tiny Llama on this rank's half of the batch."""
    from horovod_tpu_torch.models.llama import llama_init
    from horovod_tpu_torch.parallel._tree import tree_leaves

    cfg = _llama_cfg()
    params = llama_init(cfg, torch.Generator().manual_seed(100 + rank),
                        device="cpu")
    hvd.broadcast_parameters(params, root_rank=0)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = hvd.DistributedOptimizer(torch.optim.Adam(leaves, lr=1e-3))
    tokens, targets = _llama_batch(size)
    half = slice(2 * rank, 2 * rank + 2)
    _llama_train(params, [(tokens[half], targets[half])] * 3, cfg, opt)
    return [p.detach().numpy().copy() for p in leaves]


@pytest.fixture(scope="module")
def runs():
    ref = run_ranks(functools.partial(_worker, impl="ref"), 2, timeout=180)
    port = run_ranks(functools.partial(_worker, impl="port"), 2,
                     timeout=180)
    return ref, port


def _close(got, want, rtol, atol, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("key", [
    "broadcast_parameters", "sgd_3_steps", "backward_passes_2",
    "compression_fp16", "compression_bf16", "skip_synchronize"])
def test_matches_reference(runs, key):
    ref, port = runs
    for rank in range(2):
        _close(port[rank][key], ref[rank][key], 1e-6, 1e-7, key)
    # Every rank holds the same parameters after the step.
    _close(port[1][key], port[0][key], 0, 0, key)


def test_two_ranks_on_half_batches_match_one_on_the_full_batch(runs):
    _, port = runs
    x, y = _data(2)
    model = _model(7)
    _sgd_steps(model, torch.optim.SGD(model.parameters(), lr=0.1), x, y)
    for rank in range(2):
        _close(port[rank]["sgd_3_steps"], _params(model), 1e-5, 1e-6,
               "full batch")
    assert all(out["is_sgd"] for out in port)


def test_backward_passes_per_step_analytic(runs):
    _, port = runs
    # grad w = x, averaged over the 2 passes, then over the ranks.
    want = -np.mean([np.mean([r + 1, r + 2]) for r in range(2)])
    for out in port:
        np.testing.assert_allclose(out["backward_passes_2"][0],
                                   np.full((1, 4), want), rtol=1e-6)


def test_optimizer_state_and_objects_match_reference(runs):
    ref, port = runs
    for rank in range(2):
        for key in ("opt_lr", "broadcast_object", "allgather_object"):
            assert port[rank][key] == ref[rank][key], key
        for got, want in zip(port[rank]["opt_state"],
                             ref[rank]["opt_state"]):
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-7)
    assert port[1]["opt_lr"] == 0.5
    assert port[0]["broadcast_object"] == {"rank": 1, "list": [1, 1, 1]}
    assert port[0]["allgather_object"] == [("r", 0), ("r", 10)]


def test_llama_on_two_ranks_matches_the_full_batch(runs):
    from horovod_tpu_torch.models.llama import llama_init
    from horovod_tpu_torch.parallel._tree import tree_leaves

    _, port = runs
    cfg = _llama_cfg()
    params = llama_init(cfg, torch.Generator().manual_seed(100),
                        device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    tokens, targets = _llama_batch(2)
    _llama_train(params, [(tokens, targets)] * 3, cfg,
                 torch.optim.Adam(leaves, lr=1e-3))
    want = [p.detach().numpy() for p in leaves]
    for rank in range(2):
        _close(port[rank]["llama"], want, 1e-4, 1e-6, "llama")
    _close(port[1]["llama"], port[0]["llama"], 0, 0, "llama ranks")
