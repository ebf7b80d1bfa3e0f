"""The port's pipeline schedules (``horovod_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``horovod_tpu/parallel/pipeline.py``).

On ``LlamaConfig.tiny(dtype="float32", n_layers=4)`` (and ``tiny_moe``),
B4 x T16, from one JAX-initialised tree moved bit for bit by
``from_jax_params`` and numpy-made batches, with and without a mask:

- Schedule tables (host only): ``build_interleaved_schedule`` equal to
  JAX's, table for table, over a grid of (S, V, M), ragged M included;
  ``_chunk_permutation`` equal; the slot plans the port walks place
  every subtick of the tables.
- In-process transport (no spawn): ``llama_loss`` through gpipe,
  ``1f1b`` and ``interleaved_1f1b`` V=1 and V=2 with all stages in this
  process, against JAX's gpipe / ``one_f_one_b`` /
  ``interleaved_one_f_one_b`` on its 8-device CPU mesh (``pipe=2 x
  fsdp=2 x tensor=2``, as ``tests/single/test_pipeline_1f1b.py:57``
  builds it), with the flash forward (K1) launched as the schedule
  predicts: once per (layer, microbatch) forward, once more per
  backward recompute, none in a bubble slot.
- One spawned gloo world of 8 ranks for every multi-rank case, each rank
  one stage of a real ``pipe`` axis: gpipe's logits
  (``tests/single/test_llama.py:268``) and its SGD step (``:287``);
  ``1f1b`` and interleaved V=2 under ``pipe=2 x fsdp=2 x tensor=2``;
  ``tiny_moe`` with its aux loss under ``pipe=2 x expert=2 x tensor=2``
  (``test_pipeline_1f1b.py:85``, ``test_pipeline_interleaved.py:157``)
  and under ``pipe=2 x fsdp=2 x expert=2``;
  the ragged microbatch remainder (M=6 with S*V=4) against the unsharded
  JAX step; ``make_split_train_step`` with 2 microbatches over the
  interleaved loss (``test_pipeline_interleaved.py:248``); and the
  value-only routing (``test_pipeline_interleaved.py:211``). That JAX
  test is red on the JAX package's CPU run, so the port's counterpart
  counts its own engine calls (none for a value-only call, one for a
  grad call) and holds the value to JAX's ``llama_loss`` called directly
  on its mesh (``jax.value_and_grad`` of it, whose value the JAX
  package's 1F1B tests hold to its value-only call).

Tolerances are the JAX tests' own: the loss to rtol 1e-5, every gradient
leaf to rtol 2e-4 and atol 1e-6 (the schedules sum the microbatches'
gradients in another order), logits 1e-4, SGD params rtol 1e-4 atol 1e-6.
JAX cuts the global batch into the microbatches; the MoE under ``pipe=2
x fsdp=2 x expert=2`` (gpipe, ``1f1b`` with and without a mask) holds
the port's regrouped rows to it, since its aux loss is taken over each
microbatch's tokens; interleaved V=2 there, whose JAX program aborts on
the CPU, is held to the port's ``1f1b`` on the same world.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_mp import lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")

B, T, L = 4, 16, 4
MARGIN = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    return t.detach().float().numpy()


def _jax_cfg(moe=False, **kw):
    from horovod_tpu.models import llama as jl

    if moe:
        return jl.LlamaConfig.tiny_moe(dtype="float32", n_layers=L,
                                       remat=False, moe_impl="gshard", **kw)
    return jl.LlamaConfig.tiny(dtype="float32", n_layers=L, remat=False,
                               **kw)


def _port_cfg(moe=False, **kw):
    from horovod_tpu_torch.models import llama as tl

    kw.setdefault("remat", "none")
    if moe:
        return tl.LlamaConfig.tiny_moe(dtype="float32", n_layers=L,
                                       moe_impl="gshard", **kw)
    return tl.LlamaConfig.tiny(dtype="float32", n_layers=L, **kw)


@functools.cache
def _params(moe=False):
    from horovod_tpu.models import llama as jl

    return jax.tree.map(np.asarray, jl.llama_init(_jax_cfg(moe),
                                                  jax.random.PRNGKey(0)))


@functools.cache
def _batch(rows=B, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (rows, T)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
            "mask": (rng.random((rows, T)) > 0.3).astype(np.float32)}


def _take(batch, mask):
    return batch if mask else {k: v for k, v in batch.items()
                               if k != "mask"}


# Each case: (schedule, virtual stages, microbatches).
CASES = {"gpipe": ("gpipe", 1, 2), "1f1b": ("1f1b", 1, 2),
         "interleaved-v1": ("interleaved_1f1b", 1, 4),
         "interleaved-v2": ("interleaved_1f1b", 2, 2)}


def _schedule(case):
    sched, v, m = CASES[case]
    return dict(pipeline_schedule=sched, pipeline_virtual_stages=v,
                pipeline_microbatches=m)


# ---- JAX's side -------------------------------------------------------------


def _jax_mesh(**axes):
    from horovod_tpu import parallel

    return parallel.create_mesh(devices=jax.devices()[:8], **axes)


def _jax_sharded(jparams, batch, mesh):
    from horovod_tpu import parallel
    from horovod_tpu.models import llama as jl
    from horovod_tpu.parallel.sharding import apply_sharding, named_sharding

    p_sh = apply_sharding(jparams, parallel.shard_params(
        jparams, mesh, jl.llama_partition_rules(pipeline=True)))
    b_sh = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                          named_sharding(mesh, ("data", "fsdp"), "seq"))
    return p_sh, b_sh


# The MoE meshes: experts over tensor, and experts under fsdp (two batch
# ranks, so JAX's global microbatches differ from each rank's rows).
MOE_AXES = {"tensor": dict(pipe=2, expert=2, tensor=2),
            "fsdp": dict(pipe=2, fsdp=2, expert=2)}


@functools.cache
def _jax_pipelined(case, mask, moe=False, moe_axes="tensor"):
    """JAX's loss and gradients through the case's schedule on its mesh
    (``pipe=2 x fsdp=2 x tensor=2``, or ``MOE_AXES[moe_axes]`` for the
    MoE)."""
    from horovod_tpu.models import llama as jl

    cfg = _jax_cfg(moe, **_schedule(case))
    mesh = _jax_mesh(**MOE_AXES[moe_axes]) if moe else \
        _jax_mesh(pipe=2, fsdp=2, tensor=2)
    p_sh, b_sh = _jax_sharded(_params(moe), _take(_batch(), mask), mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jl.llama_loss(p, b_sh, cfg, mesh)))(p_sh)
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()}


@functools.cache
def _jax_unsharded(rows, mask):
    from horovod_tpu.models import llama as jl

    batch = {k: jnp.asarray(v) for k, v in _take(_batch(rows), mask).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jl.llama_loss(p, batch, _jax_cfg())))(_params())
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()}


def _assert_grads(got, want, what="", atol=1e-6):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-4, atol=atol,
                                   err_msg=f"{what} {k}")


# ---- schedule tables (host only) --------------------------------------------


GRID = [(S, V, M) for S in (1, 2, 3, 4) for V in (1, 2, 3) for M in
        (1, 2, 3, 4, 5, 6, 8)]


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_interleaved_tables_equal_jax(S):
    from horovod_tpu.parallel import pipeline as jp
    from horovod_tpu_torch.parallel import pipeline as tp

    for s, V, M in GRID:
        if s != S:
            continue
        got, want = tp.build_interleaved_schedule(S, V, M), \
            jp.build_interleaved_schedule(S, V, M)
        assert got._fields == want._fields
        for name, a, b in zip(got._fields, got, want):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (S, V, M, name)
                np.testing.assert_array_equal(a, b, err_msg=f"{S,V,M}{name}")
            else:
                assert a == b, (S, V, M, name)
        assert got.bubble_fraction == want.bubble_fraction


def test_chunk_permutation_equals_jax():
    from horovod_tpu.parallel import pipeline as jp
    from horovod_tpu_torch.parallel import pipeline as tp

    for n, S, V in [(4, 2, 2), (8, 2, 2), (8, 4, 2), (12, 2, 3), (32, 4, 2),
                    (6, 3, 1)]:
        for a, b in zip(tp._chunk_permutation(n, S, V),
                        jp._chunk_permutation(n, S, V)):
            np.testing.assert_array_equal(a, b)
    for mod in (tp, jp):
        with pytest.raises(ValueError, match="must divide"):
            mod._chunk_permutation(6, 2, 2)


@pytest.mark.parametrize("n,S,V", [(4, 2, 2), (8, 4, 2), (12, 2, 3)])
def test_interleaved_spec_hands_out_the_chunk_permutation(n, S, V):
    """``llama_partition_rules(pipeline=True, virtual=V)`` gives stage s
    the rows of JAX's device-major stack (``_chunk_permutation``), s's
    block; the entry is the axis name elsewhere and pickles whole."""
    import pickle
    import types

    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import pipeline as tp
    from horovod_tpu_torch.parallel.sharding import leaf_block, param_specs

    x = torch.arange(n * 3.0).reshape(n, 3)
    spec = param_specs({"layers": {"attn_norm": x}}, tl.llama_partition_rules(
        True, V))["layers"]["attn_norm"]
    assert spec.entry(0) == ("pipe",) and "pipe" in spec.axes()
    assert pickle.loads(pickle.dumps(spec[0])).virtual == V
    order = tp._chunk_permutation(n, S, V)[0]
    for s in range(S):
        mesh = types.SimpleNamespace(shape={"pipe": S}, coords={"pipe": s})
        rows = order[s * n // S:(s + 1) * n // S]
        torch.testing.assert_close(leaf_block(x, spec, mesh),
                                   x[torch.as_tensor(rows)], rtol=0, atol=0)


@pytest.mark.parametrize("S,V,M", [(2, 2, 4), (4, 2, 8), (2, 2, 3),
                                   (4, 2, 9), (3, 2, 5), (4, 1, 8)])
def test_plans_place_every_subtick(S, V, M):
    """The port walks the tables as slot plans: every (stage, chunk,
    microbatch) forward and backward once, a backward after its forward,
    the lockstep plan's ``M + 2(S-1)`` slots, gpipe's ``M + S*V - 1``, and
    a stage never holding more stashed inputs than JAX's ring depth."""
    from horovod_tpu_torch.parallel import pipeline as tp

    sched = tp.build_interleaved_schedule(S, V, M)
    for plan, v in ((tp.interleaved_plan(sched), V),
                    (tp.lockstep_plan(S, M), 1)):
        seen, held, most = {}, {}, {}
        for u, row in enumerate(plan):
            for s, acts in enumerate(row):
                for op, c, m in acts:
                    assert (op, s, c, m) not in seen
                    seen[(op, s, c, m)] = u
                    held[s] = held.get(s, 0) + (1 if op == tp._F else -1)
                    most[s] = max(most.get(s, 0), held[s])
        assert len(seen) == 2 * S * v * M
        for (op, s, c, m), u in seen.items():
            if op == tp._B:
                assert u >= seen[(tp._F, s, c, m)]
        depth = v * sched.stash_depth if v == V else tp.stash_depth(S, M)
        assert max(most.values()) <= depth
    assert len(tp.lockstep_plan(S, M)) == M + 2 * (S - 1)
    assert len(tp.gpipe_plan(S, M, V)) == M + S * V - 1
    assert len(tp.interleaved_plan(sched)) == sched.n_slots


# ---- the in-process transport (no spawn) ------------------------------------


def _port_value_and_grad(params, batch, cfg, **kw):
    from horovod_tpu_torch.models import llama as tl

    leaves = _flat(params)
    for v in leaves.values():
        v.requires_grad_(True)
    loss = tl.llama_loss(params, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: _np(g) for k, g in zip(leaves, grads)}


def _port_params(moe=False):
    from horovod_tpu_torch.models.convert import from_jax_params

    return from_jax_params(_params(moe), device="cpu")


@pytest.mark.parametrize("case,mask", [
    *((case, False) for case in CASES), ("1f1b", True),
    ("interleaved-v2", True)])
def test_in_process_schedules_match_jax(case, mask, monkeypatch):
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.pipeline import InProcessTransport

    calls = []
    plain = fa._flash_fwd_reference

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "_flash_fwd_reference", counted)
    loss, grads = _port_value_and_grad(
        _port_params(), _take(_batch(), mask), _port_cfg(**_schedule(case)),
        device="cpu", transport=InProcessTransport(2))
    want_loss, want = _jax_pipelined(case, mask)
    # One K1 launch a (layer, microbatch) forward; the fused schedules'
    # backward subticks re-run each forward once (remat "none").
    M = CASES[case][2]
    assert len(calls) == L * M * (1 if case == "gpipe" else 2)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads(grads, want, case)


def test_in_process_forward_and_value_only_match_unpipelined():
    """gpipe's logits equal the unpipelined forward's; a value-only call
    of each fused schedule (no grad) runs gpipe and gives the grad
    call's loss."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import pipeline
    from horovod_tpu_torch.parallel.pipeline import InProcessTransport

    params, batch = _port_params(), _batch()
    with torch.no_grad():
        plain = tl.llama_forward(params, batch["tokens"], _port_cfg(),
                                 device="cpu")
        for case in CASES:
            logits = tl.llama_forward(params, batch["tokens"],
                                      _port_cfg(**_schedule(case)),
                                      device="cpu",
                                      transport=InProcessTransport(2))
            np.testing.assert_allclose(_np(logits), _np(plain), rtol=1e-5,
                                       atol=1e-5)
    for case in ("1f1b", "interleaved-v2"):
        cfg = _port_cfg(**_schedule(case))
        with torch.no_grad():
            value = float(tl.llama_loss(params, batch, cfg, device="cpu",
                                        transport=InProcessTransport(2)))
        engine = pipeline.gpipe
        try:
            pipeline.gpipe = None      # the grad call must not need it
            loss, _ = _port_value_and_grad(_port_params(), batch, cfg,
                                           device="cpu",
                                           transport=InProcessTransport(2))
        finally:
            pipeline.gpipe = engine
        assert value == pytest.approx(loss, rel=1e-6)


def test_pipeline_config_errors():
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel.pipeline import InProcessTransport

    params, batch = _port_params(), _batch()
    two = InProcessTransport(2)
    for kw, match in (
            (dict(pipeline_schedule="bogus"), "pipeline_schedule"),
            (dict(pipeline_virtual_stages=2), "pipeline_virtual_stages"),
            (dict(pipeline_schedule="interleaved_1f1b",
                  pipeline_virtual_stages=3), "n_layers"),
            (dict(pipeline_microbatches=3), "must divide into 3")):
        with pytest.raises(ValueError, match=match):
            tl.llama_loss(params, batch, _port_cfg(**kw), device="cpu",
                          transport=two)
    with pytest.raises(ValueError, match="takes no mesh"):
        tl._transport(object(), two)


# ---- one spawned world of 8 ranks -------------------------------------------


def _save(tmp_path, name, tree):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **_flat(tree))
    return path


def _load(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            *heads, leaf = key.split("/")
            node = tree
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[key]
    return tree


def _rank_blocks(path, mesh, cfg):
    """This rank's stage blocks (device-major for an interleaved V > 1)
    and the spec tree."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel.sharding import shard_params

    params = from_jax_params(_load(path), device="cpu")
    return shard_params(params, mesh, tl.llama_partition_rules(
        True, cfg.pipeline_virtual_stages))


def _whole(tree, mesh, specs, rank):
    """The global tree (canonical layer order) from every rank's blocks,
    as numpy by path on rank 0."""
    from horovod_tpu_torch.parallel.sharding import gather_params

    full = gather_params(tree, mesh, specs)
    return {k: _np(v) for k, v in _flat(full).items()} if rank == 0 \
        else None


def _grads(rank, path, mesh, batch, cfg):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel._tree import (
        tree_leaves,
        tree_map,
        tree_unflatten,
    )

    blocks, specs = _rank_blocks(path, mesh, cfg)
    live = tree_map(lambda p: p.detach().requires_grad_(True), blocks)
    loss = tl.llama_loss(live, mesh.shard_batch(batch), cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss), _whole(tree_unflatten(live, list(grads)), mesh,
                               specs, rank)


def _sgd(lr):
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel._tree import tree_map

    return precision.FusedOptimizer(
        init=lambda params: (),
        apply=lambda params, grads, state: (
            tree_map(lambda p, g: p - lr * g, params, grads), state))


def _value_only(rank, path, mesh, batch, cfg):
    """A value-only call, then a grad call, counting the interleaved
    engine's calls around each."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import pipeline
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    blocks, _ = _rank_blocks(path, mesh, cfg)
    local = mesh.shard_batch(batch)
    calls = []
    real = pipeline.interleaved_one_f_one_b

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    pipeline.interleaved_one_f_one_b = counting
    try:
        with torch.no_grad():
            value = float(tl.llama_loss(blocks, local, cfg, mesh=mesh))
        after_value = len(calls)
        live = tree_map(lambda p: p.detach().requires_grad_(True), blocks)
        loss = tl.llama_loss(live, local, cfg, mesh=mesh)
        torch.autograd.grad(loss, tree_leaves(live))
    finally:
        pipeline.interleaved_one_f_one_b = real
    return value, float(loss), after_value, len(calls)


# The MoE cases under fsdp: (case, mask). JAX's CPU program of the
# interleaved schedule on this mesh aborts in XLA, so its cases are held
# to the port's own 1f1b on the same world: the same objective, which JAX
# holds for the two schedules on the other meshes.
MOE_FSDP = (("gpipe", False), ("1f1b", False), ("1f1b", True),
            ("interleaved-v2", False), ("interleaved-v2", True))


def _world(rank, size, path, moe_path):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import train_step

    # Eight ranks share the machine's cores: one thread each.
    torch.set_num_threads(1)
    out = {}
    mesh = mesh_mod.create_mesh(device="cpu", pipe=2, fsdp=2, tensor=2)
    out["coords"] = dict(mesh.coords)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    unmasked = _take(batch, False)
    gp = _port_cfg(**_schedule("gpipe"))
    blocks, specs = _rank_blocks(path, mesh, gp)
    with torch.no_grad():
        out["logits"] = _np(tl.llama_forward(
            blocks, mesh.shard(batch["tokens"]), gp, mesh=mesh))
    ts = train_step.make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, gp, mesh=mesh), _sgd(0.1))
    loss, (new, _) = ts.step(ts.init(blocks), mesh.shard_batch(unmasked))
    out["sgd"] = float(loss), _whole(new, mesh, specs, rank)
    for case in ("1f1b", "interleaved-v2"):
        for mask in (False, True):
            out[f"{case}/{mask}"] = _grads(rank, path, mesh,
                                           _take(batch, mask),
                                           _port_cfg(**_schedule(case)))
    iv = _port_cfg(**_schedule("interleaved-v2"))
    out["value_only"] = _value_only(rank, path, mesh, batch, iv)
    # Two grad calls of M=2 each: 4 rows a batch rank.
    ts = train_step.make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, iv, mesh=mesh), _sgd(0.1),
        microbatches=2)
    blocks, specs = _rank_blocks(path, mesh, iv)
    eight = {k: torch.from_numpy(v) for k, v in _take(_batch(8),
                                                      False).items()}
    loss, (new, _) = ts.step(ts.init(blocks), mesh.shard_batch(eight))
    out["split"] = float(loss), _whole(new, mesh, specs, rank)
    # The ragged remainder: M=6 over S*V=4, 6 rows a batch rank.
    ragged = _port_cfg(pipeline_schedule="interleaved_1f1b",
                       pipeline_virtual_stages=2, pipeline_microbatches=6)
    big = {k: torch.from_numpy(v) for k, v in _take(_batch(12), True).items()}
    out["ragged"] = _grads(rank, path, mesh, big, ragged)
    mesh = mesh_mod.create_mesh(device="cpu", **MOE_AXES["tensor"])
    for case in ("1f1b", "interleaved-v2"):
        out[f"moe/{case}"] = _grads(rank, moe_path, mesh, unmasked,
                                    _port_cfg(True, **_schedule(case)))
    mesh = mesh_mod.create_mesh(device="cpu", **MOE_AXES["fsdp"])
    for case, mask in MOE_FSDP:
        out[f"moe-fsdp/{case}/{mask}"] = _grads(
            rank, moe_path, mesh, _take(batch, mask),
            _port_cfg(True, **_schedule(case)))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return run_ranks(functools.partial(
        _world, path=_save(tmp, "dense", _params()),
        moe_path=_save(tmp, "moe", _params(True))), 8, timeout=400)


@functools.cache
def _routing_margin():
    """The smallest gap between the K-th and (K+1)-th router probability
    over every layer's tokens of the port's unsharded MoE forward: far
    above f32 noise, so no expert can flip between the frameworks."""
    from horovod_tpu_torch.models import llama as tl

    gaps = []
    plain = tl._route

    def recording(h, router_w, k):
        out = plain(h, router_w, k)
        top = out[2].detach().sort(-1, descending=True).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return out

    tl._route = recording
    try:
        with torch.no_grad():
            tl.llama_forward(_port_params(True), _batch()["tokens"],
                             _port_cfg(True), device="cpu")
    finally:
        tl._route = plain
    return min(gaps)


def _jax_rank_order():
    mesh = _jax_mesh(pipe=2, fsdp=2, tensor=2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return mesh, ids


def test_world_ranks_sit_where_jax_devices_do(world):
    mesh, ids = _jax_rank_order()
    for rank, r in enumerate(world):
        at = np.argwhere(ids == rank)[0]
        assert r["coords"] == dict(zip(mesh.axis_names, map(int, at)))


def test_world_gpipe_logits_match_jax(world):
    from horovod_tpu.models import llama as jl

    mesh = _jax_mesh(pipe=2, fsdp=2, tensor=2)
    p_sh, b_sh = _jax_sharded(_params(), _batch(), mesh)
    cfg = _jax_cfg()
    want = np.asarray(jax.jit(lambda p, t: jl.llama_forward(
        p, t, cfg, mesh))(p_sh, b_sh["tokens"]))
    for r in world:
        f = r["coords"]["fsdp"]
        np.testing.assert_allclose(r["logits"], want[2 * f:2 * f + 2],
                                   rtol=1e-4, atol=1e-4)


def test_world_gpipe_sgd_step_matches_jax(world):
    want_loss, grads = _jax_pipelined("gpipe", False)
    loss, params = world[0]["sgd"]
    for r in world:
        assert r["sgd"][0] == loss
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for k, p in _flat(_params()).items():
        np.testing.assert_allclose(params[k], p - 0.1 * grads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("case", ["1f1b", "interleaved-v2"])
def test_world_fused_schedules_match_jax(world, case, mask):
    want_loss, want = _jax_pipelined(case, mask)
    loss, grads = world[0][f"{case}/{mask}"]
    for r in world:
        assert r[f"{case}/{mask}"][0] == loss
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads(grads, want, case)


@pytest.mark.parametrize("case", ["1f1b", "interleaved-v2"])
def test_world_moe_aux_matches_jax(world, case):
    """The MoE aux objective folded in by its constant cotangent
    (``moe_aux_weight / (n_layers * M)``) under ``pipe=2 x expert=2 x
    tensor=2``: JAX's loss and router gradients."""
    assert _routing_margin() > MARGIN
    want_loss, want = _jax_pipelined(case, False, moe=True)
    loss, grads = world[0][f"moe/{case}"]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads(grads, want, f"moe {case}")


@pytest.mark.parametrize("case,mask", MOE_FSDP)
def test_world_moe_microbatches_are_jax_global_rows(world, case, mask):
    """Under ``pipe=2 x fsdp=2 x expert=2`` JAX's microbatch m is the
    global rows [m B/M, (m+1) B/M), split over the two fsdp ranks, and
    the aux loss is taken a microbatch: the port moves an MoE config's
    rows so (``llama._regroup``), through gpipe's trunk and the fused
    schedules, masked and not. The masked case takes the atol of JAX's
    interleaved tests (5e-6, for schedules that sum the microbatches'
    gradients in other orders): its embedding gradient (entries up to
    2.4) is f32 noise at 2e-6 in JAX's own result against a float64
    replay of the same objective, and at 1.8e-6 in the port's. JAX's
    CPU program of the interleaved schedule on this mesh aborts, so the
    interleaved cases are held to the port's 1f1b on the same world."""
    assert _routing_margin() > MARGIN
    if case.startswith("interleaved"):
        want_loss, want = world[0][f"moe-fsdp/1f1b/{mask}"]
    else:
        want_loss, want = _jax_pipelined(case, mask, moe=True,
                                         moe_axes="fsdp")
    loss, grads = world[0][f"moe-fsdp/{case}/{mask}"]
    for r in world:
        assert r[f"moe-fsdp/{case}/{mask}"][0] == loss
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads(grads, want, f"moe fsdp {case}", 5e-6 if mask else 1e-6)


def test_world_ragged_remainder_matches_unsharded_jax(world):
    want_loss, want = _jax_unsharded(12, True)
    loss, grads = world[0]["ragged"]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    _assert_grads(grads, want, "ragged")


def test_world_split_step_with_two_microbatches(world):
    """``make_split_train_step(microbatches=2)`` over the interleaved
    loss (M=2 inside each grad call, B8) against JAX's one-jit step on
    the whole batch, SGD 0.1."""
    want_loss, grads = _jax_unsharded(8, False)
    loss, params = world[0]["split"]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for k, p in _flat(_params()).items():
        np.testing.assert_allclose(params[k], p - 0.1 * grads[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_world_value_only_call_never_runs_the_engine(world):
    want, _ = _jax_pipelined("interleaved-v2", True)
    for r in world:
        value, grad_loss, after_value, after_grad = r["value_only"]
        assert after_value == 0, "a value-only call entered the engine"
        assert after_grad == 1, "a grad call must run the engine once"
        assert value == pytest.approx(grad_loss, rel=1e-5)
        assert value == pytest.approx(want, rel=1e-5)
