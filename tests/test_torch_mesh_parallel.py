"""The port's ``tensor``, ``fsdp`` and ``expert`` mesh axes and the GShard
MoE dispatch against the JAX package.

Three spawned gloo worlds of 8 ranks, one a mesh shape, each case
against JAX on its 8-device CPU mesh from the same seeded numpy params
(``llama_init`` of the JAX package, moved by ``from_jax_params``) and
batch (B4 x T16, a random mask):

- ``data=2 x fsdp=2 x tensor=2``, dense ``LlamaConfig.tiny`` at f32 (the
  oracle of ``tests/single/test_llama.py:47``): each rank's
  ``shard_params`` block bit-equal to JAX's ``addressable_shards`` of
  device r; the loss (rtol 1e-5) and every gradient leaf, gathered by
  ``gather_params``, against ``jax.value_and_grad(llama_loss)`` under the
  mesh, in the remat modes none, full and attn+gate, with the fsdp
  gathers a grad call (a remat mode's recompute gathers each layer's
  weights again rather than saving them); every parameter
  after one SGD step (lr 0.1) against JAX's (rtol 1e-4, atol 1e-6); the
  logits; two ``make_split_train_step(llama_loss, fused_adam(3e-4))``
  steps on the blocks against the port's single-process steps on the
  whole batch; bf16 params sharded (as ``test_llama.py:400``): a finite
  step that keeps every block bf16, its loss within 1e-2 of the
  unsharded one; ``reduce_scatter`` over ``fsdp`` and its backward.
- ``fsdp=2 x expert=2 x tensor=2``, ``tiny_moe`` with
  ``moe_impl="gshard"`` (``test_llama.py:230``): the blocks, the loss
  against JAX's sharded and unsharded losses (rtol 1e-5) and the
  gradients, remat none and attn+gate (which saves the dispatch and
  combine tensors); the grouped dispatch under a mesh raises naming A8.
- ``fsdp=2 x seq=2 x tensor=2``: the dense model with ring and Ulysses
  attention on each rank's heads (the ``dense/dp.fsdp.tp.sp`` and
  ``dense/ulysses-sp`` dryrun passes), and ``tiny_moe`` under GShard,
  whose capacity positions start after the earlier ``seq`` rank's
  counts: loss and gradients.

Every world's rank coordinates are JAX's device positions, a ``pipe``
axis still raises naming A10, and ``zero=`` over a mesh that shards the
params naming A9b. Without a mesh: ``_moe_ffn``
against JAX's (f32, 1e-5), and GShard against the grouped dispatch when
nothing can drop (``tests/single/test_grouped_moe.py:42``'s
tolerances). Gradients are held to 2e-5 of each leaf's largest entry
(the same f32 arithmetic summed in another order); routing cases assert
the top-K probability gap first.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.utils_mp import run_ranks

B, T = 4, 16
GRAD_TOL = 2e-5
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


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _jax_cfg(moe=False, **kw):
    from horovod_tpu.models import llama as jl

    if moe:
        return jl.LlamaConfig.tiny_moe(dtype="float32", remat=False,
                                       moe_impl="gshard", **kw)
    return jl.LlamaConfig.tiny(dtype="float32", remat=False, **kw)


def _setup(moe=False, seed=0):
    from horovod_tpu.models import llama as jl

    jparams = jax.tree.map(np.asarray,
                           jl.llama_init(_jax_cfg(moe),
                                         jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    return jparams, {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
                     "mask": (rng.random((B, T)) > 0.3).astype(np.float32)}


def _save(tmp_path, name, tree):
    """``tree``'s leaves in an .npz for the ranks to load: a spawned rank
    reads its arguments only after it has imported this module, so large
    arguments would start the ranks one after another."""
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


def _routing_margin(jparams, batch):
    """The smallest gap between the K-th and (K+1)-th router probability
    over every layer's tokens, from the port's unsharded forward."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params

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
            tl.llama_forward(from_jax_params(jparams, device="cpu"),
                             batch["tokens"], _port_cfg(True), device="cpu")
    finally:
        tl._route = plain
    return min(gaps)


# ---- the port's side: one world a mesh shape ----------------------------


def _port_cfg(moe=False, **kw):
    from horovod_tpu_torch.models import llama as tl

    if moe:
        kw.setdefault("moe_impl", "gshard")
        return tl.LlamaConfig.tiny_moe(dtype="float32", **kw)
    return tl.LlamaConfig.tiny(dtype="float32", **kw)


def _open(path, **axes):
    """This rank's mesh, and its blocks and the spec tree of the params
    at ``path``."""
    from horovod_tpu_torch.parallel import mesh as mesh_mod

    # Eight ranks share the machine's cores: one thread each.
    torch.set_num_threads(1)
    mesh = mesh_mod.create_mesh(device="cpu", **axes)
    return (mesh, *_blocks(path, mesh))


def _blocks(path, mesh, dtype=None):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel._tree import tree_map
    from horovod_tpu_torch.parallel.sharding import shard_params

    params = from_jax_params(_load(path), device="cpu")
    if dtype is not None:
        params = tree_map(lambda v: v.to(dtype), params)
    return shard_params(params, mesh, tl.llama_partition_rules())


def _value_and_grad(blocks, local, cfg, mesh):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel._tree import (
        tree_leaves,
        tree_map,
        tree_unflatten,
    )

    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    blocks)
    loss = tl.llama_loss(live, local, cfg, mesh=mesh)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), tree_unflatten(live, list(grads))


def _whole(tree, mesh, specs, rank):
    """The global tree from every rank's blocks, as numpy on rank 0."""
    from horovod_tpu_torch.parallel.sharding import gather_params

    full = gather_params(tree, mesh, specs)
    return {k: _np(v) for k, v in _flat(full).items()} if rank == 0 \
        else None


def _grads(rank, blocks, local, cfg, mesh, specs):
    loss, grads = _value_and_grad(blocks, local, cfg, mesh)
    return loss, _whole(grads, mesh, specs, rank)


def _split_steps(params, batch, cfg, mesh=None, steps=2):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import precision, train_step

    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    ts = train_step.make_split_train_step(
        lambda p, b: tl.llama_loss(p, b, cfg, **kw),
        precision.fused_adam(3e-4))
    carry = ts.init(params)
    losses = []
    for _ in range(steps):
        loss, carry = ts.step(carry, batch)
        losses.append(float(loss))
    return losses, carry[0]


def _errors(mesh):
    """The messages of what still raises on this world: a ``pipe`` axis,
    and ZeRO over a mesh that shards the params."""
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step, zero

    out = {}
    for name, fn in (
            ("pipe", lambda: mesh_mod.create_mesh(device="cpu", pipe=2)),
            ("zero", lambda: train_step.make_split_train_step(
                lambda p, b: None, precision.fused_adam(3e-4),
                zero=zero.ZeroConfig(mesh=mesh)))):
        try:
            fn()
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _count_fsdp_gathers():
    """Record each forward of ``parallel.ops.all_gather`` (the fsdp
    gathers) from now on, in this process."""
    from horovod_tpu_torch.parallel import ops

    calls, plain = [], ops._AllGather.forward

    def counted(ctx, x, group, axis):
        calls.append(tuple(x.shape))
        return plain(ctx, x, group, axis)

    ops._AllGather.forward = staticmethod(counted)
    return calls


def _dense_world(rank, size, path, batch):
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    mesh, blocks, specs = _open(path, data=2, fsdp=2, tensor=2)
    local = mesh.shard_batch(batch)
    out = {"coords": dict(mesh.coords),
           "blocks": {k: v.numpy().copy()
                      for k, v in _flat(blocks).items()}}
    gathers = _count_fsdp_gathers()
    for mode in ("none", "full", "attn+gate"):
        gathers.clear()
        out[mode] = _grads(rank, blocks, local, _port_cfg(remat=mode), mesh,
                           specs) + (len(gathers),)
    _, grads = _value_and_grad(blocks, local, _port_cfg(remat="none"), mesh)
    out["sgd"] = _whole(tree_map(lambda p, g: p - 0.1 * g, blocks, grads),
                        mesh, specs, rank)
    with torch.no_grad():
        out["logits"] = tl.llama_forward(blocks, local["tokens"],
                                         _port_cfg(remat="none"),
                                         mesh=mesh).numpy()
    losses, params = _split_steps(blocks, local,
                                  _port_cfg(remat="attn+gate"), mesh)
    out["train"] = losses, _whole(params, mesh, specs, rank)
    bcfg = tl.LlamaConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    bblocks, _ = _blocks(path, mesh, torch.bfloat16)
    losses, params = _split_steps(bblocks, local, bcfg, mesh, steps=1)
    out["bf16"] = losses[0], sorted({str(p.dtype)
                                     for p in tree_leaves(params)})
    out["errors"] = _errors(mesh)
    out["ops"] = _scatter_pair(mesh)
    return out


def _scatter_pair(mesh):
    """``reduce_scatter`` over the ``fsdp`` group of a rank-valued
    [4, 3] tensor and its backward (an all-gather of the cotangent)."""
    from horovod_tpu_torch.parallel import ops

    x = torch.arange(12.0).reshape(4, 3).mul(mesh.rank + 1)
    x.requires_grad_(True)
    y = ops.reduce_scatter(x, mesh.axis_group("fsdp"), axis=0)
    cot = torch.full_like(y, float(mesh.coords["fsdp"] + 1))
    dx, = torch.autograd.grad(y, x, cot)
    return y.detach().numpy(), dx.numpy()


def _moe_world(rank, size, path, batch):
    from horovod_tpu_torch.models import llama as tl

    mesh, blocks, specs = _open(path, fsdp=2, expert=2, tensor=2)
    local = mesh.shard_batch(batch)
    out = {"coords": dict(mesh.coords),
           "blocks": {k: v.numpy().copy()
                      for k, v in _flat(blocks).items()}}
    for mode in ("none", "attn+gate"):
        out[mode] = _grads(rank, blocks, local,
                           _port_cfg(True, remat=mode), mesh, specs)
    out["errors"] = _errors(mesh)
    try:
        tl.llama_loss(blocks, local, _port_cfg(True, moe_impl="grouped"),
                      mesh=mesh)
        out["errors"]["grouped"] = "no error"
    except NotImplementedError as e:
        out["errors"]["grouped"] = str(e)
    return out


def _seq_world(rank, size, path, moe_path, batch):
    mesh, blocks, specs = _open(path, fsdp=2, seq=2, tensor=2)
    local = mesh.shard_batch(batch)
    out = {"coords": dict(mesh.coords)}
    for sp in ("ring", "ulysses"):
        out[sp] = _grads(rank, blocks, local,
                         _port_cfg(remat="none", seq_parallel=sp), mesh,
                         specs)
    blocks, specs = _blocks(moe_path, mesh)
    out["moe"] = _grads(rank, blocks, local, _port_cfg(True, remat="none"),
                        mesh, specs)
    out["errors"] = _errors(mesh)
    return out


# ---- JAX's side ----------------------------------------------------------


def _jax_mesh(**axes):
    from horovod_tpu import parallel

    return parallel.create_mesh(devices=jax.devices()[:8], **axes)


def _jax_sharded(jparams, batch, cfg, mesh):
    """JAX's loss, gradients and params' shards (by device id) under
    ``mesh``, params sharded by ``llama_partition_rules``."""
    from horovod_tpu import parallel
    from horovod_tpu.models import llama as jl
    from horovod_tpu.parallel.sharding import apply_sharding, named_sharding

    p_sh = apply_sharding(jparams, parallel.shard_params(
        jparams, mesh, jl.llama_partition_rules()))
    b_sh = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                          named_sharding(mesh, ("data", "fsdp"), "seq"))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jl.llama_loss(p, b, cfg, mesh)))(p_sh, b_sh)
    shards = {k: {s.device.id: np.asarray(s.data)
                  for s in v.addressable_shards}
              for k, v in _flat(p_sh).items()}
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()}, \
        shards


def _check_layout(per_rank, jmesh):
    """Rank r sits where JAX's device r does."""
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank, r in enumerate(per_rank):
        at = np.argwhere(ids == rank)[0]
        assert r["coords"] == dict(zip(jmesh.axis_names, map(int, at)))
        assert "A10" in r["errors"]["pipe"], r["errors"]
        assert "A9b" in r["errors"]["zero"], r["errors"]


def _check_blocks(per_rank, shards):
    for rank, r in enumerate(per_rank):
        assert sorted(r["blocks"]) == sorted(shards)
        for k, block in r["blocks"].items():
            want = shards[k][rank]
            assert block.dtype == want.dtype, k
            np.testing.assert_array_equal(block, want, err_msg=k)


def _check_grads(got, want, what):
    loss, grads = got[:2]
    w_loss, w_grads = want
    assert loss == pytest.approx(w_loss, rel=1e-5), (what, loss, w_loss)
    assert sorted(grads) == sorted(w_grads), what
    for k, w in w_grads.items():
        assert grads[k].shape == w.shape, (what, k)
        assert _rel(grads[k], w) <= GRAD_TOL, (what, k, _rel(grads[k], w))


def _port_whole_batch(jparams, batch, cfg, steps):
    from horovod_tpu_torch.models.convert import from_jax_params

    losses, params = _split_steps(
        from_jax_params(jparams, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        steps=steps)
    return losses, {k: _np(v) for k, v in _flat(params).items()}


def test_dense_data_fsdp_tensor_matches_jax(tmp_path):
    from horovod_tpu.models import llama as jl

    jparams, batch = _setup()
    per_rank = run_ranks(functools.partial(
        _dense_world, path=_save(tmp_path, "dense", jparams), batch=batch),
        8, timeout=300)
    jmesh = _jax_mesh(data=2, fsdp=2, tensor=2)
    loss, grads, shards = _jax_sharded(jparams, batch, _jax_cfg(), jmesh)
    _check_layout(per_rank, jmesh)
    _check_blocks(per_rank, shards)
    r0 = per_rank[0]
    # The fsdp gathers a grad call: the embedding and lm_head once, each
    # layer's 7 matmul leaves once, again in the backward's recompute
    # under a remat mode (no gathered weight is saved).
    for mode, gathers in (("none", 16), ("full", 30), ("attn+gate", 30)):
        _check_grads(r0[mode], (loss, grads), mode)
        for r in per_rank:
            assert r[mode][0] == r0[mode][0], mode
            assert r[mode][2] == gathers, (mode, r[mode][2])
    # One SGD step (lr 0.1): the tolerances of test_llama.py:47.
    for k, g in grads.items():
        want = _flat(jparams)[k] + np.float32(-0.1) * g
        np.testing.assert_allclose(r0["sgd"][k], want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # reduce_scatter over fsdp: block f of the sum over the pair's ranks,
    # and its backward the gathered cotangents (block f is f + 1).
    for rank, r in enumerate(per_rank):
        pair = [q for q, o in enumerate(per_rank)
                if {a: v for a, v in o["coords"].items() if a != "fsdp"}
                == {a: v for a, v in r["coords"].items() if a != "fsdp"}]
        f = r["coords"]["fsdp"]
        total = np.arange(12.0).reshape(4, 3) * sum(q + 1 for q in pair)
        y, dx = r["ops"]
        np.testing.assert_array_equal(y, total[2 * f:2 * f + 2])
        np.testing.assert_array_equal(dx, np.repeat([[1.0], [2.0]], 2, 0)
                                      * np.ones((4, 3)))
    # The logits: each rank's (batch, seq) block of JAX's full-vocab ones.
    logits = np.asarray(jl.llama_forward(jparams,
                                         jnp.asarray(batch["tokens"]),
                                         _jax_cfg()))
    for r in per_rank:
        c = r["coords"]
        i = c["data"] * 2 + c["fsdp"]
        np.testing.assert_allclose(r["logits"], logits[i:i + 1], rtol=2e-5,
                                   atol=2e-5)
    # Two fused-Adam split steps on the blocks against the port's
    # single-process steps on the whole batch (test_torch_seq_parallel's
    # tolerances: Adam moves a near-zero gradient's element by up to lr).
    want_losses, want = _port_whole_batch(
        jparams, batch, _port_cfg(remat="attn+gate"), 2)
    for r in per_rank:
        np.testing.assert_allclose(r["train"][0], want_losses, rtol=1e-5)
    for k, w in want.items():
        np.testing.assert_allclose(r0["train"][1][k], w, rtol=1e-4,
                                   atol=3e-5, err_msg=k)
    # bf16 params sharded (JAX's bf16 init is its f32 init rounded): a
    # finite step, every block still bf16, the loss that of the whole
    # batch on one process.
    from horovod_tpu_torch.models import llama as tl

    bcfg = tl.LlamaConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    want_losses, _ = _port_whole_batch(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams), batch,
        bcfg, 1)
    for r in per_rank:
        b_loss, dtypes = r["bf16"]
        assert np.isfinite(b_loss) and dtypes == ["torch.bfloat16"]
        assert b_loss == pytest.approx(want_losses[0], rel=1e-2)


def test_moe_fsdp_expert_tensor_matches_jax(tmp_path):
    from horovod_tpu.models import llama as jl

    jparams, batch = _setup(moe=True)
    assert _routing_margin(jparams, batch) > MARGIN
    per_rank = run_ranks(functools.partial(
        _moe_world, path=_save(tmp_path, "moe", jparams), batch=batch), 8,
        timeout=300)
    jmesh = _jax_mesh(fsdp=2, expert=2, tensor=2)
    loss, grads, shards = _jax_sharded(jparams, batch, _jax_cfg(True),
                                       jmesh)
    unsharded = float(jl.llama_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        _jax_cfg(True)))
    _check_layout(per_rank, jmesh)
    _check_blocks(per_rank, shards)
    r0 = per_rank[0]
    for mode in ("none", "attn+gate"):
        _check_grads(r0[mode], (loss, grads), mode)
        assert r0[mode][0] == pytest.approx(unsharded, rel=1e-5)
        for r in per_rank:
            assert r[mode][0] == r0[mode][0], mode
    for r in per_rank:
        assert "A8" in r["errors"]["grouped"], r["errors"]


def test_fsdp_seq_tensor_matches_jax(tmp_path):
    jparams, batch = _setup()
    moe_params, _ = _setup(moe=True)
    assert _routing_margin(moe_params, batch) > MARGIN
    per_rank = run_ranks(functools.partial(
        _seq_world, path=_save(tmp_path, "dense", jparams),
        moe_path=_save(tmp_path, "moe", moe_params), batch=batch), 8,
        timeout=300)
    jmesh = _jax_mesh(fsdp=2, seq=2, tensor=2)
    _check_layout(per_rank, jmesh)
    for sp in ("ring", "ulysses"):
        loss, grads, _ = _jax_sharded(jparams, batch,
                                      _jax_cfg(seq_parallel=sp), jmesh)
        _check_grads(per_rank[0][sp], (loss, grads), sp)
    loss, grads, _ = _jax_sharded(moe_params, batch, _jax_cfg(True), jmesh)
    _check_grads(per_rank[0]["moe"], (loss, grads), "moe")
    for r in per_rank:
        for key in ("ring", "ulysses", "moe"):
            assert r[key][0] == per_rank[0][key][0], key


# ---- without a mesh -----------------------------------------------------


def _layer0(jparams):
    return {k: v[0] for k, v in jparams["layers"].items()}


def _h(seed, d=64):
    return np.random.default_rng(seed).standard_normal(
        (2, T, d)).astype(np.float32)


def test_moe_ffn_matches_jax_without_a_mesh():
    from horovod_tpu.models import llama as jl
    from horovod_tpu_torch.models import llama as tl

    jparams, _ = _setup(moe=True)
    lp, h = _layer0(jparams), _h(3)
    want, want_aux = jl._moe_ffn(jnp.asarray(h), lp, _jax_cfg(True), None)
    got, aux = tl._moe_ffn(torch.from_numpy(h),
                           {k: torch.from_numpy(np.array(v))
                            for k, v in lp.items()}, _port_cfg(True))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_gshard_matches_grouped_when_nothing_drops():
    """capacity_factor = E makes C = T * K: no routing can overflow, so
    GShard and the dropless dispatch compute the same function (values
    and gradients at test_grouped_moe.py's tolerances)."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.ops import grouped_moe

    jparams, _ = _setup(moe=True)
    cfg = _port_cfg(True, capacity_factor=4.0)
    h0 = torch.from_numpy(_h(4))
    lp0 = {k: torch.from_numpy(np.array(v))
           for k, v in _layer0(jparams).items()
           if k in ("router", "moe_gate", "moe_up", "moe_down")}
    out = {}
    for name, fn in (("gshard", functools.partial(tl._moe_ffn, c=cfg)),
                     ("grouped", functools.partial(
                         grouped_moe.grouped_moe_ffn, c=cfg))):
        h = h0.clone().requires_grad_(True)
        lp = {k: v.clone().requires_grad_(True) for k, v in lp0.items()}
        y, aux = fn(h, lp)
        loss = (y ** 2).mean() + 0.01 * aux
        grads = torch.autograd.grad(loss, [h, *lp.values()])
        out[name] = (y, aux, dict(zip(["h", *lp], grads)))
    y, aux, g = out["grouped"]
    y_ref, aux_ref, g_ref = out["gshard"]
    np.testing.assert_allclose(_np(y), _np(y_ref), rtol=1e-5, atol=1e-5)
    assert float(aux.detach()) == pytest.approx(float(aux_ref.detach()),
                                                rel=1e-6)
    for k in g_ref:
        np.testing.assert_allclose(_np(g[k]), _np(g_ref[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
