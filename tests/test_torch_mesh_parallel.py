"""The port's ``tensor``, ``fsdp`` and ``expert`` mesh axes, the GShard
and grouped MoE dispatches, BERT and the ResNet under a mesh, ZeRO over
sharded blocks and its cross-plane split against the JAX package.

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
  unsharded one; ``reduce_scatter`` over ``fsdp`` and its backward. In
  the same world: BERT (``bert_partition_rules``; blocks against JAX's
  shards, the loss and every gradient with and without remat, with
  padding, against ``jax.grad`` of the unsharded loss, and each rank's
  logits); the ResNet under this mesh and under a ``data=8`` mesh
  against JAX's step over ``data=8`` (loss, gradients, batch-norm state
  to test_torch_resnet.py's 5e-5); ``tiny_moe`` with the grouped
  dispatch against JAX's under the mesh (remat none and moe); ZeRO over
  ``data`` on the blocks and the cross-plane split (``inter_axis``)
  under a ``data=2 x seq=2 x tensor=2`` mesh and without a mesh (two
  planes of four ranks): the first step's gradient leaves, gathered from
  the shards Adam takes, against JAX's, two steps' params against the
  port's unsharded steps, the fused and unfused schedules bit for bit;
  ``hier_allreduce`` against JAX's under ``shard_map`` and against
  ``psum`` over both axes.
- ``fsdp=2 x expert=2 x tensor=2``, ``tiny_moe`` with
  ``moe_impl="gshard"`` (``test_llama.py:230``): the blocks, the loss
  against JAX's sharded and unsharded losses (rtol 1e-5) and the
  gradients, remat none and attn+gate (which saves the dispatch and
  combine tensors); the dropless grouped dispatch (K5/K6's path, the
  experts gathered over ``expert``) against JAX's grouped dispatch under
  the same mesh, remat none, moe and attn+moe.
- ``fsdp=2 x seq=2 x tensor=2``: the dense model with ring and Ulysses
  attention on each rank's heads (the ``dense/dp.fsdp.tp.sp`` and
  ``dense/ulysses-sp`` dryrun passes), and ``tiny_moe`` under GShard,
  whose capacity positions start after the earlier ``seq`` rank's
  counts: loss and gradients.

Every world's rank coordinates are JAX's device positions, a ``pipe``
axis builds and a pipeline with ``seq > 1`` raises JAX's error (the
pipeline itself: test_torch_pipeline.py), ``zero=`` over a mesh that
shards the params builds, and ZeRO over ``tensor`` raises. Without a
mesh: ``_moe_ffn`` against JAX's (f32, 1e-5), and GShard against the
grouped dispatch when nothing can drop (``tests/single/test_grouped_moe.py:42``'s
tolerances). Gradients are held to 2e-5 of each leaf's largest entry
(the same f32 arithmetic summed in another order); routing cases assert
the top-K probability gap first.
"""

import dataclasses
import functools
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_mp import lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")

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
        kw.setdefault("moe_impl", "gshard")
        return jl.LlamaConfig.tiny_moe(dtype="float32", remat=False, **kw)
    return jl.LlamaConfig.tiny(dtype="float32", remat=False, **kw)


@functools.cache
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


def _pickle(tmp_path, name, obj):
    """:func:`_save` for a tree with lists (the ResNet's)."""
    path = str(tmp_path / f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
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


@functools.cache
def _moe_margin():
    """:func:`_routing_margin` of the MoE params on the batch every world
    takes (the same for both of :func:`_setup`'s trees)."""
    return _routing_margin(*_setup(moe=True))


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
    """What raises on this world: a ``pipe`` axis builds (it raised
    naming A10 before), and a pipeline with ``seq > 1`` raises JAX's
    error; ZeRO over a mesh that shards the params builds (it raised
    naming A9b before), but not over an axis that shards them."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel import precision, train_step, zero
    from horovod_tpu_torch.parallel.sharding import shard_params

    def pipe_with_seq():
        pmesh = mesh_mod.create_mesh(device="cpu", pipe=2, seq=2)
        cfg = _port_cfg(remat="none")
        params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        blocks, _ = shard_params(params, pmesh,
                                 tl.llama_partition_rules(pipeline=True))
        tokens = torch.zeros((4, 16), dtype=torch.int32)
        tl.llama_loss(blocks, pmesh.shard_batch(
            {"tokens": tokens, "targets": tokens}), cfg, mesh=pmesh)

    out = {}
    for name, fn in (
            ("pipe", lambda: mesh_mod.create_mesh(device="cpu", pipe=2)),
            ("pipe_seq", pipe_with_seq),
            ("zero", lambda: train_step.make_split_train_step(
                lambda p, b: None, precision.fused_adam(3e-4),
                zero=zero.ZeroConfig(mesh=mesh))),
            ("zero_tensor", lambda: zero.zero_axis(zero.ZeroConfig(
                mesh=mesh, axis="tensor"), "cpu"))):
        try:
            fn()
            out[name] = "no error"
        except (NotImplementedError, ValueError) as e:
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


def _dense_world(rank, size, path, batch, moe_path, bert_path, bert_batch,
                 resnet, batch8):
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
    out["hier"] = _hier_part(mesh)
    out["bert"] = _bert_part(rank, mesh, bert_path, bert_batch)
    from horovod_tpu_torch.parallel import mesh as mesh_mod

    with open(resnet, "rb") as f:
        out["resnet"] = _resnet_part(rank, {
            "dense": mesh,
            "data8": mesh_mod.create_mesh(device="cpu", data=8)},
            *pickle.load(f))
    moe_blocks, moe_specs = _blocks(moe_path, mesh)
    for mode in ("none", "moe"):
        out[f"grouped/{mode}"] = _grads(
            rank, moe_blocks, local,
            _port_cfg(True, moe_impl="grouped", remat=mode), mesh, moe_specs)
    out.update(_zero_parts(rank, path, mesh, local, batch, batch8))
    return out


def _zero_parts(rank, path, mesh, local, batch, batch8):
    """ZeRO over ``data`` on the blocks of this ``data=2 x fsdp=2 x
    tensor=2`` mesh; the cross-plane split under a ``data=2 x seq=2 x
    tensor=2`` mesh (``inter_axis="seq"``) and without a mesh (two planes
    of four ranks, each rank its own row of ``batch8``)."""
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    cfg = _port_cfg(remat="attn+gate")
    out = {}
    # Fresh blocks: the split steps above updated theirs in place.
    blocks, specs = _blocks(path, mesh)
    losses, params, grads, same = _zero_steps(
        blocks, local, cfg, ZeroConfig(mesh=mesh, bucket_bytes=1 << 14),
        mesh)
    out["zero"] = (losses, _whole(params, mesh, specs, rank),
                   _whole(grads, mesh, specs, rank), same)
    mesh2 = mesh_mod.create_mesh(device="cpu", data=2, seq=2, tensor=2)
    blocks2, specs2 = _blocks(path, mesh2)
    losses, params, grads, same = _zero_steps(
        blocks2, mesh2.shard_batch(batch), cfg,
        ZeroConfig(mesh=mesh2, inter_axis="seq", bucket_bytes=1 << 14),
        mesh2)
    out["zero/inter-mesh"] = (losses, _whole(params, mesh2, specs2, rank),
                              _whole(grads, mesh2, specs2, rank), same)
    whole = from_jax_params(_load(path), device="cpu")
    row = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in batch8.items()}
    losses, params, grads, same = _zero_steps(
        whole, row, cfg, ZeroConfig(size=4, inter_axis="cross",
                                    inter_size=2, bucket_bytes=1 << 14),
        None)
    out["zero/inter"] = (losses, {k: _np(v) for k, v in _flat(params).items()},
                         {k: _np(v) for k, v in _flat(grads).items()}, same)
    return out


def _bert_part(rank, mesh, path, batch):
    """BERT under ``mesh``: its blocks, the loss and gradients with and
    without remat, the logits."""
    from horovod_tpu_torch.models import bert as tb
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel._tree import (
        tree_leaves,
        tree_map,
        tree_unflatten,
    )
    from horovod_tpu_torch.parallel.sharding import shard_params

    blocks, specs = shard_params(from_jax_params(_load(path), device="cpu"),
                                 mesh, tb.bert_partition_rules())
    local = mesh.shard_batch(batch, seq_dim=None)
    out = {"blocks": {k: v.numpy().copy() for k, v in _flat(blocks).items()}}
    for remat in (False, True):
        cfg = tb.BertConfig.tiny(dtype="float32", remat=remat)
        live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        blocks)
        loss = tb.bert_mlm_loss(live, local, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        # The Adam kernel takes contiguous gradients (the fsdp split of
        # the embedding is on its dim 1).
        out[f"contiguous {remat}"] = all(g.is_contiguous() for g in grads)
        out[remat] = float(loss.detach()), _whole(
            tree_unflatten(live, list(grads)), mesh, specs, rank)
    with torch.no_grad():
        out["logits"] = tb.bert_forward(
            blocks, local["tokens"], cfg,
            attention_mask=local["attention_mask"], mesh=mesh).numpy()
    return out


def _resnet_part(rank, meshes, params, state, batch):
    """The ResNet under each of ``meshes``: loss, gradients and the new
    batch-norm state (rank 0's), every rank's loss."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel._tree import tree_leaves

    cfg = resnet.ResNetConfig(depth=18, num_classes=7, width=8,
                              compute_dtype="float32")
    out = {}
    for label, mesh in meshes.items():
        tp = from_jax_params(params, device="cpu")
        ts = from_jax_params(state, device="cpu")
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        local = mesh.shard_batch(batch, seq_dim=None)
        loss, new_state = resnet.resnet_loss(tp, ts, local, cfg, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        out[label] = (float(loss.detach()),
                      [g.numpy() for g in grads] if rank == 0 else None,
                      [x.numpy() for x in tree_leaves(new_state)]
                      if rank == 0 else None)
    return out


def _record_zero_grads():
    """Record the gradient shard each ZeRO bucket's first Adam update
    takes (after the cross-plane sum and the scale), by bucket index:
    returns the record and a function that stops it."""
    from horovod_tpu_torch.parallel import zero

    seen, current = {}, []
    plain_update, plain_adam = zero.ZeroApply.update, zero.shard_adam

    def update(self, index, *args):
        current.append(index)
        return plain_update(self, index, *args)

    def shard_adam(hyper, p_shard, g_shard, *args, **kw):
        seen.setdefault(current[-1], g_shard.clone())
        return plain_adam(hyper, p_shard, g_shard, *args, **kw)

    def stop():
        zero.ZeroApply.update, zero.shard_adam = plain_update, plain_adam

    zero.ZeroApply.update = update
    zero.shard_adam = shard_adam
    return seen, stop


def _zero_grads(seen, layout, group, like):
    """The gradient leaves of ``like``'s tree from the recorded shards:
    each bucket's shards gathered over the zero ``group``, unpacked."""
    import torch.distributed as dist

    from horovod_tpu_torch.parallel._tree import tree_unflatten

    flats = []
    for i in range(len(layout.buckets)):
        shard = seen[i]
        if group is None:
            flats.append(shard)
            continue
        full = shard.new_empty(shard.numel() * dist.get_world_size(group))
        dist.all_gather_into_tensor(full, shard, group=group)
        flats.append(full)
    return tree_unflatten(like, layout.unpack(flats))


def _zero_steps(blocks, local, cfg, zcfg, loss_mesh, steps=2):
    """``steps`` ZeRO split steps of ``fused_adam(3e-4)``, fused and
    unfused: (losses, params, the first step's gradient leaves, whether
    the two schedules' params agree bit for bit)."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.parallel import fusion, precision, train_step
    from horovod_tpu_torch.parallel import zero
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    kw = {"mesh": loss_mesh} if loss_mesh is not None else {"device": "cpu"}
    runs = {}
    for fused in (True, False):
        fusion.set_jit_fusion(fused)
        seen, stop = _record_zero_grads()
        ts = train_step.make_split_train_step(
            lambda p, b: tl.llama_loss(p, b, cfg, **kw),
            precision.fused_adam(3e-4), zero=zcfg)
        carry = ts.init(tree_map(lambda x: x.clone(), blocks))
        losses = []
        for _ in range(steps):
            loss, carry = ts.step(carry, local)
            losses.append(float(loss))
        stop()
        layout = zero.zero_bucket_layout(tree_leaves(blocks),
                                         zcfg.resolved_size(),
                                         zcfg.bucket_bytes)
        group = zero.zero_axis(zcfg, "cpu").group
        runs[fused] = losses, carry[0], _zero_grads(seen, layout, group,
                                                    blocks)
    fusion.set_jit_fusion(None)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[True][1]), tree_leaves(runs[False][1])))
    return (*runs[True], same)


def _hier_part(mesh):
    """``hier_allreduce`` of a rank-valued [4, 3] tensor, intra
    ``tensor``, inter ``fsdp``; ``psum`` over both; the backward of the
    first under a cotangent of ones."""
    from horovod_tpu_torch.parallel import ops

    x = torch.from_numpy(np.random.default_rng(mesh.rank).standard_normal(
        (4, 3)).astype(np.float32)).requires_grad_(True)
    y = ops.hier_allreduce(x, mesh.axis_group("tensor"),
                           mesh.axis_group("fsdp"))
    flat = ops.psum(x.detach(), mesh.axes_group(("fsdp", "tensor")))
    dx, = torch.autograd.grad(y, x, torch.ones_like(y))
    return y.detach().numpy(), flat.numpy(), dx.numpy()


def _scatter_pair(mesh):
    """``reduce_scatter`` over the ``fsdp`` group of a rank-valued
    [4, 3] tensor and its backward (an all-gather of the cotangent); and
    whether the tiled collectives along dim 1 and their backwards give
    contiguous tensors (the kernels take them so)."""
    from horovod_tpu_torch.parallel import ops

    x = torch.arange(12.0).reshape(4, 3).mul(mesh.rank + 1)
    x.requires_grad_(True)
    y = ops.reduce_scatter(x, mesh.axis_group("fsdp"), axis=0)
    cot = torch.full_like(y, float(mesh.coords["fsdp"] + 1))
    dx, = torch.autograd.grad(y, x, cot)
    w = torch.ones((3, 4), requires_grad=True)
    dense = []
    for fn in (ops.all_gather, ops.reduce_scatter):
        z = fn(w, mesh.axis_group("fsdp"), axis=1)
        dw, = torch.autograd.grad(z, w, torch.ones_like(z))
        dense += [z.is_contiguous(), dw.is_contiguous()]
    return y.detach().numpy(), dx.numpy(), all(dense)


def _moe_world(rank, size, path, batch):
    mesh, blocks, specs = _open(path, fsdp=2, expert=2, tensor=2)
    local = mesh.shard_batch(batch)
    out = {"coords": dict(mesh.coords),
           "blocks": {k: v.numpy().copy()
                      for k, v in _flat(blocks).items()}}
    for mode in ("none", "attn+gate"):
        out[mode] = _grads(rank, blocks, local,
                           _port_cfg(True, remat=mode), mesh, specs)
    out["errors"] = _errors(mesh)
    for mode in ("none", "moe", "attn+moe"):
        out[f"grouped/{mode}"] = _grads(
            rank, blocks, local,
            _port_cfg(True, moe_impl="grouped", remat=mode), mesh, specs)
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
        assert r["errors"]["pipe"] == "no error", r["errors"]
        assert "sequence parallelism (seq>1) cannot combine" in \
            r["errors"]["pipe_seq"], r["errors"]
        assert r["errors"]["zero"] == "no error", r["errors"]
        assert "shards the params" in r["errors"]["zero_tensor"], r["errors"]


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


@functools.cache
def _bert_setup():
    """JAX's tiny BERT params (f32) and a B4 x T16 batch with seeded
    padding (no sequence all padding: JAX's CPU attention gives such a
    row the mean of V, the kernels 0), ~30% of real tokens predicted."""
    from horovod_tpu.models import bert as jb

    jparams = jax.tree.map(np.asarray, jb.bert_init(
        jb.BertConfig.tiny(dtype="float32"), jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    mask = (np.arange(T)[None, :] < np.array([T, 9, 5, 12])[:, None]
            ).astype(np.int32)
    mlm = ((rng.random((B, T)) < 0.3) * mask).astype(np.float32)
    mlm[:, 0] = 1.0
    return jparams, {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32),
                     "targets": rng.integers(0, 256, (B, T)).astype(np.int32),
                     "mlm_mask": mlm, "attention_mask": mask}


@functools.cache
def _resnet_setup():
    """ResNet-18 (width 8, 7 classes) params and batch-norm state from
    the port's ``resnet_init`` (JAX's keys and shapes; JAX's own init
    takes ~15 s here), every leaf perturbed as in test_torch_resnet.py,
    as numpy; a 16-image 16 x 16 batch."""
    from horovod_tpu.models import resnet as jr
    from horovod_tpu_torch.models import resnet

    cfg = jr.ResNetConfig(depth=18, num_classes=7, width=8,
                          compute_dtype="float32")
    params, state = resnet.resnet_init(resnet.ResNetConfig(
        depth=18, num_classes=7, width=8, compute_dtype="float32"),
        torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(7)

    def noisy(t, positive=False):
        a = t.numpy()
        n = rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a + 0.2 * n) + 0.5 if positive else a + 0.1 * n

    def walk(tree, var=False):
        if isinstance(tree, dict):
            return {k: walk(v, k == "var") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return noisy(tree, var)

    batch = {"images": rng.standard_normal((16, 16, 16, 3)).astype(
                 np.float32),
             "labels": rng.integers(0, 7, 16).astype(np.int32)}
    return cfg, walk(params), walk(state), batch


def _jax_shards(jparams, rules, mesh):
    """JAX's shards (by device id) of every leaf under ``rules``."""
    from horovod_tpu import parallel
    from horovod_tpu.parallel.sharding import apply_sharding

    p_sh = apply_sharding(jparams, parallel.shard_params(jparams, mesh,
                                                         rules))
    return {k: {s.device.id: np.asarray(s.data)
                for s in v.addressable_shards}
            for k, v in _flat(p_sh).items()}


def _jax_resnet(cfg, params, state, batch, mesh):
    """JAX's ResNet loss, gradients and new state (leaves) on ``batch``
    split over ``mesh``'s (data, fsdp)."""
    from horovod_tpu.models import resnet as jr
    from horovod_tpu.parallel.sharding import named_sharding

    b_sh = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                          named_sharding(mesh, ("data", "fsdp")))
    (loss, new_state), grads = jax.jit(jax.value_and_grad(
        lambda p, s, b: jr.resnet_loss(p, s, b, cfg), has_aux=True))(
        params, state, b_sh)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)], \
        [np.asarray(x) for x in jax.tree.leaves(new_state)]


def _check_resnet(got, want, what):
    """test_torch_resnet.py's tolerance: 5e-5 of max(1, |want|)."""
    loss, grads, state = got
    w_loss, w_grads, w_state = want
    assert abs(loss - w_loss) <= 5e-5 * max(1.0, abs(w_loss)), (what, loss)
    assert len(grads) == len(w_grads) and len(state) == len(w_state)
    for i, (g, w) in enumerate(zip(grads + state, w_grads + w_state)):
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(g - w).max() / scale <= 5e-5, (what, i)


def _jax_hier(per_rank, jmesh):
    """JAX's ``hier_allreduce`` (intra ``tensor``, inter ``fsdp``) of the
    ranks' inputs under ``shard_map``, by rank."""
    from jax.sharding import PartitionSpec as JP

    from horovod_tpu.parallel import hier_allreduce

    xs = np.stack([np.random.default_rng(r).standard_normal((4, 3)).astype(
        np.float32) for r in range(len(per_rank))])
    spec = JP(("data", "fsdp", "tensor"))
    out = jax.shard_map(lambda x: hier_allreduce(x[0], "tensor",
                                                 "fsdp")[None],
                        mesh=jmesh, in_specs=spec, out_specs=spec,
                        check_vma=False)(jnp.asarray(xs))
    return np.asarray(out)


def _batch8():
    rng = np.random.default_rng(9)
    tokens8 = rng.integers(0, 256, (8, T)).astype(np.int32)
    return {"tokens": tokens8, "targets": np.roll(tokens8, -1, 1)}


def _world(rank, size, dense, moe, seq):
    """Every multi-rank case of this file in one world of 8 ranks: the
    dense, MoE and seq meshes' batteries, each on its own mesh."""
    return {"dense": _dense_world(rank, size, **dense),
            "moe": _moe_world(rank, size, **moe),
            "seq": _seq_world(rank, size, **seq)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One spawned world of 8 ranks, shared by every multi-rank test."""
    tmp = tmp_path_factory.mktemp("mesh")
    jparams, batch = _setup()
    moe_params, _ = _setup(moe=True)
    bert_params, bert_batch = _bert_setup()
    rcfg, rparams, rstate, rbatch = _resnet_setup()
    dense, moe = _save(tmp, "dense", jparams), _save(tmp, "moe", moe_params)
    return run_ranks(functools.partial(
        _world,
        dense=dict(path=dense, batch=batch, moe_path=moe,
                   bert_path=_save(tmp, "bert", bert_params),
                   bert_batch=bert_batch,
                   resnet=_pickle(tmp, "resnet", (rparams, rstate, rbatch)),
                   batch8=_batch8()),
        moe=dict(path=moe, batch=batch),
        seq=dict(path=dense, moe_path=moe, batch=batch)), 8, timeout=900)


def test_dense_data_fsdp_tensor_matches_jax(world):
    from horovod_tpu.models import bert as jb
    from horovod_tpu.models import llama as jl

    jparams, batch = _setup()
    moe_params, _ = _setup(moe=True)
    assert _moe_margin() > MARGIN
    bert_params, bert_batch = _bert_setup()
    rcfg, rparams, rstate, rbatch = _resnet_setup()
    batch8 = _batch8()
    per_rank = [r["dense"] for r in world]
    jmesh = _jax_mesh(data=2, fsdp=2, tensor=2)
    loss, grads, shards = _jax_sharded(jparams, batch, _jax_cfg(), jmesh)
    _check_layout(per_rank, jmesh)
    _check_blocks(per_rank, shards)
    r0 = per_rank[0]
    # BERT under the mesh: the blocks (JAX's shards), the loss and every
    # gradient, with and without remat, the logits of each rank's rows.
    # The loss and gradients are held against JAX's unsharded ones: JAX's
    # GSPMD program gives the same loss but other gradients under this
    # one mesh shape (every leaf off by 0.4-1.8 of its largest entry on
    # jax 0.9.0's CPU; data=4 x tensor=2 and fsdp=4 x tensor=2 agree with
    # the unsharded).
    bcfg = jb.BertConfig.tiny(dtype="float32", remat=False)
    b_shards = _jax_shards(bert_params, jb.bert_partition_rules(), jmesh)
    b_loss, b_grads = jax.value_and_grad(lambda p: jb.bert_mlm_loss(
        p, {k: jnp.asarray(v) for k, v in bert_batch.items()}, bcfg))(
        bert_params)
    b_loss = float(b_loss)
    b_grads = {k: np.asarray(v) for k, v in _flat(b_grads).items()}
    for remat in (False, True):
        _check_grads(r0["bert"][remat], (b_loss, b_grads), f"bert {remat}")
        for r in per_rank:
            assert r["bert"][remat][0] == r0["bert"][remat][0]
            assert r["bert"][f"contiguous {remat}"]
    _check_blocks([r["bert"] for r in per_rank], b_shards)
    b_logits = np.asarray(jb.bert_forward(
        bert_params, jnp.asarray(bert_batch["tokens"]), bcfg,
        attention_mask=jnp.asarray(bert_batch["attention_mask"])))
    for r in per_rank:
        i = r["coords"]["data"] * 2 + r["coords"]["fsdp"]
        np.testing.assert_allclose(r["bert"]["logits"], b_logits[i:i + 1],
                                   rtol=2e-5, atol=2e-5)
    # The ResNet under this mesh and under data=8, against JAX's step
    # over data=8 (its dryrun pass's mesh).
    want = _jax_resnet(rcfg, rparams, rstate, rbatch, _jax_mesh(data=8))
    for label in ("dense", "data8"):
        _check_resnet(r0["resnet"][label], want, label)
        for r in per_rank:
            assert r["resnet"][label][0] == r0["resnet"][label][0], label
    # The dropless grouped dispatch (K5/K6's path) under the mesh.
    g_loss, g_grads, _ = _jax_sharded(
        moe_params, batch, _jax_cfg(True, moe_impl="grouped"), jmesh)
    for mode in ("none", "moe"):
        _check_grads(r0[f"grouped/{mode}"], (g_loss, g_grads), mode)
        for r in per_rank:
            assert r[f"grouped/{mode}"][0] == r0[f"grouped/{mode}"][0]
    # ZeRO over data on the blocks, and the cross-plane split under a
    # mesh: the first step's gradient leaves (gathered from the shards
    # Adam took) JAX's, the params after two steps the port's unsharded
    # steps', the fused and unfused schedules bit for bit.
    want_losses, want = _port_whole_batch(jparams, batch,
                                          _port_cfg(remat="attn+gate"), 2)
    for key in ("zero", "zero/inter-mesh"):
        losses, params, z_grads, same = r0[key]
        assert same, key
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        _check_grads((losses[0], z_grads), (loss, grads), key)
        for k, w in want.items():
            np.testing.assert_allclose(params[k], w, rtol=1e-4, atol=3e-5,
                                       err_msg=f"{key} {k}")
        for r in per_rank:
            assert r[key][0] == losses, key
    # The cross-plane split without a mesh: two planes of four ranks,
    # each rank's loss the mean over its own row of batch8.
    w8_loss, w8 = jax.value_and_grad(lambda p: jl.llama_loss(
        p, {k: jnp.asarray(v) for k, v in batch8.items()}, _jax_cfg()))(
        jparams)
    w8 = {k: np.asarray(v) for k, v in _flat(w8).items()}
    want_losses8, want8 = _port_whole_batch(jparams, batch8,
                                            _port_cfg(remat="attn+gate"), 2)
    losses, params, z_grads, same = r0["zero/inter"]
    assert same
    _check_grads((float(w8_loss), z_grads), (float(w8_loss), w8),
                 "zero/inter")
    np.testing.assert_allclose(
        np.mean([r["zero/inter"][0] for r in per_rank], 0), want_losses8,
        rtol=1e-5)
    for k, w in want8.items():
        np.testing.assert_allclose(params[k], w, rtol=1e-4, atol=3e-5,
                                   err_msg=f"zero/inter {k}")
    for r in per_rank[1:]:
        for k, w in r["zero/inter"][1].items():
            np.testing.assert_array_equal(w, params[k], err_msg=k)
    # hier_allreduce: JAX's under shard_map, psum over both axes, and its
    # backward (the reduce-scatter's and all-gather's: the cotangent
    # summed over ``tensor``).
    j_hier = _jax_hier(per_rank, jmesh)
    for rank, r in enumerate(per_rank):
        y, flat, dx = r["hier"]
        np.testing.assert_allclose(y, j_hier[rank], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(y, flat, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(dx, np.full((4, 3), 2.0))
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
        y, dx, dense = r["ops"]
        assert dense, "a tiled collective returned a strided tensor"
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


def test_moe_fsdp_expert_tensor_matches_jax(world):
    from horovod_tpu.models import llama as jl

    jparams, batch = _setup(moe=True)
    assert _moe_margin() > MARGIN
    per_rank = [r["moe"] for r in world]
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
    # The grouped dispatch with the experts gathered over ``expert``:
    # JAX's grouped dispatch under the same mesh.
    g_loss, g_grads, _ = _jax_sharded(
        jparams, batch, _jax_cfg(True, moe_impl="grouped"), jmesh)
    for mode in ("none", "moe", "attn+moe"):
        _check_grads(r0[f"grouped/{mode}"], (g_loss, g_grads), mode)
        for r in per_rank:
            assert r[f"grouped/{mode}"][0] == r0[f"grouped/{mode}"][0]


def test_fsdp_seq_tensor_matches_jax(world):
    jparams, batch = _setup()
    moe_params, _ = _setup(moe=True)
    assert _moe_margin() > MARGIN
    per_rank = [r["seq"] for r in world]
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
