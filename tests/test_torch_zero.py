"""ZeRO-1 in the port, single process, against horovod_tpu.parallel.zero.

- ``ring_owned_segment`` equals the JAX package's at every rank, size
  and rotation;
- ``zero_bucket_layout`` gives JAX's buckets (indices, sizes, offsets,
  padding, dtype) for seeded numpy leaves: f32 and bf16 mixed, an
  oversized leaf, several bucket sizes and shard counts; ``pack``,
  ``unpack`` and ``pack_shard`` give JAX's bits;
- ``optimizer_state_bytes`` counts what JAX's counts, and a fused
  optimizer without its hyperparameters raises JAX's error;
- the state converters: rank r's block of JAX's ZeRO state after three
  of JAX's ZeRO steps, and back to JAX's global view, bit for bit;
- ``zero=`` at size 1 (no collective) is bit-identical to the replicated
  split step, fused and unfused, ``fused_adam`` and
  ``fused_master_adam``, over 2 microbatches of the tiny Llama;
- the fusion knob and the bucketed backward (every bucket handed on
  once, a leaf without a gradient after the backward);
- the mesh's deferred gradient sum.

The multi-rank lanes are ``tests/test_torch_zero_ranks.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import zero as JZ
from horovod_tpu.parallel.precision import fused_adam as j_fused_adam
from horovod_tpu.parallel.precision import (
    fused_master_adam as j_fused_master_adam,
)
from horovod_tpu.parallel.train_step import (
    make_split_train_step as j_make_step,
)
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import (
    from_jax_zero_state,
    to_jax_zero_state,
)
from horovod_tpu_torch.parallel import fusion, precision, train_step
from horovod_tpu_torch.parallel import zero as Z
from horovod_tpu_torch.parallel._tree import tree_leaves
from horovod_tpu_torch.parallel.mesh import Mesh

def _bits(x):
    """An array's bits as integers (bf16 through a uint16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _leaves(seed, spec):
    """Seeded numpy leaves ``[(shape, dtype name)]``: (numpy for JAX,
    torch)."""
    rng = np.random.default_rng(seed)
    np_leaves, t_leaves = [], []
    for shape, dt in spec:
        a = rng.standard_normal(shape).astype(np.float32)
        if dt == "bfloat16":
            b = a.astype(ml_dtypes.bfloat16)
            np_leaves.append(b)
            t_leaves.append(torch.from_numpy(b.view(np.uint16).copy())
                            .view(torch.bfloat16))
        else:
            np_leaves.append(a)
            t_leaves.append(torch.from_numpy(a.copy()))
    return np_leaves, t_leaves


MIXED = [((16, 8), "float32"), ((33,), "bfloat16"), ((7, 5), "float32"),
         ((64,), "bfloat16"), ((3,), "float32"), ((48, 16), "bfloat16"),
         ((), "float32"), ((10, 10), "float32")]
OVERSIZED = [((5,), "float32"), ((300, 7), "float32"), ((9,), "float32")]


@pytest.mark.parametrize("size", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("rot", [0, -1])
def test_ring_owned_segment_matches_jax(size, rot):
    for rank in range(size):
        assert Z.ring_owned_segment(rank, size, rot) == \
            JZ.ring_owned_segment(rank, size, rot)
    for bad in (size, -1):
        with pytest.raises(ValueError):
            Z.ring_owned_segment(bad, size, rot)


@pytest.mark.parametrize("spec", [MIXED, OVERSIZED],
                         ids=["mixed", "oversized"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("bucket_bytes", [64, 512, 1 << 20])
def test_layout_and_packing_match_jax(spec, n_shards, bucket_bytes):
    np_leaves, t_leaves = _leaves(n_shards * 31 + bucket_bytes, spec)
    jl = JZ.zero_bucket_layout([jnp.asarray(a) for a in np_leaves],
                               n_shards, bucket_bytes)
    tlay = Z.zero_bucket_layout(t_leaves, n_shards, bucket_bytes)
    assert len(tlay.buckets) == len(jl.buckets)
    for tb, jb in zip(tlay.buckets, jl.buckets):
        assert (tb.indices, tb.sizes, tb.offsets, tb.nelems, tb.padded) == \
            (jb.indices, jb.sizes, jb.offsets, jb.nelems, jb.padded)
        assert str(tb.dtype).removeprefix("torch.") == jb.dtype.name
    assert tlay.shapes == jl.shapes and tlay.padded_elems == jl.padded_elems
    jpacked = jl.pack([jnp.asarray(a) for a in np_leaves])
    tpacked = tlay.pack(t_leaves)
    for t, j in zip(tpacked, jpacked):
        np.testing.assert_array_equal(_bits(t), _bits(j))
    for i in range(len(jl.buckets)):
        for rank in range(n_shards):
            np.testing.assert_array_equal(
                _bits(tlay.pack_shard(t_leaves, i, rank)),
                _bits(jl.pack_shard([jnp.asarray(a) for a in np_leaves], i,
                                    rank)))
    for t, a in zip(tlay.unpack(tpacked), np_leaves):
        assert tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_bits(t), _bits(a))


def test_oversized_leaf_gets_one_bucket():
    _, t_leaves = _leaves(0, OVERSIZED)
    lay = Z.zero_bucket_layout(t_leaves, 4, 256)
    assert [b.indices for b in lay.buckets] == [(0,), (1,), (2,)]
    assert lay.buckets[1].padded == 2100 and lay.buckets[1].is_view
    assert lay.buckets[0].padded == 8 and not lay.buckets[0].is_view


def test_pack_of_a_single_unpadded_leaf_is_a_view():
    _, t_leaves = _leaves(1, [((8, 4), "float32")])
    lay = Z.zero_bucket_layout(t_leaves, 4, 1 << 20)
    flat = lay.pack_bucket(t_leaves, 0)
    assert flat.data_ptr() == t_leaves[0].data_ptr()
    shard = lay.pack_shard(t_leaves, 0, 2)
    assert shard.data_ptr() == t_leaves[0].data_ptr() + 16 * 4


def _jax_state(kind, size):
    """A JAX ZeRO state after three of JAX's ZeRO steps (the MLP of
    tests/single/test_zero.py, numpy-seeded)."""
    rng = np.random.default_rng(5)
    params = {"w1": jnp.asarray(rng.standard_normal((8, 16)) * 0.1,
                                jnp.float32),
              "b1": jnp.zeros((13,), jnp.float32),
              "w2": jnp.asarray(rng.standard_normal((16, 4)) * 0.1,
                                jnp.float32)}
    batch = {"x": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32),
             "y": jnp.asarray(rng.standard_normal((8, 4)), jnp.float32)}

    def loss_fn(p, d):
        h = jnp.tanh(d["x"] @ p["w1"] + p["b1"][:16].sum())
        return jnp.mean((h @ p["w2"] - d["y"]) ** 2)

    opt = j_fused_adam(1e-2) if kind == "adam" else \
        j_fused_master_adam(1e-2, compute_dtype=jnp.bfloat16)
    ts = j_make_step(loss_fn, opt, zero=JZ.ZeroConfig(size=size,
                                                      bucket_bytes=128))
    carry = ts.init(params)
    for _ in range(3):
        _, carry = ts.step(carry, batch)
    return jax.tree.map(np.asarray, carry[1])


@pytest.mark.parametrize("kind", ["adam", "master"])
@pytest.mark.parametrize("size", [2, 4])
def test_state_converters_both_ways(kind, size):
    jstate = _jax_state(kind, size)
    blocks = [from_jax_zero_state(jstate, r, size, device="cpu")
              for r in range(size)]
    cls = Z.ZeroMasterAdamState if kind == "master" else Z.ZeroAdamState
    for r, st in enumerate(blocks):
        assert type(st) is cls
        assert st.count.shape == (1,) and int(st.count[0]) == 3
        for f in cls._fields[1:]:
            for t, j in zip(getattr(st, f), getattr(jstate, f)):
                s = j.shape[0] // size
                np.testing.assert_array_equal(_bits(t),
                                              _bits(j[r * s:(r + 1) * s]))
    back = to_jax_zero_state(blocks, bfloat16=ml_dtypes.bfloat16)
    for got, want in zip(jax.tree.leaves(tuple(back)),
                         jax.tree.leaves(jstate)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    jcls = JZ.ZeroMasterAdamState if kind == "master" else JZ.ZeroAdamState
    assert jcls(*back)._fields == jstate._fields
    with pytest.raises(ValueError, match="split"):
        from_jax_zero_state(jstate, 0, 3, device="cpu")


def _jax_block_state(kind):
    """A JAX ZeRO state over ``data=2`` after three of JAX's ZeRO steps
    of an MLP whose leaves split over ``fsdp`` and ``tensor``; its
    params' global leaves."""
    rng = np.random.default_rng(6)
    params = {"w1": jnp.asarray(rng.standard_normal((8, 16)) * 0.1,
                                jnp.float32),
              "b1": jnp.asarray(rng.standard_normal(16) * 0.1, jnp.float32),
              "w2": jnp.asarray(rng.standard_normal((16, 4)) * 0.1,
                                jnp.float32)}
    batch = {"x": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32),
             "y": jnp.asarray(rng.standard_normal((8, 4)), jnp.float32)}

    def loss_fn(p, d):
        h = jnp.tanh(d["x"] @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] - d["y"]) ** 2)

    opt = j_fused_adam(1e-2) if kind == "adam" else \
        j_fused_master_adam(1e-2, compute_dtype=jnp.bfloat16)
    ts = j_make_step(loss_fn, opt, zero=JZ.ZeroConfig(size=2,
                                                      bucket_bytes=128))
    carry = ts.init(params)
    for _ in range(3):
        _, carry = ts.step(carry, batch)
    return jax.tree.map(np.asarray, carry[1]), params


@pytest.mark.parametrize("kind", ["adam", "master"])
def test_state_converters_over_sharded_blocks(kind):
    """JAX's global ZeRO state of params sharded over ``fsdp`` and
    ``tensor`` (a ``data=2 x fsdp=2 x tensor=2`` mesh, ZeRO over
    ``data``) into each rank's carry and back, bit for bit: each rank's
    moments (and master) per leaf are its block of JAX's leaf, in the
    layout of its own blocks."""
    from horovod_tpu_torch.models.convert import ZeroBlocks
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER
    from horovod_tpu_torch.parallel.sharding import P

    jstate, params = _jax_block_state(kind)
    keys = sorted(params)                           # b1, w1, w2
    specs = {"b1": P("tensor"), "w1": P("fsdp", "tensor"),
             "w2": P("tensor", None)}
    dt = torch.bfloat16 if kind == "master" else torch.float32
    shape = {a: 1 for a in AXIS_ORDER} | {"data": 2, "fsdp": 2, "tensor": 2}
    blocks = ZeroBlocks(
        leaves=[Z.LeafSpec(params[k].shape, dt) for k in keys],
        specs=[specs[k] for k in keys], shape=shape, axis="data",
        bucket_bytes=128,
        jax_leaves=[Z.LeafSpec(params[k].shape, torch.float32)
                    for k in keys])
    states = [from_jax_zero_state(jstate, r, 2, device="cpu", blocks=blocks)
              for r in range(8)]
    # JAX's leaves of each bucketed field, unpacked by JAX's own layout.
    jlayout = JZ.zero_bucket_layout([params[k] for k in keys], 2, 128)
    fields = ("master", "mu", "nu") if kind == "master" else ("mu", "nu")
    for r, st in enumerate(states):
        c = np.unravel_index(r, (2, 2, 2))          # data, fsdp, tensor
        assert int(st.count[0]) == 3
        _, layout = blocks.layouts(r)
        pair = [q for q in range(8)
                if np.unravel_index(q, (2, 2, 2))[1:] == c[1:]]
        for f in fields:
            want = jlayout.unpack([jnp.asarray(a)
                                   for a in getattr(jstate, f)])
            full = [torch.cat([getattr(states[q], f)[j] for q in pair])
                    for j in range(len(layout.buckets))]
            for k, got, w in zip(keys, layout.unpack(full), want):
                w = np.asarray(w)
                f_i, t_i = c[1], c[2]
                if k == "b1":
                    w = w[8 * t_i:8 * (t_i + 1)]
                elif k == "w1":
                    w = w[4 * f_i:4 * (f_i + 1), 8 * t_i:8 * (t_i + 1)]
                else:
                    w = w[8 * t_i:8 * (t_i + 1)]
                np.testing.assert_array_equal(_bits(got), _bits(w),
                                              err_msg=f"{f} {k} rank {r}")
    back = to_jax_zero_state(states, bfloat16=ml_dtypes.bfloat16,
                             blocks=blocks)
    for got, want in zip(jax.tree.leaves(tuple(back)),
                         jax.tree.leaves(jstate)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_optimizer_state_bytes_matches_jax():
    jstate = _jax_state("master", 2)
    port = from_jax_zero_state(jstate, 0, 2, device="cpu")
    assert Z.optimizer_state_bytes(port) * 2 == \
        JZ.optimizer_state_bytes(jstate)
    mixed = {"a": [torch.zeros(3), 4],
             "b": (torch.zeros(2, dtype=torch.bfloat16),)}
    assert Z.optimizer_state_bytes(mixed) == 16


def test_optimizer_hyper_errors_match_jax():
    no_hyper = precision.FusedOptimizer(init=None, apply=None)
    wrong = precision.FusedOptimizer(init=None, apply=None,
                                     hyper={"kind": "sgd"})
    for opt in (no_hyper, wrong):
        with pytest.raises(ValueError, match="fused optimizer carrying"):
            Z._optimizer_hyper(opt)
        with pytest.raises(ValueError, match="fused optimizer carrying"):
            JZ._optimizer_hyper(opt)
        with pytest.raises(ValueError, match="fused optimizer carrying"):
            train_step.make_split_train_step(
                lambda p, d: 0, opt, zero=Z.ZeroConfig(size=1))
    for opt in (precision.fused_adam(1e-3),
                precision.fused_master_adam(1e-3)):
        assert Z._optimizer_hyper(opt) is opt.hyper


def test_config_errors():
    """The config's errors; the cross-plane split (``inter_axis``, which
    raised naming A9b before) builds, and its world is ``size *
    inter_size`` ranks."""
    # Without size= or mesh= the shards take the world's size (1 with no
    # world), split into the planes.
    assert Z.ZeroConfig().resolved_size() == 1
    with pytest.raises(ValueError, match="planes"):
        Z.ZeroConfig(inter_size=2).resolved_size()
    apply_fn, init = Z.make_zero_apply(precision.fused_adam(1e-3),
                                       Z.ZeroConfig(size=1,
                                                    inter_axis="slice",
                                                    inter_size=2))
    assert apply_fn.program is None
    with pytest.raises(ValueError, match="world"):
        Z.zero_axis(Z.ZeroConfig(size=2), "cpu")
    with pytest.raises(ValueError, match="size 4"):
        Z.zero_axis(Z.ZeroConfig(size=2, inter_axis="slice", inter_size=2),
                    "cpu")
    assert Z.zero_axis(Z.ZeroConfig(size=1), "cpu") == (None, 0, 1, 1.0,
                                                         None)
    assert Z.zero_axis(Z.ZeroConfig(size=1, inter_axis="slice"), "cpu") \
        == (None, 0, 1, 1.0, None)


def _tiny(dtype):
    cfg = tl.LlamaConfig.tiny(dtype=dtype, param_dtype="float32",
                              remat="attn+gate")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))
                           .astype(np.int32))
    return cfg, {"tokens": tok, "targets": torch.roll(tok, -1, 1)}


@pytest.fixture
def knob():
    yield fusion.set_jit_fusion
    fusion.set_jit_fusion(None)


@pytest.mark.parametrize("kind", ["adam", "master"])
def test_size_one_is_bit_identical_to_replicated(kind, knob):
    cfg, batch = _tiny("bfloat16")

    def run(zero, fused):
        knob(fused)
        opt = precision.fused_adam(1e-3) if kind == "adam" else \
            precision.fused_master_adam(1e-3)
        ts = train_step.make_split_train_step(
            lambda p, d: tl.llama_loss(p, d, cfg, device="cpu"), opt,
            microbatches=2, zero=zero)
        params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
        if kind == "adam":
            params = {k: (v.to(torch.bfloat16) if not isinstance(v, dict)
                          else {a: b.to(torch.bfloat16)
                                for a, b in v.items()})
                      for k, v in params.items()}
        carry = ts.init(params)
        losses = []
        for _ in range(3):
            loss, carry = ts.step(carry, batch)
            losses.append(_bits(loss))
        return losses, carry

    want_losses, want = run(None, True)
    for fused in (False, True):
        losses, carry = run(Z.ZeroConfig(size=1, bucket_bytes=4096), fused)
        assert [l.tolist() for l in losses] == \
            [l.tolist() for l in want_losses]
        for a, b in zip(tree_leaves(carry[0]), tree_leaves(want[0])):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert int(carry[1].count[0]) == 3
        layout = Z.zero_bucket_layout(
            Z.layout_leaves(Z._optimizer_hyper(
                precision.fused_adam(1e-3) if kind == "adam" else
                precision.fused_master_adam(1e-3)), carry[0]), 1, 4096)
        fields = ("mu", "nu") + (("master",) if kind == "master" else ())
        for f in fields:
            packed = layout.pack(tree_leaves(getattr(want[1], f)))
            if kind == "master":
                packed = [layout.pack_bucket(tree_leaves(
                    getattr(want[1], f)), i, torch.float32)
                    for i in range(len(layout.buckets))]
            for a, b in zip(getattr(carry[1], f), packed):
                np.testing.assert_array_equal(_bits(a), _bits(b))


def test_fusion_knob(monkeypatch, knob):
    monkeypatch.delenv("HOROVOD_JIT_FUSION", raising=False)
    assert fusion.jit_fusion_enabled()
    for value, on in (("0", False), ("off", False), ("1", True),
                      ("yes", True)):
        monkeypatch.setenv("HOROVOD_JIT_FUSION", value)
        assert fusion.jit_fusion_enabled() is on
    knob(True)
    assert fusion.jit_fusion_enabled() is True
    knob(False)
    assert fusion.jit_fusion_enabled() is False
    knob(None)     # follows the environment's "yes" again
    assert fusion.jit_fusion_enabled() is True


def test_bucketed_backward_hands_each_bucket_on_once():
    params = {"a": torch.randn(4, 3), "b": torch.randn(3), "c": torch.randn(5),
              "d": torch.randn(3, 2)}

    def loss_fn(p, d):   # "c" gets no gradient
        return ((d["x"] @ p["a"] + p["b"]) @ p["d"]).square().mean()

    batch = {"x": torch.randn(6, 4)}
    layout = Z.zero_bucket_layout(tree_leaves(params), 2, 24)
    seen = []

    def on_ready(i, leaves):
        b = layout.buckets[i]
        seen.append((i, [leaves[j].clone() for j in b.indices]))

    loss, got = fusion.value_and_grad_bucketed(loss_fn, params, batch, 1,
                                               layout, on_ready)
    want_loss, want = train_step._value_and_grad(loss_fn, params, batch, 1)
    assert torch.equal(loss, want_loss)
    assert sorted(i for i, _ in seen) == list(range(len(layout.buckets)))
    # The bucket holding "c" (leaf 2) completes only after the backward.
    c_bucket = next(i for i, b in enumerate(layout.buckets)
                    if 2 in b.indices)
    assert seen[-1][0] == c_bucket
    for i, leaves in seen:
        for j, g in zip(layout.buckets[i].indices, leaves):
            assert torch.equal(g, tree_leaves(want)[j])
    # With an accumulator: each gradient added into it first.
    acc = [torch.ones_like(g) for g in tree_leaves(want)]
    _, got = fusion.value_and_grad_bucketed(loss_fn, params, batch, 2,
                                            layout, lambda i, l: None,
                                            acc=acc)
    for a, g, w in zip(acc, got, tree_leaves(want)):
        assert a is g
        assert torch.equal(a, 1 + w / 2)


def test_mesh_defers_the_data_sum():
    groups = {"data": "D", "seq": "S"}
    mesh = Mesh({a: 1 for a in ("pipe", "fsdp", "expert", "tensor")} |
                {"data": 2, "seq": 2}, 0, torch.device("cpu"), groups, "ALL")
    assert mesh.grad_group() == "ALL"
    with mesh.defer_grad_sum("data"):
        assert mesh.grad_group() == "S"
        with mesh.defer_grad_sum("seq"):
            assert mesh.grad_group() is None
        assert mesh.grad_group() == "S"
    assert mesh.grad_group() == "ALL"
    flat = Mesh({a: 1 for a in ("pipe", "fsdp", "expert", "tensor", "seq")} |
                {"data": 4}, 0, torch.device("cpu"), {"data": "D"}, "ALL")
    with flat.defer_grad_sum("data"):
        assert flat.grad_group() is None


def test_split_step_no_longer_raises_on_zero():
    cfg, batch = _tiny("float32")
    ts = train_step.make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, cfg, device="cpu"),
        precision.fused_adam(1e-3), zero=Z.ZeroConfig(size=1))
    carry = ts.init(tl.llama_init(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))
    loss, carry = ts.step(carry, batch)
    assert np.isfinite(float(loss)) and type(carry[1]) is Z.ZeroAdamState



def test_hvd_init_sets_the_fusion_knob(monkeypatch, knob):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.torch import mpi_ops

    opened = []
    monkeypatch.setattr(mpi_ops._elastic, "init",
                        lambda device=None, epoch=None: opened.append(device))
    monkeypatch.setenv("HOROVOD_JIT_FUSION", "1")
    hvd.init(device="cpu", jit_fusion=False)
    assert opened == ["cpu"] and fusion.jit_fusion_enabled() is False
    hvd.init(device="cpu")          # None leaves the override as it was
    assert fusion.jit_fusion_enabled() is False
    hvd.init(device="cpu", jit_fusion=True)
    assert fusion.jit_fusion_enabled() is True
