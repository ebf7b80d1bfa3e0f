"""The port's sequence parallelism against the JAX package.

Ring and Ulysses attention (``horovod_tpu_torch.parallel``) run in
spawned gloo worlds of 2 and 4 ranks (``seq`` = 2 and 4), each rank
holding its shard of the same seeded numpy q/k/v; their shards of the
output and of the gradients of sum(out^2) are joined here and held
against JAX's ``ring_self_attention`` / ``ulysses_self_attention`` on
its 8-device CPU mesh (the blockwise path), and against its flash path
(the Pallas chunk kernels in interpret mode under ``shard_map``) for the
port's flash path (the chunk op's plain version on CPU tensors).
Causal and not, GQA (H4 Hkv2), Ulysses' lcm replication of K/V heads
(Hkv2 over seq 4), and its error on heads that do not divide.
Tolerances are the JAX tests' own: values 2e-4, gradients rtol 5e-3 and
atol 5e-4.

Then the dense Llama (``LlamaConfig.tiny``, f32, 2 layers, B2 x T32)
under meshes of 4 ranks, data 2 x seq 2 and data 1 x seq 4, ring and
Ulysses: logits against JAX's ``llama_forward(p, t, cfg, mesh)`` and
against the port without a mesh, ``llama_loss`` and every gradient leaf
against ``jax.grad(llama_loss)(..., mesh)`` (2e-4 of each leaf's
largest entry), the remat modes none/full/attn/attn+gate agreeing, and
three ``make_split_train_step(llama_loss, fused_adam(3e-4))`` steps
giving the same params on every rank, equal to the port's
single-process steps on the whole batch. Last, the mesh layout against
JAX's ``create_mesh``, the other axes' meshes on the same world
(``pipe`` among them; a pipeline with ``seq > 1`` raises JAX's error),
and an MoE config under the mesh (the GShard dispatch) against the whole
batch on one process.
"""

import ast
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tests.utils_mp import run_ranks

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")

B, T, D = 2, 32, 8
VALUE_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)


def _qkv(seed, h, hkv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, h, D), (B, T, hkv, D), (B, T, hkv, D))]


# (name, kind, causal, H, Hkv, use_flash)
ATTN_CASES = [(f"{kind}-{'causal' if causal else 'bidir'}-h{h}kv{hkv}"
               f"{'-flash' if flash else ''}", kind, causal, h, hkv, flash)
              for kind in ("ring", "ulysses") for causal in (True, False)
              for h, hkv in ((4, 2), (4, 4)) for flash in (False, True)
              if not (hkv == 4 and (flash or not causal))]


def _attn_battery(rank, size):
    """Every case of ATTN_CASES on this rank's shards: its output and
    the gradients of sum(out^2) w.r.t. its q, k, v shards; and the
    Ulysses error on heads that do not divide the axis."""
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = mesh_mod.create_mesh(seq=size, device="cpu")
    out = {}
    for name, kind, causal, h, hkv, flash in ATTN_CASES:
        args = [mesh.shard(torch.from_numpy(a)).clone().requires_grad_(True)
                for a in _qkv(1, h, hkv)]
        fn = ring_attention if kind == "ring" else ulysses_attention
        o = fn(*args, mesh, causal=causal, use_flash=flash)
        grads = torch.autograd.grad((o ** 2).sum(), args)
        out[name] = [t.detach().numpy() for t in (o, *grads)]
    q = mesh.shard(torch.zeros(B, T, 3, D))
    try:
        ulysses_attention(q, q, q, mesh)
        out["indivisible"] = "no error"
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _jax_attention(kind, causal, flash, n, q, k, v):
    """JAX's value and gradients of sum(out^2) on a seq-only mesh of n
    CPU devices: ``*_self_attention`` (blockwise on CPU), or with
    ``flash`` the ring/ulysses flash path under shard_map with the Pallas
    kernels in interpret mode."""
    from horovod_tpu import parallel
    from horovod_tpu.parallel.ring_attention import ring_attention
    from horovod_tpu.parallel.ulysses import ulysses_attention

    mesh = parallel.create_mesh(data=1, seq=n, devices=jax.devices()[:n])
    if flash:
        spec = P(None, "seq", None, None)
        inner = ring_attention if kind == "ring" else ulysses_attention
        fn = jax.shard_map(functools.partial(inner, axis_name="seq",
                                             causal=causal, use_flash=True),
                           mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                           check_vma=False)
    else:
        sp = (parallel.ring_self_attention if kind == "ring"
              else parallel.ulysses_self_attention)
        fn = functools.partial(sp, mesh=mesh, causal=causal)
    def loss(*a):
        out = fn(*a)
        return (out ** 2).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2),
                                                 has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(t) for t in (out, *grads)]


@pytest.fixture
def interpret():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


@pytest.mark.parametrize("size", [2, 4])
def test_ring_and_ulysses_match_jax(size, interpret):
    """Every attention case at seq = ``size``: the joined shards of the
    output and gradients against JAX's."""
    per_rank = run_ranks(_attn_battery, size, timeout=240)
    for name, kind, causal, h, hkv, flash in ATTN_CASES:
        got = [np.concatenate([r[name][i] for r in per_rank], axis=1)
               for i in range(4)]
        want = _jax_attention(kind, causal, flash, size, *_qkv(1, h, hkv))
        np.testing.assert_allclose(got[0], want[0], **VALUE_TOL,
                                   err_msg=name)
        for g, w, what in zip(got[1:], want[1:], "qkv"):
            np.testing.assert_allclose(g, w, **GRAD_TOL,
                                       err_msg=f"{name} d{what}")
    for r in per_rank:
        assert "divisible" in r["indivisible"] \
            and "ring_attention" in r["indivisible"]


# ---- a seq axis of size 1 under a data axis of 2 -----------------------


def _seq1_battery(rank, size):
    """Each rank's batch shard through both self-attention entries on a
    data=2 x seq=1 mesh: a size-1 axis is the identity, so no rank sees
    another's heads. Output and the gradients of sum(out^2)."""
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
    )
    from horovod_tpu_torch.parallel.ulysses import ulysses_self_attention

    mesh = mesh_mod.create_mesh(data=2, seq=1, device="cpu")
    out = {}
    for name, fn in (("ulysses", ulysses_self_attention),
                     ("ring", ring_self_attention)):
        args = [mesh.shard(torch.from_numpy(a)).clone().requires_grad_(True)
                for a in _qkv(3, 4, 2)]
        o = fn(*args, mesh, causal=True)
        grads = torch.autograd.grad((o ** 2).sum(), args)
        out[name] = [t.detach().numpy() for t in (o, *grads)]
    return out


def test_seq_axis_of_one_is_the_identity():
    """data=2 x seq=1, each rank its own q/k/v (causal, H4 Hkv2): Ulysses
    and the ring, joined over the batch, equal JAX's
    ``ulysses_self_attention`` on ``create_mesh(data=2, seq=1)``."""
    from horovod_tpu import parallel

    per_rank = run_ranks(_seq1_battery, 2, timeout=240)
    jmesh = parallel.create_mesh(data=2, seq=1, devices=jax.devices()[:2])

    def loss(*a):
        o = parallel.ulysses_self_attention(*a, mesh=jmesh, causal=True)
        return (o ** 2).sum(), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, (0, 1, 2),
                                               has_aux=True))(
        *(jnp.asarray(a) for a in _qkv(3, 4, 2)))
    want = [np.asarray(t) for t in (o, *grads)]
    for name in ("ulysses", "ring"):
        got = [np.concatenate([r[name][i] for r in per_rank], axis=0)
               for i in range(4)]
        np.testing.assert_allclose(got[0], want[0], **VALUE_TOL,
                                   err_msg=name)
        for g, w, what in zip(got[1:], want[1:], "qkv"):
            np.testing.assert_allclose(g, w, **GRAD_TOL,
                                       err_msg=f"{name} d{what}")


# ---- the dense Llama under a data x seq mesh ----------------------------

LT = 32          # global sequence length of the Llama batch
MODES = ("none", "full", "attn", "attn+gate")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _llama_setup(seed=0):
    from horovod_tpu.models import llama as jl

    jc = jl.LlamaConfig.tiny(dtype="float32", remat=False)
    jparams = jax.tree.map(np.asarray,
                           jl.llama_init(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, jc.vocab_size, (B, LT)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1),
             "mask": (rng.random((B, LT)) > 0.3).astype(np.float32)}
    return jparams, batch


def _tl_config(**kw):
    from horovod_tpu_torch.models import llama as tl

    return tl.LlamaConfig.tiny(dtype="float32", **kw)


def _port_value_and_grad(params, batch, cfg, **kw):
    from horovod_tpu_torch.models import llama as tl

    from horovod_tpu_torch.parallel._tree import tree_map

    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss = tl.llama_loss(live, batch, cfg, device="cpu", **kw)
    flat = _flat(live)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(flat, grads)}


def _train(params, batch, loss_fn, steps=3):
    from horovod_tpu_torch.parallel import precision, train_step

    ts = train_step.make_split_train_step(loss_fn,
                                          precision.fused_adam(3e-4))
    carry = ts.init(params)
    losses = []
    for _ in range(steps):
        loss, carry = ts.step(carry, batch)
        losses.append(float(loss))
    return losses, {k: v.detach().numpy() for k, v in
                    _flat(carry[0]).items()}


def _flash_ring_modes(params, local, mesh):
    """The ring's flash path inside the Llama (on CPU tensors the ring
    takes the blockwise path unless told otherwise): loss, gradients and
    the chunk op's forward calls per grad call in every remat mode."""
    from horovod_tpu_torch.ops import flash_attention as fa

    # The package re-exports the function under the module's name.
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

    plain, ring = fa._flash_fwd_reference, ra.ring_attention
    calls = []

    def counted(*args):
        calls.append(args[5] is not None)  # the offsets: a ring step
        return plain(*args)

    fa._flash_fwd_reference = counted
    ra.ring_attention = functools.partial(ring, use_flash=True)
    try:
        out = {}
        for mode in MODES:
            calls.clear()
            out[f"flash/{mode}"] = _port_value_and_grad(
                params, local, _tl_config(remat=mode), mesh=mesh) + (
                calls.count(True),)
        return out
    finally:
        fa._flash_fwd_reference, ra.ring_attention = plain, ring


def _llama_battery(rank, size, data, seq, jparams, batch):
    """This rank's logits, loss and gradients under a data x seq mesh
    for ring and Ulysses and every remat mode, 3 split train steps
    (ring), its mesh coordinates, the meshes of the other axes (or their
    errors), and an MoE config's loss under the mesh."""
    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.parallel import mesh as mesh_mod
    from horovod_tpu_torch.parallel.sharding import shard_params

    mesh = mesh_mod.create_mesh(data=data, seq=seq, device="cpu")
    params = from_jax_params(jparams, device="cpu")
    local = mesh.shard_batch(batch)
    out = {"coords": dict(mesh.coords)}
    for sp in ("ring", "ulysses"):
        cfg = _tl_config(remat="none", seq_parallel=sp)
        with torch.no_grad():
            out[f"{sp}/logits"] = tl.llama_forward(
                params, local["tokens"], cfg, mesh=mesh).numpy()
        for mode in MODES:
            out[f"{sp}/{mode}"] = _port_value_and_grad(
                params, local, _tl_config(remat=mode, seq_parallel=sp),
                mesh=mesh)
    out.update(_flash_ring_modes(params, local, mesh))
    cfg = _tl_config(remat="attn+gate")
    out["train"] = _train(params, local, lambda p, b: tl.llama_loss(
        p, b, cfg, mesh=mesh))
    errors = {}
    for axes in (dict(data=2, tensor=2), dict(fsdp=4), dict(expert=2),
                 dict(pipe=2)):
        try:
            errors[str(axes)] = {a: mesh_mod.create_mesh(
                device="cpu", **axes).shape[a] for a in axes}
        except NotImplementedError as e:
            errors[str(axes)] = str(e)
    # A pipeline with seq > 1 raises JAX's error.
    pmesh = mesh_mod.create_mesh(device="cpu", pipe=2, seq=2)
    blocks, _ = shard_params(params, pmesh,
                             tl.llama_partition_rules(pipeline=True))
    try:
        tl.llama_loss(blocks, pmesh.shard_batch(batch),
                      _tl_config(remat="none"), mesh=pmesh)
        errors["pipe+seq"] = "no error"
    except ValueError as e:
        errors["pipe+seq"] = str(e)
    out["errors"] = errors
    moe_cfg = _tl_config(n_experts=4, remat="none")
    out["moe"] = float(tl.llama_loss(_moe_params(moe_cfg), local, moe_cfg,
                                     mesh=mesh))
    return out


def _moe_params(cfg):
    from horovod_tpu_torch.models import llama as tl

    return tl.llama_init(cfg, torch.Generator().manual_seed(5),
                         device="cpu")


def _jax_llama(jparams, batch, data, seq, sp):
    """JAX's logits, loss and gradients under its mesh of data x seq CPU
    devices."""
    from horovod_tpu import parallel
    from horovod_tpu.models import llama as jl

    mesh = parallel.create_mesh(data=data, seq=seq,
                                devices=jax.devices()[:data * seq])
    jc = jl.LlamaConfig.tiny(dtype="float32", remat=False, seq_parallel=sp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = jax.jit(lambda p, t: jl.llama_forward(p, t, jc, mesh))(
        jparams, jb["tokens"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jl.llama_loss(p, b, jc, mesh)))(jparams, jb)
    return (np.asarray(logits), float(loss),
            {k: np.asarray(v) for k, v in _flat(grads).items()}, mesh)


def _join(per_rank, key, data, seq):
    """The global [B, T, ...] array from each rank's (data, seq) block."""
    block = {(r["coords"]["data"], r["coords"]["seq"]): r[key]
             for r in per_rank}
    return np.concatenate([np.concatenate([block[d, s] for s in range(seq)],
                                          axis=1) for d in range(data)])


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("data,seq", [(2, 2), (1, 4)])
def test_llama_under_a_mesh_matches_jax(data, seq):
    jparams, batch = _llama_setup()
    per_rank = run_ranks(functools.partial(
        _llama_battery, data=data, seq=seq, jparams=jparams, batch=batch),
        data * seq, timeout=300)

    from horovod_tpu_torch.models import llama as tl
    from horovod_tpu_torch.models.convert import from_jax_params

    params = from_jax_params(jparams, device="cpu")
    with torch.no_grad():
        plain = tl.llama_forward(params, torch.from_numpy(batch["tokens"]),
                                 _tl_config(remat="none"),
                                 device="cpu").numpy()
    for sp in ("ring", "ulysses"):
        logits, loss, grads, jmesh = _jax_llama(jparams, batch, data, seq,
                                                sp)
        got = _join(per_rank, f"{sp}/logits", data, seq)
        np.testing.assert_allclose(got, logits, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
        for r in per_rank:
            r_loss, r_grads = r[f"{sp}/none"]
            assert abs(r_loss - loss) <= 2e-4 * abs(loss), (sp, r_loss, loss)
            assert sorted(r_grads) == sorted(grads)
            for k, w in grads.items():
                assert _rel(r_grads[k], w) <= 2e-4, (sp, k)
            for mode in MODES[1:]:
                m_loss, m_grads = r[f"{sp}/{mode}"]
                assert abs(m_loss - r_loss) <= 1e-6 * abs(r_loss), mode
                for k, w in r_grads.items():
                    assert _rel(m_grads[k], w) <= 1e-5, (sp, mode, k)
    # The ring's flash path (one chunk op a step) under every remat mode:
    # JAX's values, and the chunk op's forward once per layer and step
    # (twice under full remat: the save-sets keep flash_o/flash_lse).
    steps = 2 * seq  # 2 layers
    for r in per_rank:
        for mode in MODES:
            f_loss, f_grads, n_chunks = r[f"flash/{mode}"]
            assert n_chunks == (2 * steps if mode == "full" else steps), \
                (mode, n_chunks)
            assert abs(f_loss - loss) <= 2e-4 * abs(loss), mode
            for k, w in grads.items():
                assert _rel(f_grads[k], w) <= 2e-4, ("flash", mode, k)
    # Ranks hold JAX's shards: rank r sits where JAX's device r does.
    for rank, r in enumerate(per_rank):
        at = np.argwhere(np.vectorize(lambda dv: dv.id)(jmesh.devices)
                         == rank)[0]
        assert r["coords"] == dict(zip(jmesh.axis_names, map(int, at)))
        for axes, err in r["errors"].items():
            if axes == "pipe+seq":
                assert "sequence parallelism (seq>1) cannot combine" in \
                    err, err
            else:
                assert err == ast.literal_eval(axes), (axes, err)
    # An MoE config under the mesh takes the GShard dispatch ("auto"):
    # the loss of the whole batch on one process.
    moe_cfg = _tl_config(n_experts=4, remat="none", moe_impl="gshard")
    moe_loss = float(tl.llama_loss(
        _moe_params(moe_cfg), {k: torch.from_numpy(v)
                               for k, v in batch.items()}, moe_cfg,
        device="cpu"))
    for r in per_rank:
        assert r["moe"] == pytest.approx(moe_loss, rel=1e-5)
    # The split step: the same params on every rank, equal to the port's
    # single-process steps on the whole batch. Adam divides each gradient
    # element by its own scale, so an element whose gradient is near zero
    # moves by up to lr = 3e-4 a step on rounding alone: params are held
    # to a tenth of lr (the gradients themselves to 2e-4 above).
    cfg = _tl_config(remat="attn+gate")
    want_losses, want = _train(
        from_jax_params(jparams, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        lambda p, b: tl.llama_loss(p, b, cfg, device="cpu"))
    for r in per_rank:
        losses, got = r["train"]
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for k, w in want.items():
            assert np.array_equal(got[k], per_rank[0]["train"][1][k]), k
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=3e-5,
                                       err_msg=k)
