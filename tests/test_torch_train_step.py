"""The port's split train step and optimizer-state carry-over against
the JAX package.

``make_split_train_step(llama_loss, fused_adam)`` against JAX's after 3
steps from one JAX-initialised tree (JAX flash kernels in Pallas
interpret mode); microbatch accumulation; the master variant's bf16
carry; the arguments the port does not take; and
``from_jax_opt_state``, including a run started in JAX and continued in
the port. Tolerances: losses 1e-5 relative; params after Adam steps
1e-4 absolute at learning rate 1e-3 (Adam moves each entry by about
lr * sign(g) per step, so an f32 summation-order difference in a
gradient entry near zero can move that entry by up to lr; 1e-4 is well
under one such step and far over the f32 noise of every other entry).
"""

import functools

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import (
    from_jax_opt_state,
    from_jax_params,
)
from horovod_tpu_torch.parallel import precision
from horovod_tpu_torch.parallel.zero import ZeroConfig
from horovod_tpu_torch.parallel.train_step import (
    _split_microbatches,
    make_split_train_step,
)
from tests.test_torch_mp import lazy_module, run_ranks

# The ranks import this module: JAX is bound lazily, for the oracles.
jax = lazy_module("jax")
jnp = lazy_module("jax.numpy")
jl = lazy_module("horovod_tpu.models.llama")
jpar = lazy_module("horovod_tpu.parallel")
fa_mod = lazy_module("horovod_tpu.ops.flash_attention")

LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _setup(param_dtype="float32", b=4, t=16):
    jc = jl.LlamaConfig.tiny(dtype=param_dtype, param_dtype=param_dtype,
                             remat=False)
    tc = tl.LlamaConfig.tiny(dtype=param_dtype, param_dtype=param_dtype,
                             remat="attn+gate")
    jparams = jl.llama_init(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab_size, (b, t)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    return jc, tc, jparams, batch


def _port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), device="cpu")


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(tc, opt, microbatches=1):
    return make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, tc, device="cpu"), opt,
        microbatches=microbatches)


def _assert_params_close(got, want, atol):
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=atol)


def test_split_step_fused_adam_matches_jax():
    jc, tc, jparams, batch = _setup()
    jts = jpar.make_split_train_step(lambda p, d: jl.llama_loss(p, d, jc),
                      jpar.fused_adam(LR))
    jcarry = jts.init(jparams)
    ts = _port_step(tc, precision.fused_adam(LR))
    carry = ts.init(_port(jparams))
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, \
        _port_batch(batch)
    for _ in range(3):
        jloss, jcarry = jts.step(jcarry, jb)
        loss, carry = ts.step(carry, tb)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert int(carry[1].count) == 3
    _assert_params_close(carry[0], jcarry[0], 1e-4)


def test_two_microbatches_match_one():
    _, tc, jparams, batch = _setup()
    tb = _port_batch(batch)
    one = _port_step(tc, precision.fused_adam(LR))
    two = _port_step(tc, precision.fused_adam(LR), microbatches=2)
    l1, c1 = one.step(one.init(_port(jparams)), tb)
    l2, c2 = two.step(two.init(_port(jparams)), tb)
    assert float(l2) == pytest.approx(float(l1), rel=1e-5)
    for a, b in zip(_leaves(c2[0]), _leaves(c1[0])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-4)


def test_indivisible_microbatches_raise():
    _, tc, jparams, batch = _setup()
    ts = _port_step(tc, precision.fused_adam(LR), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        ts.step(ts.init(_port(jparams)), _port_batch(batch))


def test_split_microbatches_views():
    x = torch.arange(12).reshape(6, 2)
    mbs = _split_microbatches({"tokens": x, "targets": x + 1}, 3)
    assert len(mbs) == 3 and mbs[1]["tokens"].tolist() == [[4, 5], [6, 7]]
    assert mbs[1]["targets"].tolist() == [[5, 6], [7, 8]]
    assert mbs[2]["tokens"].data_ptr() == x[4:].data_ptr()


def test_master_carry_is_bf16_and_loss_falls():
    _, tc, jparams, batch = _setup()
    tc = tl.LlamaConfig.tiny(dtype="bfloat16", remat="attn+gate")
    ts = _port_step(tc, precision.fused_master_adam(1e-2), microbatches=2)
    carry = ts.init(_port(jparams))
    assert all(p.dtype == torch.bfloat16 for p in _leaves(carry[0]))
    losses = []
    for _ in range(6):
        loss, carry = ts.step(carry, _port_batch(batch))
        losses.append(float(loss))
    assert all(p.dtype == torch.bfloat16 for p in _leaves(carry[0]))
    assert losses[-1] < losses[0], losses


def _cross_plane_worker(rank, size, jparams, batch, steps):
    """Rank ``rank`` of a 2-rank gloo world: ``steps`` split steps of
    ``fused_adam`` with ZeRO-1 split across two planes of one rank each
    (``size=1, inter_size=2``: each bucket's shard summed over the cross,
    the mean folded as 1/2), every rank on the whole batch. Returns the
    losses and the params as numpy."""
    from horovod_tpu_torch.parallel.mesh import create_mesh

    create_mesh(device="cpu", data=size)   # joins the world
    tc = tl.LlamaConfig.tiny(dtype="float32", param_dtype="float32",
                             remat="attn+gate")
    ts = make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, tc, device="cpu"),
        precision.fused_adam(LR),
        zero=ZeroConfig(size=1, inter_axis="slice", inter_size=size))
    carry = ts.init(from_jax_params(jparams, device="cpu"))
    losses = []
    for _ in range(steps):
        loss, carry = ts.step(carry, _port_batch(batch))
        losses.append(float(loss))
    return losses, [_np(p) for p in _leaves(carry[0])]


# ZeRO-1's cross-plane split (inter_axis, A9b) and telemetry= (a
# StepTimer, A12) raised here before; now both run.
@pytest.mark.parametrize("kw,item", [
    ({"zero": ZeroConfig(size=1, inter_axis="slice", inter_size=2)}, "A9"),
    ({"telemetry": "StepTimer"}, "A12")])
def test_unported_arguments_raise(kw, item):
    """``telemetry=`` runs: three steps under a ``StepTimer`` count the
    first step's FLOPs and give the losses and params of the same steps
    without it, bit for bit. ``zero=`` with the cross-plane split runs:
    on two real ranks (two planes of one), three steps equal JAX's ZeRO
    steps split over two emulated planes (the same config: the shard
    summed over both, the mean folded as 1/2) on the same gradients, on
    both ranks."""
    if item == "A12":
        from horovod_tpu_torch.telemetry import StepTimer

        jc, tc, jparams, batch = _setup()
        timer = StepTimer()
        runs = []
        for telemetry in (timer, None):
            ts = make_split_train_step(
                lambda p, d: tl.llama_loss(p, d, tc, device="cpu"),
                precision.fused_adam(LR), telemetry=telemetry)
            carry = ts.init(_port(jparams))
            losses = []
            for _ in range(3):
                loss, carry = ts.step(carry, _port_batch(batch))
                losses.append(float(loss))
            runs.append((losses, [_np(p) for p in _leaves(carry[0])]))
        assert timer.steps == 3 and timer.flops_per_step > 0
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1], strict=True):
            np.testing.assert_array_equal(a, b)
        return
    from horovod_tpu.parallel import ZeroConfig as JZeroConfig

    jc, _, jparams, batch = _setup()
    # Numpy first: JAX's step donates the params.
    nparams = jax.tree.map(np.asarray, jparams)
    zero = kw["zero"]
    jts = jpar.make_split_train_step(lambda p, d: jl.llama_loss(p, d, jc),
                      jpar.fused_adam(LR),
                      zero=JZeroConfig(size=zero.size,
                                       inter_axis=zero.inter_axis,
                                       inter_size=zero.inter_size))
    jcarry = jts.init(jparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = []
    for _ in range(3):
        jloss, jcarry = jts.step(jcarry, jb)
        jlosses.append(float(jloss))
    got = run_ranks(functools.partial(
        _cross_plane_worker, jparams=nparams, batch=batch, steps=3),
        zero.inter_size, timeout=180)
    for losses, params in got:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
        for g, w in zip(params, jax.tree.leaves(jcarry[0]), strict=True):
            np.testing.assert_allclose(g, _np(w), rtol=0, atol=1e-4)


def test_optimizer_without_apply_raises():
    class OptaxLike:
        def init(self, params):
            return ()

        def update(self, grads, state, params):
            return grads, state

    with pytest.raises(TypeError, match="apply"):
        make_split_train_step(lambda p, d: 0.0, OptaxLike())


@pytest.mark.parametrize("kind", ["adam-f32", "adam-bf16", "master"])
def test_from_jax_opt_state_round_trips(kind):
    dtype = "bfloat16" if kind == "adam-bf16" else "float32"
    jc = jl.LlamaConfig.tiny(param_dtype=dtype)
    jparams = jl.llama_init(jc, jax.random.PRNGKey(1))
    jopt = jpar.fused_master_adam(1e-2) if kind == "master" else \
        jpar.fused_adam(1e-2)
    jst = jopt.init(jparams)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jparams)
    params = jopt.compute_params(jst) if kind == "master" else jparams
    _, jst = jopt.apply(params, grads, jst)
    st = from_jax_opt_state(jax.tree.map(np.asarray, jst), device="cpu")
    want = precision.FusedMasterState if kind == "master" else \
        precision.FusedAdamState
    assert type(st) is want and int(st.count) == 1
    assert st.count.dtype == torch.int32
    for field in want._fields:
        if field == "count":
            continue
        for t, a in zip(_leaves(getattr(st, field)),
                        jax.tree.leaves(getattr(jst, field))):
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(np.uint16),
                    a.view(np.uint16))
            else:
                np.testing.assert_array_equal(t.numpy(), a)


def test_port_continues_a_jax_started_run():
    """Two steps in JAX, then the params and optimizer state move to the
    port and both take the third step: the port's third loss and params
    match JAX's."""
    jc, tc, jparams, batch = _setup()
    jts = jpar.make_split_train_step(lambda p, d: jl.llama_loss(p, d, jc),
                      jpar.fused_adam(LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcarry = jts.init(jparams)
    for _ in range(2):
        _, jcarry = jts.step(jcarry, jb)
    params = _port(jcarry[0])
    opt = from_jax_opt_state(jax.tree.map(np.asarray, jcarry[1]),
                             device="cpu")
    jloss, jcarry = jts.step(jcarry, jb)
    ts = _port_step(tc, precision.fused_adam(LR))
    loss, carry = ts.step((params, opt), _port_batch(batch))
    assert int(carry[1].count) == 3
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_params_close(carry[0], jcarry[0], 1e-4)


# ---- master_weights: a torch optimizer on an f32 master -------------------

def _mw_setup():
    """``tests/single/test_llama.py:428``'s model and batch: 2 layers,
    d64, vocab 128, B4 x T32, JAX's init moved to the port."""
    import dataclasses

    kw = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
              vocab_size=128, remat=False)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(dtype="float32", **kw),
                             dtype="bfloat16")
    tc = tl.LlamaConfig.tiny(dtype="bfloat16", **kw)
    jparams = jl.llama_init(jc, jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32),
                                           0, jc.vocab_size))
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    return jc, tc, jparams, batch


def _mw_port_grads(tc, params, batch):
    live = {k: v.detach().requires_grad_(True) for k, v in
            _flat_items(params)}
    tree = _unflat(live)
    loss = tl.llama_loss(tree, _port_batch(batch), tc, device="cpu")
    names = list(live)
    grads = torch.autograd.grad(loss, [live[n] for n in names])
    return float(loss.detach()), _unflat(dict(zip(names, grads)))


def _flat_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return out


def test_master_weights_tracks_jax_master_weights():
    """``master_weights(lambda ps: torch.optim.Adam(ps, lr=1e-2))``
    against JAX's ``master_weights(optax.adam(1e-2))`` over 8 steps of
    bf16 compute on the same model and batch: the master and Adam's
    moments are f32, the first loss within 1e-3 relative of JAX's (the
    bf16 forwards round differently), every later one within 5e-2 (the
    bound JAX's test puts between its bf16 and f32 runs: Adam's
    normalised steps carry the first step's rounding onward), and the
    loss falls as JAX's does."""
    import optax

    from horovod_tpu.parallel import master_weights as j_master_weights

    # JAX's attention through its CPU path, as test_llama.py:428 runs it.
    fa_mod._INTERPRET = False
    jc, tc, jparams, batch = _mw_setup()
    jmw = j_master_weights(optax.adam(1e-2))
    jstate = jmw.init(jparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(state, b):
        loss, grads = jax.value_and_grad(jl.llama_loss)(
            jmw.compute_params(state), b, jc)
        return loss, jmw.apply(state, grads)

    mw = precision.master_weights(lambda ps: torch.optim.Adam(ps, lr=1e-2))
    state = mw.init(_port(jparams))
    assert all(m.dtype == torch.float32 for m in _leaves(state.master))
    jlosses, losses = [], []
    for _ in range(8):
        jloss, jstate = jstep(jstate, jb)
        jlosses.append(float(jloss))
        params = mw.compute_params(state)
        assert all(p.dtype == torch.bfloat16 for p in _leaves(params))
        loss, grads = _mw_port_grads(tc, params, batch)
        losses.append(loss)
        state = mw.apply(state, grads)
    moments = [v for s in state.inner.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert len(moments) == 2 * len(_leaves(state.master))
    assert all(m.dtype == torch.float32 for m in moments)
    assert all(m.dtype == torch.float32 for m in _leaves(state.master))
    assert losses[0] == pytest.approx(jlosses[0], rel=1e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-2)
    assert losses[-1] < losses[0] and jlosses[-1] < jlosses[0]


def test_master_weights_matches_fused_master_adam():
    """The counterpart of ``test_llama.py:599``: three applies of
    ``master_weights(torch.optim.Adam)`` against the port's
    ``fused_master_adam`` on the same f32 gradients: the same f32
    moments (rtol 1e-6, atol 1e-7, JAX's test's bound), the same master
    to rtol 1e-6 and atol 3e-7, the fused cast the master rounded to
    bf16 bit for bit, and the two casts within a bf16 step. The master's
    atol is three steps of lr 1e-2 times 1e-5: on the CPU
    ``torch.optim.Adam`` takes its bias corrections in float64 where
    optax and the fused Adam take them in f32 (``1 - 0.999`` is 1.7e-5
    off in f32, half that under the square root)."""
    _, tc, jparams, batch = _setup()
    params = _port(jparams)
    _, grads = _mw_port_grads(tc, params, batch)
    mw = precision.master_weights(lambda ps: torch.optim.Adam(ps, lr=1e-2))
    mw_state = mw.init(params)
    fm = precision.fused_master_adam(1e-2)
    fm_state = fm.init(params)
    compute = fm.compute_params(fm_state)
    assert all(x.dtype == torch.bfloat16 for x in _leaves(compute))
    assert all(x.dtype == torch.float32
               for t in (fm_state.master, fm_state.mu, fm_state.nu)
               for x in _leaves(t))
    for _ in range(3):
        mw_state = mw.apply(mw_state, grads)
        compute, fm_state = fm.apply(compute, grads, fm_state)
    for a, b in zip(_leaves(mw_state.master), _leaves(fm_state.master),
                    strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=3e-7)
    inner = [mw_state.inner.state[m] for m in _leaves(mw_state.master)]
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for st, b in zip(inner, _leaves(getattr(fm_state, field)),
                         strict=True):
            assert st[key].dtype == torch.float32
            np.testing.assert_allclose(st[key].numpy(), b.numpy(),
                                       rtol=1e-6, atol=1e-7)
    for m, c in zip(_leaves(fm_state.master), _leaves(compute)):
        assert torch.equal(m.bfloat16(), c)
    for a, b in zip(_leaves(mw.compute_params(mw_state)), _leaves(compute)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-2, atol=1e-3)
    assert int(fm_state.count) == 3


def test_split_step_refuses_master_weights():
    """``master_weights`` is a standalone optimizer, as JAX's: the split
    step takes the fused ones."""
    mw = precision.master_weights(lambda ps: torch.optim.Adam(ps))
    with pytest.raises(TypeError, match="fused_master_adam"):
        make_split_train_step(lambda p, d: 0.0, mw)
