"""The port's Adam update (``ops/adam.py``) on the CPU.

On a CPU tensor ``adam_update`` is its plain version: the same bits as
the chain the optimizers ran before it (``_adam_leaf``, then a copy into
each stored tensor), for both variants, bf16 and f32, odd lengths and
views at odd offsets. ``fused_adam``, ``fused_master_adam`` and ZeRO's
``shard_adam`` reach it once per leaf or chunk. The kernel itself is
held to these bits on the card (``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import adam
from horovod_tpu_torch.parallel import precision, zero

HYPER = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8)


def _inputs(n, p_dtype, g_dtype, seed, offset=0):
    rng = np.random.default_rng(seed)

    def view(dtype, scale, positive=False):
        a = rng.standard_normal(n + offset).astype(np.float32) * scale
        return torch.from_numpy(np.abs(a) if positive else a).to(
            dtype)[offset:]

    return (view(p_dtype, 1.0), view(g_dtype, 1e-2), view(p_dtype, 1e-3),
            view(p_dtype, 1e-5, positive=True))


def _old_chain(p, g, mu, nu, bc1, bc2, out, cast):
    """What the optimizers stored before ``adam_update``."""
    p2, mu2, nu2 = adam._adam_leaf(p, g, mu, nu, HYPER["lr"], HYPER["b1"],
                                   HYPER["b2"], HYPER["eps"], bc1, bc2,
                                   out.dtype)
    out.copy_(p2)
    mu.copy_(mu2)
    nu.copy_(nu2)
    if cast is not None:
        cast.copy_(p2.to(cast.dtype))


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("n", [1, 7, 4099])
@pytest.mark.parametrize("variant,p_dtype,g_dtype", [
    ("adam", torch.bfloat16, torch.bfloat16),
    ("adam", torch.float32, torch.float32),
    ("master", torch.float32, torch.bfloat16),
    ("master", torch.float32, torch.float32)])
def test_cpu_update_is_the_old_chain_bit_for_bit(variant, p_dtype, g_dtype,
                                                 n, offset):
    p, g, mu, nu = _inputs(n, p_dtype, g_dtype, n, offset)
    new = [t.clone() for t in (p, mu, nu)]
    old = [t.clone() for t in (p, mu, nu)]
    casts = [torch.empty(n, dtype=g_dtype), torch.empty(n, dtype=g_dtype)] \
        if variant == "master" else [None, None]
    count = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        count = count + 1
        bc1, bc2 = precision._bias_corrections(count, HYPER["b1"],
                                               HYPER["b2"])
        got = adam.adam_update(new[0], g, new[1], new[2], *HYPER.values(),
                               bc1, bc2, cast=casts[0])
        assert got is new[0]
        _old_chain(old[0], g, old[1], old[2], bc1, bc2, old[0], casts[1])
        for a, b in zip(new, old):
            assert _same(a, b)
        if casts[0] is not None:
            assert _same(casts[0], casts[1])


def test_cpu_update_into_a_separate_out_leaves_p():
    p, g, mu, nu = _inputs(33, torch.bfloat16, torch.bfloat16, 1)
    p0, mu0, nu0 = p.clone(), mu.clone(), nu.clone()
    bc1, bc2 = precision._bias_corrections(
        torch.ones((), dtype=torch.int32), 0.9, 0.999)
    out = torch.empty_like(p)
    adam.adam_update(p, g, mu, nu, *HYPER.values(), bc1, bc2, out=out)
    want = torch.empty_like(p)
    _old_chain(p0.clone(), g, mu0, nu0, bc1, bc2, want, None)
    assert _same(p, p0) and _same(out, want)
    assert _same(mu, mu0) and _same(nu, nu0)


def test_no_path_but_the_cpu_and_the_card():
    p = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no path"):
        adam.adam_update(p, p, p, p, *HYPER.values(), p, p)


@pytest.mark.parametrize("dtypes,cast", [
    ((torch.bfloat16, torch.float32, torch.bfloat16), None),
    ((torch.float16, torch.float16, torch.float16), None),
    ((torch.bfloat16, torch.bfloat16, torch.bfloat16), torch.bfloat16),
    ((torch.float32, torch.bfloat16, torch.float32), torch.float32),
])
def test_kernel_variants_refuse_what_the_kernel_does_not_take(dtypes, cast):
    """The kernel's argument check (run before any launch) takes only the
    two variants: p, g, mu, nu of one dtype; or an f32 master with g and
    the cast in one compute dtype."""
    p_dt, g_dt, m_dt = dtypes
    p, g = torch.zeros(8, dtype=p_dt), torch.zeros(8, dtype=g_dt)
    mu, nu = torch.zeros(8, dtype=m_dt), torch.zeros(8, dtype=m_dt)
    c = None if cast is None else torch.zeros(8, dtype=cast)
    with pytest.raises(ValueError):
        adam._variant(p, g, mu, nu, p, c)


def test_kernel_variants_take_the_optimizers_inputs():
    bf, f32 = torch.bfloat16, torch.float32
    z = torch.zeros
    assert adam._variant(z(8, dtype=bf), z(8, dtype=bf), z(8, dtype=bf),
                         z(8, dtype=bf), z(8, dtype=bf), None) == "adam"
    assert adam._variant(z(8), z(8), z(8), z(8), z(8), None) == "adam"
    m = z(8, dtype=f32)
    assert adam._variant(m, z(8, dtype=bf), z(8), z(8), m,
                         z(8, dtype=bf)) == "master"
    with pytest.raises(ValueError):      # a length that differs
        adam._variant(m, z(7), z(8), z(8), m, None)


@pytest.fixture
def counted(monkeypatch):
    """Every plain update, counted: the optimizers must reach it."""
    calls = []
    plain = adam._adam_plain

    def spy(p, *args):
        calls.append((p.numel(), args[-1] is not None))
        return plain(p, *args)

    monkeypatch.setattr(adam, "_adam_plain", spy)
    return calls


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return {"a": mk(5, 3), "b": {"c": mk(7), "d": mk(2, 2, 2)}}


def test_fused_adam_updates_once_per_leaf(counted):
    params, grads = _tree(0, torch.bfloat16), _tree(1, torch.bfloat16)
    opt = precision.fused_adam(1e-3)
    state = opt.init(params)
    want = {k: v.clone() for k, v in zip("abc", (
        params["a"], params["b"]["c"], params["b"]["d"]))}
    opt.apply(params, grads, state)
    assert counted == [(15, False), (7, False), (8, False)]
    assert not torch.equal(params["a"], want["a"])


def test_fused_master_adam_updates_once_per_leaf_with_the_cast(counted):
    params, grads = _tree(0, torch.float32), _tree(1, torch.bfloat16)
    opt = precision.fused_master_adam(1e-3)
    state = opt.init(params)
    carry = opt.compute_params(state)
    opt.apply(carry, grads, state)
    assert counted == [(15, True), (7, True), (8, True)]
    assert torch.equal(carry["a"], state.master["a"].to(torch.bfloat16))


@pytest.mark.parametrize("master", [False, True])
def test_shard_adam_updates_once_per_chunk(counted, monkeypatch, master):
    monkeypatch.setattr(zero, "ADAM_CHUNK", 10)
    n = 25
    p, g, mu, nu = _inputs(n, torch.float32 if master else torch.bfloat16,
                           torch.bfloat16, 2)
    hyper = {"learning_rate": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    out = zero.shard_adam(hyper, p, g, mu, nu,
                          torch.ones((), dtype=torch.int32),
                          torch.bfloat16, master=master)
    assert counted == [(10, master), (10, master), (5, master)]
    assert out.dtype == torch.bfloat16 and out.shape == (n,)
